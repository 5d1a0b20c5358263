// ulcx native I/O runtime: bulk PCM<->float conversion and nybble
// stream packing, C ABI for ctypes binding.
//
// Batched counterpart of the reference's host-side L3 layer
// (tools/WavIO_Helper.c:31-87 semantics: identical scalings, lrintf
// rounding, clamping) — the hot host loops of the batched data loader
// live here instead of NumPy when the shared library is present.
// Build: `make -C native` (produces libulcio.so).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// ---- PCM -> float -------------------------------------------------------

void ulcio_pcm8_to_f32(const uint8_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dst[i] = (float)((int8_t)(src[i] ^ 0x80)) * 0x1.0p-7f;
    }
}

void ulcio_pcm16_to_f32(const int16_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) dst[i] = (float)src[i] * 0x1.0p-15f;
}

void ulcio_pcm24_to_f32(const uint8_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int32_t x = (int32_t)((uint32_t)src[3 * i] << 8 |
                              (uint32_t)src[3 * i + 1] << 16 |
                              (uint32_t)src[3 * i + 2] << 24);
        dst[i] = (float)x * 0x1.0p-31f;
    }
}

void ulcio_pcm32_to_f32(const int32_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) dst[i] = (float)src[i] * 0x1.0p-31f;
}

// ---- float -> PCM -------------------------------------------------------

static inline float clampf(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

void ulcio_f32_to_pcm8(const float* src, uint8_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dst[i] = (uint8_t)((int8_t)lrintf(
                     clampf(src[i] * 0x1.0p+7f, -128.0f, 127.0f)) ^
                 0x80);
    }
}

void ulcio_f32_to_pcm16(const float* src, int16_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        dst[i] = (int16_t)lrintf(clampf(src[i] * 0x1.0p+15f, -32768.0f, 32767.0f));
    }
}

void ulcio_f32_to_pcm24(const float* src, uint8_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        uint32_t x = (uint32_t)(int32_t)lrintf(
            clampf(src[i] * 0x1.0p+23f, -8388608.0f, 8388607.0f));
        dst[3 * i] = (uint8_t)x;
        dst[3 * i + 1] = (uint8_t)(x >> 8);
        dst[3 * i + 2] = (uint8_t)(x >> 16);
    }
}

// ---- interleave helpers (deinterleave frames -> channel-major blocks) ---

void ulcio_deinterleave(const float* src, float* dst, int64_t frames, int nchan) {
    for (int64_t f = 0; f < frames; f++)
        for (int c = 0; c < nchan; c++)
            dst[(int64_t)c * frames + f] = src[f * nchan + c];
}

void ulcio_interleave(const float* src, float* dst, int64_t frames, int nchan) {
    for (int64_t f = 0; f < frames; f++)
        for (int c = 0; c < nchan; c++)
            dst[f * nchan + c] = src[(int64_t)c * frames + f];
}

// ---- block stream assembly ---------------------------------------------
// Gather variable-size encoded blocks (fixed-stride source rows) into a
// contiguous .ulc stream; returns total bytes written.

int64_t ulcio_pack_blocks(const uint8_t* data, const int32_t* sizes_bits,
                          int64_t n_blocks, int64_t stride, uint8_t* out) {
    int64_t off = 0;
    for (int64_t i = 0; i < n_blocks; i++) {
        int64_t nb = (sizes_bits[i] + 7) / 8;
        memcpy(out + off, data + i * stride, (size_t)nb);
        off += nb;
    }
    return off;
}

}  // extern "C"
