"""ulcdecodetool — CLI decoder, flag-compatible with the reference tool.

Usage (reference tools/ulcDecodeTool.c:31-65):
    ulcdecodetool Input.ulc Output.wav [-format:PCM8|PCM16|PCM24|FLOAT32]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ulcx.container import UlcHeader
from ulcx.io.wavio import WAVE_FORMAT_IEEE_FLOAT, WAVE_FORMAT_PCM, WavWriter
from ulcx.utils.config import CodecConfig

_FORMATS = {
    "PCM8": (8, WAVE_FORMAT_PCM),
    "PCM16": (16, WAVE_FORMAT_PCM),
    "PCM24": (24, WAVE_FORMAT_PCM),
    "FLOAT32": (32, WAVE_FORMAT_IEEE_FLOAT),
}



from ulcx.utils.compileopts import enable_compile_cache

def main(argv=None) -> int:
    enable_compile_cache()
    argv = sys.argv if argv is None else argv
    if len(argv) < 3:
        print(
            "ulcDecodeTool - Ultra-Low Complexity Codec Decoding Tool (ulcx)\n"
            "Usage: ulcdecodetool Input.ulc Output.wav [Opt]\n"
            "Options:\n"
            " -format:PCM16 - Set output format (PCM8, PCM16, PCM24, FLOAT32).\n"
        )
        return 1

    fmt = "PCM16"
    chunk = 64
    profile_dir = None
    for a in argv[3:]:
        if a.startswith("-format:"):
            cand = a[len("-format:") :].upper()
            if cand not in _FORMATS:
                print(f"ERROR: Ignoring invalid output format ({cand}).")
                return -1
            fmt = cand
        elif a.startswith("-chunk:"):
            chunk = max(1, int(a[len("-chunk:") :]))
        elif a.startswith("-profile:"):
            profile_dir = a[len("-profile:") :]
        else:
            print(f"WARNING: Ignoring unknown argument ({a}).")
    bits, tag = _FORMATS[fmt]

    import jax
    import jax.numpy as jnp
    from ulcx.codec.decoder import decode_stream

    try:
        with open(argv[1], "rb") as f:
            raw = f.read()
        hdr = UlcHeader.unpack(raw)
    except (OSError, ValueError) as e:
        print(f"ERROR: Input file is not a valid ULC container ({e}).")
        return -1

    cfg = CodecConfig(
        rate_hz=hdr.rate_hz, n_chan=hdr.n_chan, block_size=hdr.block_size
    )
    window = max(hdr.max_block_size, 16)
    window = -(-window // 64) * 64  # round up for tidy slices
    stream = np.frombuffer(raw[hdr.stream_offs :], np.uint8)
    stream = np.concatenate([stream, np.zeros(window + 64, np.uint8)])
    stream_j = jnp.asarray(stream)

    from ulcx.utils.compileopts import jit_options

    # the pipelined decoder keeps only the FSM serial and batches
    # expansion/RNG/IMDCT over the chunk's blocks; it needs the decode
    # kernels (kernel_mode). For PCM8/PCM16 output the float->int
    # conversion runs on the device, so 1-2 bytes/sample come back
    # instead of 4. jnp.rint(jnp.clip(...)) is bit-exact vs the host
    # converters (lrintf = round-half-even; same f32 scale and clamp
    # bounds — native/ulcio.cpp, io/wavio.py float_to_raw); equality is
    # asserted in tests/test_tools.py.
    from ulcx.utils.config import kernel_mode

    mode = kernel_mode(cfg)
    if bits == 8:
        def _conv(p):
            return jnp.rint(
                jnp.clip(p * jnp.float32(2.0**7), -128.0, 127.0)
            ).astype(jnp.int8)
    elif bits == 16:
        def _conv(p):
            return jnp.rint(
                jnp.clip(p * jnp.float32(2.0**15), -32768.0, 32767.0)
            ).astype(jnp.int16)
    else:  # PCM24/FLOAT32: no byte win from an int form; ship f32
        def _conv(p):
            return p

    if mode != "off":
        from ulcx.codec.decoder import decode_stream_pipelined

        def _dec(s, off, carry):
            pcm, bits_arr, corrupt, st = decode_stream_pipelined(
                s, chunk, window, cfg, offset=off, carry=carry,
                interpret=mode == "interpret",
            )
            return _conv(pcm), bits_arr, corrupt, st

        dec_fn = jax.jit(_dec, compiler_options=jit_options(default="lo"))
    else:
        def _dec(s, off, carry):
            pcm, bits_arr, corrupt, st = decode_stream(
                s, chunk, window, cfg, offset=off, carry=carry
            )
            return _conv(pcm), bits_arr, corrupt, st

        dec_fn = jax.jit(_dec, compiler_options=jit_options(default="lo"))

    from ulcx.codec.decoder import DecoderCarry

    wav = WavWriter(argv[2], hdr.rate_hz, hdr.n_chan, bits, tag)
    n, c = hdr.block_size, hdr.n_chan
    t0 = time.time()
    last_print = t0 - 0.5
    done = 0
    offset, carry = jnp.int32(0), DecoderCarry.init(cfg)
    failed = False
    from ulcx.utils.profiling import device_trace

    with device_trace(profile_dir):
        while done < hdr.n_blocks and not failed:
            pcm, bits_arr, corrupt, (offset, carry) = dec_fn(stream_j, offset, carry)
            take = min(chunk, hdr.n_blocks - done)
            corrupt_np = np.asarray(corrupt)[:take]
            if corrupt_np.any():
                print("ERROR: Corrupted stream.")
                failed = True
                take = int(np.argmax(corrupt_np))
            pcm_np = np.asarray(pcm)[:take]  # [take, C, N]
            frames = pcm_np.transpose(0, 2, 1).reshape(-1)
            if bits in (8, 16):
                wav.write_frames_int(frames)  # device-converted ints
            else:
                wav.write_frames(frames)
            done += take
            now = time.time()
            if now - last_print >= 0.5:
                rt = done * n / hdr.rate_hz / max(now - t0, 1e-9)
                print(
                    f"\rBlock {done}/{hdr.n_blocks} "
                    f"({done * 100.0 / hdr.n_blocks:.2f}% | {rt:.2f} X rt)",
                    end="",
                    flush=True,
                )
                last_print = now

    wav.close()
    if not failed:
        print("\nOk")
    return -1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
