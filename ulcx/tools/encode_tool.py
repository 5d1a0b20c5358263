"""ulcencodetool — CLI encoder, flag-compatible with the reference tool.

Usage (reference tools/ulcEncodeTool.c:24-65):
    ulcencodetool Input.wav Output.ulc RateKbps[,AvgComplexity]|-Quality [Opt]
Options:
    -blocksize:2048   coefficients per block (power of 2, 256..32768)
    -chunk:64         blocks per device dispatch (ulcx extension)

Negative rate selects VBR (quality = -rate); a second comma value
selects ABR with that average complexity. Prints the reference's
closing statistics (total KiB, avg/max kbps, bits/sample, avg
complexity) and patches avg kbps into the ULC2 header.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ulcx.container import HEADER_SIZE, UlcHeader
from ulcx.io.wavio import WavReader
from ulcx.utils.config import CodecConfig


def _parse_args(argv):
    if len(argv) < 4:
        print(
            "ulcencodetool - Ultra-Low Complexity Codec Encoding Tool (ulcx)\n"
            "Usage:\n"
            " ulcencodetool Input.wav Output.ulc RateKbps[,AvgComplexity]|-Quality [Opt]\n"
            "Options:\n"
            " -blocksize:2048 - Set number of coefficients per block (must be a power of 2).\n"
            "Passing AvgComplexity uses ABR mode.\n"
            "Passing negative RateKbps (-Quality) uses VBR mode.\n"
            "Input file must be 8-bit, 16-bit, 24-bit, 32-bit, or 32-bit float.\n"
        )
        return None
    rate_spec = argv[3].split(",")
    rate_kbps = float(rate_spec[0])
    avg_complexity = float(rate_spec[1]) if len(rate_spec) > 1 else 0.0
    if rate_kbps == 0.0:
        print(f"ERROR: Invalid coding rate ({rate_kbps:.2f}).")
        return None
    if avg_complexity < 0.0:
        print(f"ERROR: Invalid AvgComplexity parameter ({avg_complexity:.2f}).")
        return None
    block_size = 2048
    chunk = 64
    profile_dir = None
    for a in argv[4:]:
        if a.startswith("-blocksize:"):
            x = int(a[len("-blocksize:") :])
            if 256 <= x <= 32768 and (x & (x - 1)) == 0:
                block_size = x
            else:
                print(f"ERROR: Unsupported block size ({x}).")
                return None
        elif a.startswith("-chunk:"):
            chunk = max(1, int(a[len("-chunk:") :]))
        elif a.startswith("-profile:"):
            profile_dir = a[len("-profile:") :]
        else:
            print(f"WARNING: Ignoring unknown argument ({a}).")
    return argv[1], argv[2], rate_kbps, avg_complexity, block_size, chunk, profile_dir



from ulcx.utils.compileopts import enable_compile_cache

def main(argv=None) -> int:
    enable_compile_cache()
    argv = sys.argv if argv is None else argv
    parsed = _parse_args(argv)
    if parsed is None:
        return 1
    in_path, out_path, rate_kbps, avg_cx, block_size, chunk, profile_dir = parsed

    import jax
    import jax.numpy as jnp
    from ulcx.codec.encoder import encode_stream, max_block_bytes

    try:
        wav = WavReader(in_path)
    except (OSError, ValueError) as e:
        print(f"ERROR: Unable to open input file ({in_path}); {e}.")
        return -1
    info = wav.info
    if info.rate_hz < 1 or info.n_chan < 1:
        print("ERROR: Unsupported playback rate or channel count.")
        return -1

    cfg = CodecConfig(rate_hz=info.rate_hz, n_chan=info.n_chan, block_size=block_size)
    n_blocks = (info.n_samples + block_size - 1) // block_size + 2

    if rate_kbps < 0:
        mode, kw = "vbr", {"quality": -rate_kbps}
    elif avg_cx > 0:
        mode, kw = "abr", {"rate_kbps": rate_kbps, "avg_complexity": avg_cx}
    else:
        mode, kw = "cbr", {"rate_kbps": rate_kbps}

    from ulcx.utils.compileopts import jit_options

    # PCM8/16 sources upload raw
    # int8/int16 samples (1-2 bytes/sample instead of 4) and scale to
    # float ON DEVICE — int->f32 is exact, so encoded bytes are
    # bit-identical to the float upload path.
    int_scale = wav.int_scale()

    def _enc(blocks, carry):
        if int_scale is not None:
            blocks = blocks.astype(jnp.float32) * jnp.float32(int_scale)
        return encode_stream(blocks, cfg, mode, carry=carry, **kw)

    enc_fn = jax.jit(_enc, compiler_options=jit_options(default="lo"))

    header = UlcHeader(
        block_size=block_size,
        max_block_size=0,
        n_blocks=n_blocks,
        rate_hz=info.rate_hz,
        n_chan=info.n_chan,
        rate_kbps=0,
    )

    out = open(out_path, "wb")
    out.write(header.pack())

    from ulcx.analysis.block import EncoderCarry

    total_bytes = 0
    max_bytes = 0
    cx_sum = 0.0
    carry = EncoderCarry.init(cfg)
    t0 = time.time()
    last_print = t0 - 0.5
    done_blocks = 0
    c, n = info.n_chan, block_size

    # Double-buffered pipeline: a reader thread prefetches + converts
    # the next WAV chunk while the device encodes the current one, and
    # each chunk's outputs are flushed only after the next chunk has
    # been dispatched (jax dispatch is async, so the device stays busy
    # during host-side file writes).
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=2)

    def _reader():
        # exceptions are forwarded through the queue: if the reader died
        # silently the main loop would block forever on q.get()
        try:
            left = n_blocks
            while left > 0:
                take = min(chunk, left)
                if int_scale is not None:  # raw-int upload (exact)
                    frames = wav.read_frames_int(take * n)
                else:
                    frames = wav.read_frames(take * n)  # interleaved, 0-pad
                blocks = frames.reshape(take, n, c).transpose(0, 2, 1)
                if take < chunk:  # pad to compile-once chunk shape
                    pad = np.zeros((chunk - take, c, n), blocks.dtype)
                    blocks = np.concatenate([blocks, pad], 0)
                q.put((np.ascontiguousarray(blocks), take))
                left -= take
            q.put(None)
        except BaseException as e:  # noqa: BLE001
            q.put(e)

    rd = threading.Thread(target=_reader, daemon=True)
    rd.start()

    from ulcx.io import native as _native

    def _flush(encoded, take):
        nonlocal total_bytes, max_bytes, cx_sum, done_blocks, last_print
        sizes = np.asarray(encoded.size_bits)[:take]
        # Fetch only the used
        # prefix of the [chunk, max_block_bytes] byte planes — sizes
        # are known first, so slice on device before pulling. Rounding
        # the slice width to 512 bytes bounds the number of distinct
        # slice programs to max_block_bytes/512.
        used = (int(sizes.max()) // 8 + 511) // 512 * 512 if take else 512
        used = min(max(used, 512), encoded.data.shape[1])
        datas = np.asarray(encoded.data[:take, :used])
        cxs = np.asarray(encoded.complexity)[:take]
        packed = _native.pack_blocks(datas, sizes)  # C++ fast path
        if packed is not None:
            out.write(packed)
            total_bytes += len(packed)
        else:
            for i in range(take):
                nb = int(sizes[i]) // 8
                out.write(datas[i, :nb].tobytes())
                total_bytes += nb
        max_bytes = max(max_bytes, int(sizes.max()) // 8 if take else 0)
        cx_sum += float(cxs.sum())
        done_blocks += take
        now = time.time()
        if now - last_print >= 0.5:
            rt = done_blocks * n / info.rate_hz / max(now - t0, 1e-9)
            avg = (
                total_bytes * 8.0 * info.rate_hz / 1000.0 / (done_blocks * n)
                if done_blocks
                else 0.0
            )
            print(
                f"\rBlock {done_blocks}/{n_blocks} "
                f"({done_blocks * 100.0 / n_blocks:.2f}% | {rt:.2f} X rt) | "
                f"Average: {avg:.2f}kbps",
                end="",
                flush=True,
            )
            last_print = now

    from ulcx.utils.profiling import device_trace

    with device_trace(profile_dir):
        pending = None
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            blocks, take = item
            encoded, carry = enc_fn(jnp.asarray(blocks), carry)
            if pending is not None:
                _flush(*pending)
            pending = (encoded, take)
        if pending is not None:
            _flush(*pending)
    rd.join()

    n_samples_enc = n_blocks * n
    avg_kbps = total_bytes * 8.0 * info.rate_hz / 1000.0 / n_samples_enc
    print(
        "\n"
        f"Total size = {total_bytes / 1024.0:.2f}KiB\n"
        f"Avg rate = {avg_kbps:.5f}kbps ({total_bytes * 8.0 / n_samples_enc:.5f} bits/sample)\n"
        f"Max rate = {max_bytes * 8.0 * info.rate_hz / 1000.0 / n:.5f}kbps "
        f"({max_bytes * 8.0 / n:.5f} bits/sample)\n"
        f"Avg complexity = {cx_sum / n_blocks:.5f}"
    )

    header.max_block_size = max_bytes
    header.rate_kbps = int(round(avg_kbps)) & 0xFFFF
    out.seek(0)
    out.write(header.pack())
    out.close()
    wav.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
