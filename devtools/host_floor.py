"""Isolate the single-file CLI's HOST-side floor.

This harness replays the encode tool's exact host pipeline (WAV read -> reshape/convert -> reader
thread -> queue -> [stubbed device call] -> np.asarray fetch ->
pack_blocks -> file write -> stats) with the jitted encode replaced by
a host-side identity producing same-shaped outputs, so every second
measured is host glue. Stages are then also timed standalone.

Usage: python devtools/host_floor.py [seconds] [workdir]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 180.0
    wd = sys.argv[2] if len(sys.argv) > 2 else os.path.join(tempfile.gettempdir(), "ulcx_host_floor")
    os.makedirs(wd, exist_ok=True)

    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "devtools"))
    from cli_latency import _make_wav

    wav_path = os.path.join(wd, f"in_{int(seconds)}s.wav")
    if not os.path.exists(wav_path):
        _make_wav(wav_path, seconds)

    from ulcx.io.wavio import WavReader
    from ulcx.io import native as _native

    n = 2048
    chunk = 64

    # --- stage timings, standalone ---
    t0 = time.perf_counter()
    wav = WavReader(wav_path)
    frames_all = wav.read_frames(wav.info.n_samples)
    wav.close()
    t_read = time.perf_counter() - t0
    c = 2

    t0 = time.perf_counter()
    total = frames_all.shape[0] // (n * c) * n * c
    fr = frames_all[:total]
    blocks = fr.reshape(-1, n, c).transpose(0, 2, 1).astype(np.float32)
    t_reshape = time.perf_counter() - t0

    nb = blocks.shape[0]
    rng = np.random.default_rng(0)
    sizes = (rng.integers(300, 744, nb) * 8).astype(np.int64)
    datas = rng.integers(0, 256, (nb, 2 * c * n), dtype=np.uint8)
    t0 = time.perf_counter()
    packed = _native.pack_blocks(datas, sizes)
    t_pack = time.perf_counter() - t0
    pk = "native" if packed is not None else "python"

    out_path = os.path.join(wd, "out.bin")
    t0 = time.perf_counter()
    with open(out_path, "wb") as f:
        if packed is None:
            for i in range(nb):
                f.write(datas[i, : int(sizes[i]) // 8].tobytes())
        else:
            f.write(packed)
    t_write = time.perf_counter() - t0

    print(
        f"standalone ({seconds:.0f}s wav, {nb} blocks): read+convert "
        f"{t_read:.2f}s reshape {t_reshape:.2f}s pack[{pk}] {t_pack:.2f}s "
        f"write {t_write:.2f}s",
        flush=True,
    )

    # --- full tool pipeline with the device stubbed ---
    import queue as _queue
    import threading

    wav = WavReader(wav_path)
    info = wav.info
    n_blocks = (info.n_samples + n - 1) // n + 2
    q: _queue.Queue = _queue.Queue(maxsize=2)

    def _reader():
        left = n_blocks
        while left > 0:
            take = min(chunk, left)
            fr = wav.read_frames(take * n)
            b = fr.reshape(take, n, c).transpose(0, 2, 1).astype(np.float32)
            if take < chunk:
                b = np.concatenate(
                    [b, np.zeros((chunk - take, c, n), np.float32)], 0
                )
            q.put((b, take))
            left -= take
        q.put(None)

    class FakeEnc:
        """Same-shaped outputs as EncodedBlock, host arrays."""

        def __init__(self):
            self.size_bits = sizes[:chunk].astype(np.int32)
            self.data = datas[:chunk]
            self.complexity = np.full(chunk, 0.3, np.float32)

    fake = FakeEnc()
    t0 = time.perf_counter()
    rd = threading.Thread(target=_reader, daemon=True)
    rd.start()
    total_bytes = 0
    out = open(out_path, "wb")
    while True:
        item = q.get()
        if item is None:
            break
        blocks_h, take = item
        # stub: the tool would call enc_fn(jnp.asarray(blocks), carry)
        encoded = fake
        szs = np.asarray(encoded.size_bits)[:take]
        dts = np.asarray(encoded.data)[:take]
        packed = _native.pack_blocks(dts, szs.astype(np.int64))
        if packed is not None:
            out.write(packed)
            total_bytes += len(packed)
        else:
            for i in range(take):
                k = int(szs[i]) // 8
                out.write(dts[i, :k].tobytes())
                total_bytes += k
    out.close()
    rd.join()
    wav.close()
    t_pipe = time.perf_counter() - t0
    print(
        f"stubbed tool pipeline: {t_pipe:.2f}s total "
        f"({total_bytes / 1024:.0f} KiB out)",
        flush=True,
    )


if __name__ == "__main__":
    main()
