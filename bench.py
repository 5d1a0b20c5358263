"""Benchmark: batched 44.1 kHz stereo CBR-128 encode + decode throughput on one GPU.

Prints one JSON line per metric (encode last — the headline number):
  {"metric": "...", "value": N, "unit": "x_realtime", "platform": "gpu",
   "device_kind": "...", "device_count": 1, "gpu": "<name>, <power limit>"}
Times are wall clock around work that ends in block_until_ready, best of
3 after a warm-up call (which compiles). It refuses to run without a GPU.

The corpus is heterogeneous and transient-heavy (BASELINE.md benchmark
config list): per-stream random tone stacks + AM + noise floor, with
clicks/onsets injected in ~40% of streams so window switching exercises
varied decimation patterns.

Env knobs: ULCX_BENCH_B (streams), ULCX_BENCH_T (blocks/stream),
ULCX_BENCH_MODE (cbr|abr|vbr), ULCX_BENCH_BS (block size),
ULCX_BENCH_DECODE (0 to skip the decode metric),
ULCX_BENCH_TBACKEND (transform_backend: auto|matmul|fact|fft),
ULCX_BENCH_MAXN (matmul_max_n — the auto matmul/fact crossover).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np


def make_corpus(b: int, t: int, n: int, rate_hz: float = 44100.0) -> np.ndarray:
    """[B, T, 2, N] heterogeneous stereo test signals."""
    rng = np.random.default_rng(7)
    total = t * n
    tt = np.arange(total, dtype=np.float64) / rate_hz

    # per-stream tone stack: 3 tones, random freqs/amps/phases, stereo
    # decorrelation via per-channel phase offsets
    f = rng.uniform(60.0, 9000.0, (b, 3, 1, 1))
    a = rng.uniform(0.02, 0.3, (b, 3, 1, 1)) * (0.5 ** np.arange(3)[None, :, None, None])
    ph = rng.uniform(0, 2 * np.pi, (b, 3, 2, 1))
    x = np.sum(a * np.sin(2 * np.pi * f * tt[None, None, None, :] + ph), axis=1)

    # slow AM envelope (per stream) + low noise floor
    fm = rng.uniform(0.3, 4.0, (b, 1, 1))
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * fm * tt[None, None, :])
    x += 0.01 * rng.standard_normal((b, 2, total))

    # transient clicks/onsets in ~40% of streams: exponentially decaying
    # bursts at random positions (what drives window switching)
    n_trans = int(0.4 * b)
    idx = rng.choice(b, n_trans, replace=False)
    for i in idx:
        for _ in range(rng.integers(1, 4)):
            pos = int(rng.integers(0, total - n))
            dur = int(rng.integers(n // 16, n // 2))
            burst = rng.standard_normal(dur) * np.exp(
                -np.arange(dur) / (0.12 * dur)
            )
            x[i, :, pos : pos + dur] += 0.5 * burst[None, :]

    x = np.clip(x, -1.0, 1.0).astype(np.float32)
    return np.ascontiguousarray(x.reshape(b, 2, t, n).transpose(0, 2, 1, 3))


def make_corpus_realistic(b: int, t: int, n: int) -> np.ndarray:
    """[B, T, 2, N] realistic synthesized material: streams cycle
    through tests/material.py's speech/percussion/poly generators with
    per-stream seeds. Slower to synthesize than make_corpus (python
    resonator loops), so callers cache; intended for quality-oriented
    sweeps, not the throughput bench."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import material

    kinds = list(material.GENERATORS)
    out = np.empty((b, t, 2, n), np.float32)
    for i in range(b):
        out[i] = material.blocks_of(kinds[i % len(kinds)], n, t, 2,
                                    seed_offset=7 * (i // len(kinds)))
    return out


def assemble_streams(sizes: np.ndarray, datas: np.ndarray):
    """Concatenate each stream's blocks: sizes [B, T] bits (byte
    aligned), datas [B, T, max_bytes] -> (streams [B, S] uint8 padded
    for the decoder's window slices, window bytes). The window is the
    actual max block size, as the ULC2 container records it
    (tools/ulc_Helper.h MaxBlockSize)."""
    b, t = sizes.shape
    nbytes = sizes // 8
    win = -(-int(nbytes.max()) // 64) * 64 + 64
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        offs = 0
        for j in range(t):
            nb = int(nbytes[i, j])
            streams[i, offs : offs + nb] = datas[i, j, :nb]
            offs += nb
    return streams, win


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi` name and power limit of the cards, one per line."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def require_gpu():
    """Fail unless JAX's default backend is a GPU; return the device
    fields every measurement is reported with."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}"
        )
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "device_kind": d[0].device_kind,
        "device_count": len(d),
        "gpu": gpu_name_and_power_limit(),
    }


def best_time(fn, *args, reps: int = 3):
    """Best wall time of fn(*args) over reps calls, each waited for
    with block_until_ready, after one warm-up call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    device = require_gpu()

    import jax
    import jax.numpy as jnp
    from ulcx.parallel.mesh import batch_decode, batch_encode
    from ulcx.utils.compileopts import enable_compile_cache, jit_options
    from ulcx.utils.config import CodecConfig

    enable_compile_cache()
    b = int(os.environ.get("ULCX_BENCH_B", "512"))
    t = int(os.environ.get("ULCX_BENCH_T", "64"))
    n = int(os.environ.get("ULCX_BENCH_BS", "2048"))
    mode = os.environ.get("ULCX_BENCH_MODE", "cbr")
    do_decode = os.environ.get("ULCX_BENCH_DECODE", "1") != "0"
    kw = {"rate_kbps": 128.0} if mode in ("cbr", "abr") else {"quality": 50.0}
    if mode == "abr":
        kw["avg_complexity"] = 0.5
    cfg = CodecConfig(
        rate_hz=44100,
        n_chan=2,
        block_size=n,
        flat_stream=os.environ.get("ULCX_BENCH_FLAT", "0") == "1",
        fold_bitstream=int(os.environ.get("ULCX_BENCH_FOLD", "1")),
        transform_backend=os.environ.get("ULCX_BENCH_TBACKEND", "auto"),
        matmul_max_n=int(os.environ.get("ULCX_BENCH_MAXN", "2048")),
    )

    blocks = jnp.asarray(make_corpus(b, t, n))
    audio_seconds = b * t * n / 44100.0

    def report(metric, seconds):
        print(json.dumps({
            "metric": metric,
            "value": audio_seconds / seconds,
            "unit": "x_realtime",
            **device,
        }), flush=True)

    # scan_major: outputs stay in the scan-produced [T, B] layout
    enc = jax.jit(
        lambda x: batch_encode(x, cfg, mode, scan_major=True, **kw)[0],
        compiler_options=jit_options(),
    )
    enc_s, out = best_time(enc, blocks)

    if do_decode:
        sizes = np.asarray(out.size_bits).T  # [B, T]
        datas = np.asarray(out.data).transpose(1, 0, 2)
        streams, win = assemble_streams(sizes, datas)
        dec = jax.jit(
            lambda s: batch_decode(s, t, win, cfg),
            compiler_options=jit_options(),
        )
        dec_s, (_, _, corrupt) = best_time(dec, jnp.asarray(streams))
        if np.asarray(corrupt).any():
            raise SystemExit("decode flagged corrupt streams")
        report("decode_realtime_factor_per_chip_stereo44k_cbr128", dec_s)

    report("encode_realtime_factor_per_chip_stereo44k_cbr128", enc_s)


if __name__ == "__main__":
    main()
