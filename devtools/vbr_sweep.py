"""VBR quality sweep (BASELINE.md benchmark-config list: "VBR quality
sweep -1..-100").

Encodes the bench corpus at quality 10..95 and records the average
bitrate per quality plus encode throughput. The reference documents an
expected quality->avg-bitrate map "for various material"
(include/ulcEncoder.h:124-132); the sweep table is the evidence that
the VBR mode reproduces that curve's shape on the transient-heavy
bench corpus (absolute kbps is material-dependent).

Quality is passed as a TRACED scalar so the whole sweep shares one
compile (jnp.float32(q) accepts an abstract value).

Usage: python devtools/vbr_sweep.py            # GPU run
       JAX_PLATFORMS=cpu ULCX_BENCH_B=16 ULCX_BENCH_T=4 \
           python devtools/vbr_sweep.py        # CPU smoke
Writes vbr_sweep.json at the repo root.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference quality->avg-kbps upper bounds (include/ulcEncoder.h:124-132)
REF_MAP = {10: 30, 20: 40, 30: 50, 40: 60, 50: 75, 60: 95, 70: 125, 80: 175, 90: 300}


def main():
    sys.path.insert(0, ROOT)
    import jax

    from ulcx.utils.compileopts import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    from bench import make_corpus
    from ulcx.parallel.mesh import batch_encode
    from ulcx.utils.config import CodecConfig

    b = int(os.environ.get("ULCX_BENCH_B", "512"))
    t = int(os.environ.get("ULCX_BENCH_T", "64"))
    n = int(os.environ.get("ULCX_BENCH_BS", "2048"))
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)
    mat = os.environ.get("ULCX_BENCH_MATERIAL", "tones")
    if mat == "realistic":
        # speech/percussion/poly corpus (tests/material.py) — cached,
        # the python synth loops cost ~seconds per hundred streams
        from bench import make_corpus_realistic

        cache = os.path.join(tempfile.gettempdir(), f"vbr_corpus_real_{b}_{t}_{n}.npy")
        if os.path.exists(cache):
            blocks = jnp.asarray(np.load(cache))
        else:
            arr = make_corpus_realistic(b, t, n)
            np.save(cache, arr)
            blocks = jnp.asarray(arr)
    else:
        blocks = jnp.asarray(make_corpus(b, t, n))
    audio_seconds = b * t * n / 44100.0

    def step(x, q):
        out, stats = batch_encode(x, cfg, "vbr", quality=q)
        digest = jnp.sum(out.data.astype(jnp.int32), axis=(1, 2)) + out.size_bits.sum()
        return out.size_bits.sum(), digest

    fn = jax.jit(step)
    qualities = [5, 10, 20, 30, 40, 50, 60, 70, 80, 90, 95]
    rows = {}
    t0 = time.perf_counter()
    bits, digest = fn(blocks, jnp.float32(qualities[0]))
    np.asarray(digest)
    compile_s = time.perf_counter() - t0

    # throughput at q50 (one compile shared across the sweep)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        bits, digest = fn(blocks, jnp.float32(50.0))
        np.asarray(digest)
        best = min(best, time.perf_counter() - t0)
    rtf = audio_seconds / best

    for q in qualities:
        bits, digest = fn(blocks, jnp.float32(q))
        kbps = float(np.asarray(bits)) / 1000.0 / audio_seconds
        ref_cap = REF_MAP.get(q)
        rows[q] = {"avg_kbps": round(kbps, 2), "ref_cap_kbps": ref_cap}
        print(json.dumps({"quality": q, **rows[q]}), flush=True)

    result = {
        "metric": "encode_rtf_stereo_vbr_sweep_bs2048",
        "value": round(rtf, 2),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 2000.0, 4),
        "compile_s": round(compile_s, 1),
        "b": b,
        "t": t,
        "sweep": rows,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "sweep"}), flush=True)
    with open(os.path.join(ROOT, "vbr_sweep.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
