"""B-scaling sweep: run the full bench encode path at several batch sizes.

If analysis cost is near-B-invariant (a fixed cost per fused kernel),
throughput rises near-linearly with B until the kernel/assemble stages
dominate. This harness runs the exact bench.py encode path at a list of
batch sizes and prints one line per point.

Usage: python devtools/bscale_bench.py [B ...]   (default: 512 1024 2048)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main():
    bs = [int(a) for a in sys.argv[1:]] or [512, 1024, 2048]
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from ulcx.utils.compileopts import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    from ulcx.parallel.mesh import batch_encode
    from ulcx.utils.config import CodecConfig
    from bench import make_corpus

    t = int(os.environ.get("ULCX_BENCH_T", "8"))
    n = int(os.environ.get("ULCX_BENCH_BS", "2048"))
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)

    for b in bs:
        blocks = jnp.asarray(make_corpus(b, t, n))
        audio_seconds = b * t * n / 44100.0
        fn = jax.jit(lambda x: batch_encode(x, cfg, "cbr", rate_kbps=128.0))
        tc0 = time.perf_counter()
        out, stats = fn(blocks)
        np.asarray(out.size_bits)
        np.asarray(out.data[0, 0])
        compile_s = time.perf_counter() - tc0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out, stats = fn(blocks)
            np.asarray(out.size_bits)
            np.asarray(out.data[0, 0])
            best = min(best, time.perf_counter() - t0)
        print(
            f"B={b:5d} T={t} bs={n}: {best*1e3:8.1f} ms "
            f"({audio_seconds/best:7.1f}x realtime)  [compile {compile_s:.0f}s]",
            flush=True,
        )
        del blocks, out, stats, fn


if __name__ == "__main__":
    main()
