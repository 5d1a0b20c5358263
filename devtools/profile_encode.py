"""Device-trace one bench encode step and print the top ops by self time.

Uses jax.profiler.trace -> xplane.pb -> jax.profiler.ProfileData.
Usage: python devtools/profile_encode.py [trace_dir]
"""

from __future__ import annotations

import glob
import os
import sys
import tempfile
from collections import defaultdict

import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "ulcx_trace")
    import jax

    from ulcx.utils.compileopts import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from ulcx.parallel.mesh import batch_encode
    from ulcx.utils.config import CodecConfig
    from bench import make_corpus

    b = int(os.environ.get("ULCX_BENCH_B", "512"))
    t = int(os.environ.get("ULCX_BENCH_T", "8"))
    n = int(os.environ.get("ULCX_BENCH_BS", "2048"))
    c = int(os.environ.get("ULCX_BENCH_C", "2"))
    mode = os.environ.get("ULCX_BENCH_MODE", "cbr")
    kw = {"rate_kbps": 128.0} if mode in ("cbr", "abr") else {"quality": 50.0}
    if mode == "abr":
        kw["avg_complexity"] = 0.5
    cfg = CodecConfig(rate_hz=44100, n_chan=c, block_size=n)
    corpus = make_corpus(b, t, n)
    blocks = jnp.asarray(corpus[:, :, :c])
    fn = jax.jit(lambda x: batch_encode(x, cfg, mode, **kw))
    o, _ = fn(blocks)
    np.asarray(o.size_bits)  # compile + warm

    with jax.profiler.trace(out):
        for _ in range(2):
            o, _ = fn(blocks)
            np.asarray(o.size_bits)
            np.asarray(o.data[0, 0])

    paths = glob.glob(os.path.join(out, "**", "*.xplane.pb"), recursive=True)
    print("xplane files:", paths)
    if not paths:
        return
    pd = jax.profiler.ProfileData.from_serialized_xspace(
        open(sorted(paths)[-1], "rb").read()
    )
    for plane in pd.planes:
        total = defaultdict(float)
        count = defaultdict(int)
        for line in plane.lines:
            for ev in line.events:
                name = ev.name
                dur = ev.duration_ns
                total[name] += dur
                count[name] += 1
        if not total:
            continue
        print(f"== plane: {plane.name} (sum {sum(total.values())/1e6:.1f} ms)")
        for name, dur in sorted(total.items(), key=lambda kv: -kv[1])[:40]:
            print(f"  {dur/1e6:9.2f} ms  x{count[name]:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
