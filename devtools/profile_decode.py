"""Device-trace one bench decode step and print the top ops by time.

Usage: python devtools/profile_decode.py [trace_dir]
Env: ULCX_PROF_NCHAN, ULCX_PROF_BS, ULCX_PROF_T, ULCX_PROF_MODE
(cbr|abr|vbr), ULCX_PROF_KBPS / ULCX_PROF_Q — pick the bench config to
trace (defaults: stereo CBR-128 bs2048 T=8).
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
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(tempfile.gettempdir(), "ulcx_dtrace")
    import jax
    import jax.numpy as jnp
    from ulcx.parallel.mesh import batch_decode, batch_encode
    from ulcx.utils.config import CodecConfig
    from bench import make_corpus

    env = os.environ.get
    b = int(env("ULCX_PROF_B", "512"))
    t = int(env("ULCX_PROF_T", "8"))
    n = int(env("ULCX_PROF_BS", "2048"))
    c = int(env("ULCX_PROF_NCHAN", "2"))
    mode = env("ULCX_PROF_MODE", "cbr")
    kw = (
        {"quality": float(env("ULCX_PROF_Q", "50"))}
        if mode == "vbr"
        else {"rate_kbps": float(env("ULCX_PROF_KBPS", "128"))}
    )
    if mode == "abr":
        kw["avg_complexity"] = 0.5
    cfg = CodecConfig(rate_hz=44100, n_chan=c, block_size=n)
    blocks = jnp.asarray(make_corpus(b, t, n)[:, :, :c])
    enc = jax.jit(lambda x: batch_encode(x, cfg, mode, **kw))
    o, _ = enc(blocks)
    sizes = np.asarray(o.size_bits)
    datas = np.asarray(o.data)
    win = -(-int(sizes.max() // 8) // 64) * 64 + 64
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        offs = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            streams[i, offs : offs + nb] = datas[i, j, :nb]
            offs += nb
    streams = jnp.asarray(streams)

    def dec_step(s):
        pcm, bits, corrupt = batch_decode(s, t, win, cfg)
        return jnp.sum(pcm, axis=(1, 2, 3)) + bits.sum()

    dec = jax.jit(dec_step)
    np.asarray(dec(streams))

    with jax.profiler.trace(out):
        for _ in range(2):
            np.asarray(dec(streams))

    paths = glob.glob(os.path.join(out, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        print("no xplane produced")
        return
    pd = jax.profiler.ProfileData.from_serialized_xspace(
        open(sorted(paths)[-1], "rb").read()
    )
    for plane in pd.planes:
        if "/device:GPU" not in plane.name:
            continue
        total = defaultdict(float)
        count = defaultdict(int)
        for line in plane.lines:
            for ev in line.events:
                total[ev.name] += ev.duration_ns
                count[ev.name] += 1
        print(f"== plane: {plane.name} (sum {sum(total.values())/1e6:.1f} ms)")
        for name, dur in sorted(total.items(), key=lambda kv: -kv[1])[:30]:
            print(f"  {dur/1e6:9.2f} ms  x{count[name]:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
