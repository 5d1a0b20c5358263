"""Stage bisection for the batched decode pipeline (full-bench A/B).

Variants run the scan-over-blocks structure of decode_stream_batched
with the per-block work cut at successive stages:
  win   — window slices only
  fsm   — + FSM kernel
  exp   — + record expansion (scatters + ffills)
  rngk  — + RNG kernel + coefficient assembly
  imdct — + batched IMDCT + M/S (= full decode)
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ulcx.codec.decoder import inverse_ms
    from ulcx.codec.transform_batched import block_imdct_batched
    from ulcx.parallel.mesh import batch_encode
    from ulcx.utils.config import CodecConfig

    b = int(os.environ.get("ULCX_BENCH_B", "512"))
    t = int(os.environ.get("ULCX_BENCH_T", "8"))
    n = int(os.environ.get("ULCX_BENCH_BS", "2048"))
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)
    c = cfg.n_chan
    p_tot = n * c

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import make_corpus

    cache = os.path.join(tempfile.gettempdir(), f"dec_bench_streams_{b}_{t}_{n}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        streams_np, win = z["streams"], int(z["win"])
    else:
        blocks = jnp.asarray(make_corpus(b, t, n))
        out, _ = jax.jit(lambda x: batch_encode(x, cfg, "cbr", rate_kbps=128.0))(
            blocks
        )
        sizes = np.asarray(out.size_bits)
        datas = np.asarray(out.data)
        win = -(-int(sizes.max() // 8) // 64) * 64 + 64
        streams_np = np.zeros((b, t * win + win + 64), np.uint8)
        for i in range(b):
            offs = 0
            for j in range(t):
                nb = int(sizes[i, j]) // 8
                streams_np[i, offs : offs + nb] = datas[i, j, :nb]
                offs += nb
        np.savez(cache, streams=streams_np, win=win)
    streams = jnp.asarray(streams_np)

    def make_real(stage):
        """Variants over the REAL decode_block_fast / stream path."""
        from ulcx.bitstream.fast_decode import decode_block_fast
        from ulcx.codec.decoder import decode_stream_batched

        if stage == "full":
            def fn(_):
                pcm, bits, corrupt = decode_stream_batched(streams, t, win, cfg)
                return (jnp.sum(pcm), jnp.sum(bits))

            return jax.jit(fn)

        def step(state, _):
            offset, rng = state
            windows = jax.vmap(
                lambda s, o: lax.dynamic_slice(s, (o,), (win,))
            )(streams, offset)
            coefs, wc, bits, corrupt, rng = decode_block_fast(
                windows, rng, cfg, False
            )
            offset = offset + (bits + 7) // 8
            return (offset, rng), (jnp.sum(coefs), jnp.sum(bits))

        def fn(_):
            init = (jnp.zeros(b, jnp.int32), jnp.full(b, 1234567, jnp.uint32))
            _, outs = lax.scan(step, init, None, length=t)
            return outs

        return jax.jit(fn)

    def make(stage):
        """Stage-cut variants composed from the PRODUCTION pipeline
        functions (fsm_records / records_to_flags / expand_coefs /
        block_imdct_batched), cut after the named stage."""
        if stage in ("blkfast", "full"):
            return make_real(stage)
        from ulcx.bitstream.fast_decode import (
            expand_coefs,
            fsm_records,
            records_to_flags,
        )

        def step(state, _):
            offset, lap, prev_ss, rng = state
            windows = jax.vmap(
                lambda s, o: lax.dynamic_slice(s, (o,), (win,))
            )(streams, offset)
            if stage == "win":
                # fake advance to keep the loop honest
                adv = (windows[:, 0].astype(jnp.int32) & 0) + 600
                return (offset + adv, lap, prev_ss, rng), (
                    jnp.sum(windows.astype(jnp.int32)),
                )

            rec, code, wc, hdr, consumed, corrupt = fsm_records(
                windows, cfg, False
            )
            bits = 4 * (hdr + consumed)
            offset = offset + (bits + 7) // 8
            if stage == "fsm":
                return (offset, lap, prev_ss, rng), (
                    jnp.sum(rec) + jnp.sum(code) + jnp.sum(corrupt),
                )

            flags = records_to_flags(rec, code, p_tot)
            if stage == "exp":
                return (offset, lap, prev_ss, rng), (jnp.sum(flags),)

            coefs, rng = expand_coefs(flags, rng, p_tot, False)
            coefs = jnp.where(corrupt[:, None] == 1, 0.0, coefs).reshape(b, c, n)
            if stage == "rngk":
                return (offset, lap, prev_ss, rng), (jnp.sum(coefs),)

            pcm, lap, prev_ss = block_imdct_batched(coefs, wc, lap, prev_ss, cfg)
            pcm = inverse_ms(pcm)
            return (offset, lap, prev_ss, rng), (jnp.sum(pcm),)

        def fn(_):
            init = (
                jnp.zeros(b, jnp.int32),
                jnp.zeros((b, c, n // 2), jnp.float32),
                jnp.zeros(b, jnp.int32),
                jnp.full(b, 1234567, jnp.uint32),
            )
            _, outs = lax.scan(step, init, None, length=t)
            return outs

        return jax.jit(fn)

    audio = b * t * n / 44100.0
    stages = ["win", "fsm", "exp", "rngk", "imdct"]
    want = sys.argv[1:] or stages
    results = {}
    for name in want:
        g = make(name)
        t0 = time.perf_counter()
        o = g(0)
        np.asarray(jax.tree_util.tree_leaves(o)[0])
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            o = g(0)
            for leaf in jax.tree_util.tree_leaves(o):
                np.asarray(leaf)
            best = min(best, time.perf_counter() - t0)
        results[name] = best
        print(
            f"{name:6s} {best*1000:8.1f} ms  ({audio/best:7.1f}x rt)"
            f"  [compile {compile_s:.0f}s]",
            flush=True,
        )
    names = [k for k in stages if k in results]
    for a, bnm in zip(names, names[1:]):
        print(f"delta {a}->{bnm}: {(results[bnm]-results[a])*1000:8.1f} ms")


if __name__ == "__main__":
    main()
