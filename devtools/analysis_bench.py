"""Sub-stage bisection inside analyze_block_batched (same methodology
as dec_bench.py: full scan-over-T pipelines, deltas between variants).

Usage: python devtools/analysis_bench.py [stage ...]
Stages: wc mdct psy imp rank
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ulcx.analysis.batched import _psy_noise_batched
    from ulcx.analysis.block import (
        _INV_LOG2E,
        _NEG_LOG4,
        AnalyzedBlock,
        EncoderCarry,
        ms_transform,
    )
    from ulcx.analysis.window_control import get_window_ctrl
    from ulcx.codec.transform import first_overlap, last_subblock_size
    from ulcx.codec.transform_batched import block_mdct_mdst_batched
    from ulcx.ops.fastlog import fast_log
    from ulcx.utils.config import COEF_EPS, CodecConfig
    from ulcx.codec.encoder import init_carry_batched

    b = int(os.environ.get("ULCX_BENCH_B", "512"))
    t = int(os.environ.get("ULCX_BENCH_T", "8"))
    n = int(os.environ.get("ULCX_BENCH_BS", "2048"))
    cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=n)

    rng = np.random.default_rng(7)
    tt = np.arange(t * n) / 44100.0
    base = (
        0.35 * np.sin(2 * np.pi * 440 * tt)
        + 0.1 * np.sin(2 * np.pi * 1870 * tt)
        + 0.02 * rng.standard_normal(t * n)
    ).astype(np.float32)
    blocks = np.broadcast_to(
        base.reshape(1, t, 1, n), (b, t, 2, n)
    ) * rng.uniform(0.5, 1.0, (b, 1, 1, 1)).astype(np.float32)
    blocks = jnp.asarray(np.ascontiguousarray(blocks))

    def upto(stage):
        def step(carry, new_blocks):
            new_ms = jax.vmap(ms_transform)(new_blocks)
            samples = jnp.concatenate([carry.sample_prev, new_ms], axis=-1)
            window_ctrl = carry.next_window_ctrl
            next_wc, tstate = jax.vmap(
                lambda s, st: get_window_ctrl(s, st, cfg)
            )(samples, carry.transient)
            next_ov = first_overlap(next_wc, n)
            new_carry_wc = EncoderCarry(
                sample_prev=new_ms,
                transient=tstate,
                next_window_ctrl=next_wc,
                prev_last_ss=last_subblock_size(window_ctrl, n),
            )
            if stage == "wc":
                return new_carry_wc, (jnp.sum(next_wc),)
            mdct, mdst = block_mdct_mdst_batched(
                samples, window_ctrl, carry.prev_last_ss, next_ov, cfg
            )
            if stage == "mdct":
                return new_carry_wc, (jnp.sum(mdct), jnp.sum(mdst))
            mask_coef, noise = _psy_noise_batched(mdct, mdst, window_ctrl, cfg)
            if stage == "psy":
                return new_carry_wc, (jnp.sum(mask_coef), jnp.sum(noise))
            re2 = mdct * mdct
            val_np = jnp.where(
                jnp.abs(mdct) < jnp.float32(0.5 * COEF_EPS),
                -jnp.inf,
                fast_log(re2),
            )
            chan_pen = _NEG_LOG4 * (jnp.arange(cfg.n_chan) & 1).astype(jnp.float32)
            importance = (
                2.0 * val_np + mask_coef[:, None, :] + chan_pen[None, :, None]
            )
            csum = jnp.sum(re2, axis=(1, 2))
            cw = jnp.sum(jnp.abs(mdct), axis=(1, 2))
            scale = _INV_LOG2E * np.float32(int(np.log2(n)))
            complexity = jnp.where(
                csum > 0,
                jnp.clip(
                    jnp.log(
                        jnp.maximum(cw * cw / jnp.maximum(csum, 1e-38), 1e-38)
                    )
                    / scale,
                    0.0,
                    1.0,
                ),
                0.0,
            )
            n_nz = jnp.sum(
                jnp.abs(mdct) >= jnp.float32(0.5 * COEF_EPS), axis=(1, 2)
            )
            if stage == "imp":
                return new_carry_wc, (
                    jnp.sum(importance),
                    jnp.sum(complexity),
                    jnp.sum(n_nz),
                )
            flat = importance.reshape(b, -1)
            order = jnp.argsort(-flat, axis=-1)
            rank = jnp.argsort(order, axis=-1)
            return new_carry_wc, (jnp.sum(rank), jnp.sum(n_nz))

        return step

    def scan_over(step):
        def fn(x):
            carry = init_carry_batched(cfg, b)
            carry, out = lax.scan(step, carry, x.transpose(1, 0, 2, 3))
            return out

        return jax.jit(fn)

    stages = ["wc", "mdct", "psy", "imp", "rank"]
    want = sys.argv[1:] or stages
    audio = b * t * n / 44100.0
    results = {}
    for name in want:
        fn = scan_over(upto(name))
        t0 = time.perf_counter()
        out = fn(blocks)
        np.asarray(jax.tree_util.tree_leaves(out)[0])
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(blocks)
            for leaf in jax.tree_util.tree_leaves(out):
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
