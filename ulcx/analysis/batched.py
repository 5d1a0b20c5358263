"""Batch-native encoder analysis (no per-pattern control flow).

Production counterpart of ``ulcx.analysis.block``: identical math, but
psychoacoustics/noise spectra are computed for *every size class* over
the whole batch and selected per line/coefficient through the static
class maps — the same trick as ``ulcx.codec.transform_batched``. The
per-stream switch implementation remains the readable reference; tests
assert equality.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ulcx.analysis.block import AnalyzedBlock, EncoderCarry, _NEG_LOG4, _INV_LOG2E
from ulcx.analysis.psy import masking_curve, noise_log_spectrum
from ulcx.analysis.window_control import get_window_ctrl
from ulcx.codec.transform import first_overlap, last_subblock_size
from ulcx.codec.transform_batched import (
    block_mdct_mdst_batched,
    candidate_tables,
)
from ulcx.ops.fastlog import fast_log
from ulcx.utils.config import COEF_EPS, CodecConfig


def _psy_noise_batched(mdct, mdst, window_ctrl, cfg: CodecConfig):
    """Per-class psy/noise with per-line class selection.

    mdct/mdst: [B, C, N]. Returns (masking [B, N/2], noise [B, C, N],
    mask_map [B, N]).
    """
    n = cfg.block_size
    b, c, _ = mdct.shape
    t = candidate_tables(n)
    abs2 = mdct * mdct + mdst * mdst
    lines = abs2[..., 0::2] + abs2[..., 1::2]  # [B, C, N/2]
    lines_tot = jnp.sum(lines, axis=1)  # [B, N/2]

    mask_cls, noise_cls = [], []
    for cls in range(4):
        ss = n >> cls
        npos = 1 << cls
        m = ss // 2
        if cfg.use_psychoacoustics:
            lt = lines_tot.reshape(b, npos, m)
            mask_cls.append(masking_curve(lt, m, cfg.rate_hz).reshape(b, n // 2))
        if cfg.use_noise_coding:
            lc = lines.reshape(b, c, npos, m)
            noise_cls.append(
                noise_log_spectrum(lc, m, cfg.rate_hz).reshape(b, c, n)
            )

    pat = window_ctrl >> 4
    cls_line = jnp.asarray(t["cls_line"])[pat]  # [B, N/2]
    cls_coef = jnp.asarray(t["cls_coef"])[pat]  # [B, N]

    if cfg.use_psychoacoustics:
        # per-coefficient masking: within a class, coef k maps to line
        # k//2 of that class's layout — a 2x repeat, then a 4-way class
        # select as a where-chain (in place of a [B, N, 4] stack +
        # take_along_axis)
        mask_coef = jnp.repeat(mask_cls[0], 2, axis=-1)
        for k in range(1, 4):
            mask_coef = jnp.where(
                cls_coef == k, jnp.repeat(mask_cls[k], 2, axis=-1), mask_coef
            )
    else:
        mask_coef = jnp.zeros((b, n), jnp.float32)
    if cfg.use_noise_coding:
        noise = noise_cls[0]
        for k in range(1, 4):
            noise = jnp.where(cls_coef[:, None, :] == k, noise_cls[k], noise)
    else:
        noise = jnp.zeros_like(mdct)

    return mask_coef, noise


def _analyze_core(samples, window_ctrl, prev_last_ss, next_ov, cfg: CodecConfig):
    """Non-recurrent analysis on a flat batch: samples [F, C, 2N]
    (prev||new pairs), window_ctrl/prev_last_ss/next_ov [F]. Returns
    AnalyzedBlock with leading [F]."""
    n = cfg.block_size
    f = samples.shape[0]

    mdct, mdst = block_mdct_mdst_batched(
        samples, window_ctrl, prev_last_ss, next_ov, cfg
    )
    mask_coef, noise = _psy_noise_batched(mdct, mdst, window_ctrl, cfg)

    re2 = mdct * mdct
    val_np = jnp.where(
        jnp.abs(mdct) < jnp.float32(0.5 * COEF_EPS), -jnp.inf, fast_log(re2)
    )
    if cfg.use_psychoacoustics:
        chan_pen = _NEG_LOG4 * (jnp.arange(cfg.n_chan) & 1).astype(jnp.float32)
        importance = 2.0 * val_np + mask_coef[:, None, :] + chan_pen[None, :, None]
    else:
        importance = val_np

    csum = jnp.sum(re2, axis=(1, 2))
    cw = jnp.sum(jnp.abs(mdct), axis=(1, 2))
    scale = _INV_LOG2E * np.float32(int(np.log2(n)))
    complexity = jnp.where(
        csum > 0,
        jnp.clip(
            jnp.log(jnp.maximum(cw * cw / jnp.maximum(csum, 1e-38), 1e-38)) / scale,
            0.0,
            1.0,
        ),
        0.0,
    ).astype(jnp.float32)

    n_nz = jnp.sum(
        jnp.abs(mdct) >= jnp.float32(0.5 * COEF_EPS), axis=(1, 2)
    ).astype(jnp.int32)


    return AnalyzedBlock(
        window_ctrl=window_ctrl,
        mdct=mdct,
        noise=noise,
        importance=importance.astype(jnp.float32),
        complexity=complexity,
        n_nz=n_nz,
    )


def analyze_stream_batched(carry: EncoderCarry, blocks: jnp.ndarray, cfg: CodecConfig):
    """Whole-chunk analysis: blocks [B, T, C, N] -> AnalyzedBlock with
    leading [B*T] (b-major) + new carry.

    Only the window-control chain is recurrent across blocks (transient
    filter EMAs + the one-block lookahead); it runs as a T-step scan on
    small state. Everything heavy (transforms, psy, ranks) then runs
    ONCE over the flattened [B*T] batch, so their per-step fixed
    costs are paid once instead of T times."""
    from ulcx.analysis.block import ms_transform

    n = cfg.block_size
    b, t = blocks.shape[0], blocks.shape[1]

    new_ms = jax.vmap(jax.vmap(ms_transform))(blocks)  # [B, T, C, N]
    prevs = jnp.concatenate(
        [carry.sample_prev[:, None], new_ms[:, :-1]], axis=1
    )
    pairs = jnp.concatenate([prevs, new_ms], axis=-1)  # [B, T, C, 2N]

    def wc_step(tstate, s_t):
        next_wc, tstate = jax.vmap(lambda s, st: get_window_ctrl(s, st, cfg))(
            s_t, tstate
        )
        return tstate, next_wc

    tstate, next_wcs = jax.lax.scan(
        wc_step, carry.transient, pairs.transpose(1, 0, 2, 3)
    )  # next_wcs [T, B]

    wcs_full = jnp.concatenate(
        [carry.next_window_ctrl[None], next_wcs], axis=0
    )  # [T+1, B]
    wc_t = wcs_full[:t].transpose(1, 0)          # [B, T] per coded block
    next_ov_t = first_overlap(wcs_full[1:], n).transpose(1, 0)  # [B, T]
    last_ss_all = last_subblock_size(wcs_full[: t], n)  # [T, B] of blocks 0..T-1
    prev_ss_t = jnp.concatenate(
        [carry.prev_last_ss[:, None], last_ss_all[: t - 1].transpose(1, 0)],
        axis=1,
    )  # [B, T]

    bf = b * t
    ab = _analyze_core(
        pairs.reshape(bf, cfg.n_chan, 2 * n),
        wc_t.reshape(bf),
        prev_ss_t.reshape(bf),
        next_ov_t.reshape(bf),
        cfg,
    )

    new_carry = EncoderCarry(
        sample_prev=new_ms[:, -1],
        transient=tstate,
        next_window_ctrl=next_wcs[-1],
        prev_last_ss=last_ss_all[-1],
    )
    return new_carry, ab


def analyze_block_batched(carry: EncoderCarry, new_blocks: jnp.ndarray, cfg: CodecConfig):
    """Batched analyze: carry pytree with leading [B], new_blocks [B, C, N]."""
    from ulcx.analysis.block import ms_transform

    n = cfg.block_size
    b = new_blocks.shape[0]

    new_ms = jax.vmap(ms_transform)(new_blocks)
    samples = jnp.concatenate([carry.sample_prev, new_ms], axis=-1)  # [B, C, 2N]

    window_ctrl = carry.next_window_ctrl
    next_wc, tstate = jax.vmap(lambda s, st: get_window_ctrl(s, st, cfg))(
        samples, carry.transient
    )
    next_ov = first_overlap(next_wc, n)

    mdct, mdst = block_mdct_mdst_batched(
        samples, window_ctrl, carry.prev_last_ss, next_ov, cfg
    )
    mask_coef, noise = _psy_noise_batched(mdct, mdst, window_ctrl, cfg)

    re2 = mdct * mdct
    val_np = jnp.where(
        jnp.abs(mdct) < jnp.float32(0.5 * COEF_EPS), -jnp.inf, fast_log(re2)
    )
    if cfg.use_psychoacoustics:
        chan_pen = _NEG_LOG4 * (jnp.arange(cfg.n_chan) & 1).astype(jnp.float32)
        importance = 2.0 * val_np + mask_coef[:, None, :] + chan_pen[None, :, None]
    else:
        importance = val_np

    csum = jnp.sum(re2, axis=(1, 2))
    cw = jnp.sum(jnp.abs(mdct), axis=(1, 2))
    scale = _INV_LOG2E * np.float32(int(np.log2(n)))
    complexity = jnp.where(
        csum > 0,
        jnp.clip(
            jnp.log(jnp.maximum(cw * cw / jnp.maximum(csum, 1e-38), 1e-38)) / scale,
            0.0,
            1.0,
        ),
        0.0,
    ).astype(jnp.float32)

    n_nz = jnp.sum(
        jnp.abs(mdct) >= jnp.float32(0.5 * COEF_EPS), axis=(1, 2)
    ).astype(jnp.int32)


    new_carry = EncoderCarry(
        sample_prev=new_ms,
        transient=tstate,
        next_window_ctrl=next_wc,
        prev_last_ss=last_subblock_size(window_ctrl, n),
    )
    return new_carry, AnalyzedBlock(
        window_ctrl=window_ctrl,
        mdct=mdct,
        noise=noise,
        importance=importance.astype(jnp.float32),
        complexity=complexity,
        n_nz=n_nz,
    )
