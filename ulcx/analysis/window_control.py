"""Transient detection and window control.

Faithful port of the reference's algorithm (reference
libulc/ulcEncoder_WindowControl.c) re-expressed with parallel scans:

1. Two 3-tap filters (HP ``-z^-1 + 2 - z`` and BP ``-z^-1 + z``) over
   all channels of the M/S'd sample buffer, MDCT-aligned with a lag of
   BlockSize/2; energies summed over channels (reference :31-70).
2. Forward smear (post-masking, -1 dB/ms HP / -3 dB/ms BP), then
   backward smear (pre-masking, -2 / -3 dB/ms); the smears are EMAs
   evaluated with associative scans. The 'error' energy is
   ``(dHP*EnvBP)^2 + (dBP*EnvHP)^2`` (reference :72-104).
3. A block-size-dependent EMA integrates the error into 8 segment sums
   (two halves of a 16-entry transient buffer carried across blocks;
   reference :107-134).
4. A window-size search (at most 4 static iterations, unrolled with
   masked scalar updates) grows the subblock size while the max
   attack/release log-ratio keeps increasing, then derives the overlap
   scale (reference :140-239).

All filter/envelope state is a small carried pytree, making the whole
thing jit/scan/vmap-friendly. Decibel-rate constants reproduce the
reference's hex-float literals exactly via ``float.fromhex``.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ulcx.ops.scanutil import ema, ema_matmul, ema_matmul_chunked
from ulcx.utils.config import CodecConfig

_RATE_HP_FWD = float.fromhex("0x1.CC845Cp6")   # -1.0 dB/ms
_RATE_BP_FWD = float.fromhex("0x1.596344p8")   # -3.0 dB/ms
_RATE_HP_BWD = float.fromhex("0x1.CC845Cp7")   # -2.0 dB/ms
_RATE_BP_BWD = float.fromhex("0x1.596344p8")   # -3.0 dB/ms
_RATE_BLOCK = float.fromhex("0x1.1AF110p-6")   # -0.00015 dB/ms * BlockSize
_LOG2 = float.fromhex("0x1.62E430p-1")
_INV_LOG2 = float.fromhex("0x1.715476p0")


class TransientState(NamedTuple):
    """Carried across blocks (reference TransientFilter[3] + TransientBuffer)."""

    env_hp: jnp.ndarray      # scalar f32
    env_bp: jnp.ndarray      # scalar f32
    env_block: jnp.ndarray   # scalar f32
    seg_sum: jnp.ndarray     # [16] f32: L half then R half
    seg_w: jnp.ndarray       # [16] f32

    @staticmethod
    def init(dtype=jnp.float32):
        z = jnp.zeros((), dtype)
        return TransientState(z, z, z, jnp.zeros(16, dtype), jnp.zeros(16, dtype))


def _transient_filtering(samples: jnp.ndarray, st: TransientState, cfg: CodecConfig):
    """samples: [C, 2N] (prev block || new block, already M/S).

    Returns (new TransientState) with fresh R-half segment sums.
    """
    n = cfg.block_size
    rate_hz = cfg.rate_hz

    # 3-tap filter energies, lag N/2: q[k] = concat(prev,new)[N/2 - 1 + k]
    q = samples[..., n // 2 - 1 : n // 2 - 1 + n + 2]  # [C, N+2]
    t0, t1, t2 = q[..., :-2], q[..., 1:-1], q[..., 2:]
    hp = jnp.sum((-t0 + 2 * t1 - t2) ** 2, axis=-2)  # [N], summed over channels
    bp = jnp.sum((-t0 + t2) ** 2, axis=-2)

    # forward smear (amplitude domain). The Toeplitz-matmul EMA needs an
    # [N, N] kernel constant (~67 MB of f32 at N=4096, several of them),
    # so large blocks use the chunked two-stage matmul form instead: exact
    # per-chunk [K, K] Toeplitz + a tiny cross-chunk carry closure
    # (scanutil.ema_matmul_chunked) — N*K MACs instead of N^2 and KiB
    # constants, same recurrence up to float association.
    if n <= 2048:
        ema_f = ema_matmul
    else:
        ema_f = partial(ema_matmul_chunked, chunk=1024)

    r_hp = math.exp(-_RATE_HP_FWD / rate_hz)
    r_bp = math.exp(-_RATE_BP_FWD / rate_hz)
    env_hp = ema_f(jnp.sqrt(hp), r_hp, st.env_hp)
    env_bp = ema_f(jnp.sqrt(bp), r_bp, st.env_bp)

    # backward smear; d uses the pre-update envelope, the cross products
    # use the post-update one (reference :96-104)
    rb_hp = math.exp(-_RATE_HP_BWD / rate_hz)
    rb_bp = math.exp(-_RATE_BP_BWD / rate_hz)
    pre_hp = ema_f(env_hp, rb_hp, env_hp[..., -1], reverse=True)
    pre_bp = ema_f(env_bp, rb_bp, env_bp[..., -1], reverse=True)
    # pre-update env at n == post-update env at n+1 (scanning right->left)
    before_hp = jnp.concatenate([pre_hp[..., 1:], env_hp[..., -1:]], axis=-1)
    before_bp = jnp.concatenate([pre_bp[..., 1:], env_bp[..., -1:]], axis=-1)
    d_hp = env_hp - before_hp
    d_bp = env_bp - before_bp
    err = (d_hp * pre_bp) ** 2 + (d_bp * pre_hp) ** 2

    # segment integration with the block-mask EMA
    r_blk = math.exp(-_RATE_BLOCK * cfg.block_size / rate_hz)
    em = ema_f(err, r_blk, st.env_block)
    seg_new = jnp.sum(em.reshape(8, n // 8), axis=-1)

    return TransientState(
        env_hp=env_hp[..., -1],
        env_bp=env_bp[..., -1],
        env_block=em[..., -1],
        seg_sum=jnp.concatenate([st.seg_sum[8:], seg_new]),
        seg_w=jnp.concatenate([st.seg_w[8:], jnp.full(8, float(n // 8), jnp.float32)]),
    )


def _segment_ratios(st: TransientState, n_seg: int, seg_size: int):
    """(max_ratio, argmax segment) for one search iteration (static sizes)."""
    csum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(st.seg_sum)])
    cw = jnp.concatenate([jnp.zeros(1), jnp.cumsum(st.seg_w)])
    base = 8
    starts = base + np.arange(n_seg) * seg_size
    r_sum = csum[starts + seg_size] - csum[starts]
    r_w = cw[starts + seg_size] - cw[starts]
    l_sum = csum[starts] - csum[starts - seg_size]
    l_w = cw[starts] - cw[starts - seg_size]
    l_np = jnp.where(l_sum > 0, jnp.log(jnp.maximum(l_sum, 1e-38) / jnp.maximum(l_w, 1e-38)), -100.0)
    r_np = jnp.where(r_sum > 0, jnp.log(jnp.maximum(r_sum, 1e-38) / jnp.maximum(r_w, 1e-38)), -100.0)
    ratio = jnp.abs(r_np - l_np)
    max_ratio = jnp.max(ratio)
    max_seg = jnp.argmax(ratio).astype(jnp.int32)  # first max, like the C scan
    return max_ratio, max_seg


def get_window_ctrl(samples: jnp.ndarray, st: TransientState, cfg: CodecConfig):
    """Window control for the *next* block (reference ULCi_GetWindowCtrl).

    samples: [C, 2N] M/S'd sample buffer. Returns (window_ctrl int32,
    new TransientState).
    """
    st = _transient_filtering(samples, st, cfg)

    n = cfg.block_size
    max_decim = cfg.max_decimation
    log2_sub = int(math.log2(n // max_decim))
    n_segments = max_decim
    # the carried buffer always holds 8 sub-segments per half; when the
    # decimation factor is smaller, each search segment spans several
    seg_size = 8 // max_decim
    if log2_sub < 6:
        shift = 6 - log2_sub
        n_segments >>= shift
        seg_size <<= shift
        log2_sub = 6

    # Static-unrolled search. Iteration k uses n_segments >> k segments of
    # seg_size << k entries; at most log2(n_segments)+1 iterations.
    decim = jnp.int32(1)
    trans_ratio = jnp.float32(0.0)
    final_log2 = jnp.int32(log2_sub)
    running = jnp.bool_(True)
    k = 0
    while (n_segments >> k) >= 1:
        ns, sz = n_segments >> k, seg_size << k
        max_ratio, max_seg = _segment_ratios(st, ns, sz)
        this_log2 = log2_sub + 1 + k
        # break if ratio dropped; otherwise accept this decimation
        accept = running & (max_ratio - trans_ratio >= jnp.float32(_LOG2))
        final_log2 = jnp.where(running, jnp.int32(this_log2), final_log2)
        decim = jnp.where(accept, jnp.int32(ns) + max_seg, decim)
        trans_ratio = jnp.where(accept, max_ratio, trans_ratio)
        # continue only if accepted and (ns > 1 and ratio < log 2)
        running = accept & (ns > 1) & (trans_ratio < jnp.float32(_LOG2))
        k += 1

    # final window parameters
    ratio_l2 = trans_ratio * jnp.float32(_INV_LOG2)
    scale = jnp.where(
        ratio_l2 < 0.5,
        0,
        jnp.where(ratio_l2 >= 6.5, 7, jnp.round(ratio_l2).astype(jnp.int32)),
    ).astype(jnp.int32)
    scale = jnp.where(final_log2 - scale < 6, final_log2 - 6, scale)
    wc = scale + 0x8 * (decim != 1).astype(jnp.int32) + 0x10 * decim
    wc = jnp.where(trans_ratio < jnp.float32(_LOG2 / 2), jnp.int32(0x10), wc)
    return wc.astype(jnp.int32), st
