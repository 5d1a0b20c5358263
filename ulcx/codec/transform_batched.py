"""Batch-native lapped transforms (no per-pattern control flow).

``ulcx.codec.transform`` dispatches on the window pattern with
``lax.switch`` — ideal for a single stream, but under ``vmap`` every
branch runs for the whole batch (16x waste). This module is the
batch-native formulation: window patterns only ever use subblocks of
the four *size classes* N, N/2, N/4, N/8 at fixed offsets (15 candidate
subblocks total), so we

1. transform **every candidate subblock of every class** for the whole
   batch (4 dense matmuls; total work ~1.875x the single-pattern
   minimum, fully batched, zero branches), with per-candidate boundary
   overlaps gathered from static tables, and
2. **select per coefficient** which class's output is live for each
   stream's pattern (a [16, N] class map gathered by the pattern id).

The same trick drives the inverse transform: every candidate is
synthesized and accumulated under its activity mask.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from ulcx.ops.dct import dct4, dct4_dst4
from ulcx.ops.mdct import imdct_expand, mdct_fold, mdst_fold
from ulcx.ops.patterns import (
    pattern_subblock_offsets,
    pattern_subblock_sizes,
    pattern_transient_flags,
)
from ulcx.utils.config import CodecConfig

N_CLASSES = 4


def candidate_list():
    """[(class, position)] for all 15 candidate subblocks, stream order
    within a class; across classes ordered by class."""
    return [(c, i) for c in range(N_CLASSES) for i in range(1 << c)]


@lru_cache(maxsize=2)
def _cand_order() -> np.ndarray:
    """Total order of candidates by coefficient offset (N/8 units),
    class as tiebreak (co-active candidates always differ in offset)."""
    return np.array(
        [(i * (8 >> c)) * 4 + c for c, i in candidate_list()], np.int32
    )


@lru_cache(maxsize=8)
def candidate_tables(block_size: int):
    """Static per-pattern candidate tables.

    [16, 15] int32 arrays:
      act      — candidate present in pattern
      l_flag   — this subblock's transient flag (left overlap scaling)
      l_prev   — previous subblock's class shift, or -1 => use the
                 previous block's last subblock size (dynamic)
      r_shift  — next subblock's class shift, or -1 => next block's
                 leading overlap (dynamic)
      r_flag   — next subblock's transient flag
    plus class maps cls_coef [16, N] and cls_line [16, N/2].
    """
    n = block_size
    cands = candidate_list()
    ncand = len(cands)
    cand_idx = {ci: k for k, ci in enumerate(cands)}
    act = np.zeros((16, ncand), np.int32)
    l_flag = np.zeros((16, ncand), np.int32)
    l_prev = np.full((16, ncand), -1, np.int32)
    r_shift = np.full((16, ncand), -1, np.int32)
    r_flag = np.zeros((16, ncand), np.int32)
    cls_coef = np.zeros((16, n), np.int32)
    cls_line = np.zeros((16, n // 2), np.int32)
    for pat in range(16):
        pi = pat or 1
        sizes = pattern_subblock_sizes(pi, n)
        offs = pattern_subblock_offsets(pi, n)
        flags = pattern_transient_flags(pi)
        shifts = [int(np.log2(n // s)) for s in sizes]
        for s, (sz, off, fl, sh) in enumerate(zip(sizes, offs, flags, shifts)):
            k = cand_idx[(sh, off // sz)]
            act[pat, k] = 1
            l_flag[pat, k] = int(fl)
            if s > 0:
                l_prev[pat, k] = shifts[s - 1]
            if s + 1 < len(sizes):
                r_shift[pat, k] = shifts[s + 1]
                r_flag[pat, k] = int(flags[s + 1])
            cls_coef[pat, off : off + sz] = sh
            cls_line[pat, off // 2 : off // 2 + sz // 2] = sh
    return dict(
        act=act,
        l_flag=l_flag,
        l_prev=l_prev,
        r_shift=r_shift,
        r_flag=r_flag,
        cls_coef=cls_coef,
        cls_line=cls_line,
    )


def boundary_overlaps_batched(window_ctrl, prev_last_ss, next_overlap, cfg: CodecConfig):
    """Per-candidate (o_left, o_right) [..., 15] int32.

    Implements the overlap nominal + clamping rules of reference
    ulcDecoder.c:233-239 / ulcEncoder_BlockTransform.c:161-172 for all
    candidates at once. o_right of the last active candidate clamps the
    (dynamic) next-block overlap.
    """
    n = cfg.block_size
    t = candidate_tables(n)
    pat = window_ctrl >> 4
    scale = (window_ctrl & 0x7)[..., None]
    c_shift = jnp.asarray(np.array([c for c, _ in candidate_list()], np.int32))
    sizes = (n >> c_shift).astype(jnp.int32)

    l_flag = jnp.asarray(t["l_flag"])[pat]
    l_prev = jnp.asarray(t["l_prev"])[pat]
    r_shift = jnp.asarray(t["r_shift"])[pat]
    r_flag = jnp.asarray(t["r_flag"])[pat]

    l_nom = sizes >> jnp.where(l_flag == 1, scale, 0)
    prev_sz = jnp.where(
        l_prev >= 0, n >> jnp.maximum(l_prev, 0), prev_last_ss[..., None]
    )
    o_l = jnp.minimum(l_nom, prev_sz)

    r_nom = (n >> jnp.maximum(r_shift, 0)) >> jnp.where(r_flag == 1, scale, 0)
    r_nom = jnp.where(r_shift >= 0, r_nom, next_overlap[..., None])
    o_r = jnp.minimum(r_nom, sizes)
    return o_l, o_r


def _rise_dense(length: int, overlap):
    """Rise half-window computed per element: overlap [...] ->
    [..., length]."""
    o = overlap[..., None].astype(jnp.float32)
    j = jnp.arange(length, dtype=jnp.float32)
    start = jnp.float32(length / 2) - o / 2
    tt = (j - start + jnp.float32(0.5)) / o
    w = jnp.sin(jnp.float32(np.pi / 2) * jnp.clip(tt, 0.0, 1.0))
    return jnp.where(j < start, 0.0, jnp.where(j >= start + o, 1.0, w)).astype(
        jnp.float32
    )


def _rise_batched(length: int, overlap):
    """Batched rise half-window: overlap [...] -> [..., length].

    Overlaps only ever take the power-of-two values 1..length (overlap
    nominal rules, ulcEncoder_BlockTransform.c:161-172), so the dense
    per-element form — sin over a [batch, length] grid for every
    stream/candidate — is recomputed ~B x npos times for at most
    log2(length)+1 distinct rows. Compute the distinct rows once (same
    expressions, same bits) and select per stream with an exact one-hot
    f32 matmul (one nonzero per row)."""
    k = int(np.log2(length)) + 1
    cand = jnp.asarray(
        np.array([0] + [1 << i for i in range(k)], np.int32)
    )  # 0 occurs at stream starts and fully-shifted overlaps
    rows = _rise_dense(length, cand)  # [k+1, length]
    oh = (overlap[..., None] == cand).astype(jnp.float32)
    return jnp.matmul(oh, rows, precision=jax.lax.Precision.HIGHEST)


def _first_active(act):
    key = jnp.where(act == 1, jnp.asarray(_cand_order())[None], jnp.int32(1 << 20))
    return jnp.argmin(key, axis=-1)


def _last_active(act):
    key = jnp.where(act == 1, jnp.asarray(_cand_order())[None], jnp.int32(-1))
    return jnp.argmax(key, axis=-1)


def _next_active(act, ki: int):
    order = _cand_order()
    later = jnp.asarray((order > order[ki]).astype(np.int32))
    key = jnp.where(
        (act == 1) & (later[None] == 1), jnp.asarray(order)[None], jnp.int32(1 << 20)
    )
    return jnp.argmin(key, axis=-1)


def last_subblock_size(window_ctrl, cfg: CodecConfig):
    """Final subblock size of each block's pattern [..] i32 — what the
    NEXT block's overlap clamp sees (reference ulcDecoder.c:233-239).
    Depends only on window_ctrl, which is what lets the pipelined
    single-stream decoder batch the lap chain (decode_stream_pipelined):
    prev_last_ss for block t is just last_subblock_size(wc[t-1])."""
    t = candidate_tables(cfg.block_size)
    act = jnp.asarray(t["act"])[window_ctrl >> 4]
    shifts = jnp.asarray(np.array([c for c, _ in candidate_list()], np.int32))
    return (cfg.block_size >> shifts[_last_active(act)]).astype(jnp.int32)


def block_mdct_mdst_batched(samples, window_ctrl, prev_last_ss, next_overlap, cfg):
    """Batched forward transform: samples [B,C,2N] -> (mdct, mdst) [B,C,N]."""
    n = cfg.block_size
    b, c, _ = samples.shape
    t = candidate_tables(n)
    o_l, o_r = boundary_overlaps_batched(window_ctrl, prev_last_ss, next_overlap, cfg)

    outs_c, outs_s = [], []
    k = 0
    for cls in range(N_CLASSES):
        ss = n >> cls
        npos = 1 << cls
        frames = jnp.stack(
            [
                samples[..., n // 2 + i * ss - ss // 2 : n // 2 + i * ss + 3 * ss // 2]
                for i in range(npos)
            ],
            axis=2,
        )  # [B, C, npos, 2ss]
        wl = _rise_batched(ss, o_l[:, k : k + npos])
        wr = _rise_batched(ss, o_r[:, k : k + npos])[..., ::-1]
        win = jnp.concatenate([wl, wr], axis=-1)  # [B, npos, 2ss]
        z = frames * win[:, None]
        norm = jnp.float32(2.0 / ss)
        mc, ms = dct4_dst4(mdct_fold(z), mdst_fold(z), cfg.transform_for(ss))
        mc = -mc * norm
        ms = -ms * norm
        outs_c.append(mc.reshape(b, c, n))
        outs_s.append(ms.reshape(b, c, n))
        k += npos

    # per-coefficient class select: one-hot [B,16] matmul against the
    # static class map (values 0..3, exact in f32) + a 3-where chain,
    # in place of row gathers / a [B,C,N,4] take_along_axis.
    pat = window_ctrl >> 4
    oh = (pat[:, None] == jnp.arange(16)).astype(jnp.float32)
    cls_map = jnp.matmul(
        oh, jnp.asarray(t["cls_coef"], np.float32),
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)[:, None, :]  # [B, 1, N]
    mdct, mdst = outs_c[0], outs_s[0]
    for k in range(1, N_CLASSES):
        sel_k = cls_map == k
        mdct = jnp.where(sel_k, outs_c[k], mdct)
        mdst = jnp.where(sel_k, outs_s[k], mdst)
    return mdct, mdst


def block_imdct_batched(coefs, window_ctrl, lap, prev_last_ss, cfg):
    """Batched inverse: coefs [B,C,N] -> (pcm [B,C,N], new_lap, last_ss [B])."""
    n = cfg.block_size
    h = n // 2
    b, c, _ = coefs.shape
    t = candidate_tables(n)
    pat = window_ctrl >> 4
    act = jnp.asarray(t["act"])[pat]  # [B, 15]
    o_l, _ = boundary_overlaps_batched(
        window_ctrl, prev_last_ss, jnp.full_like(window_ctrl, n), cfg
    )

    ext = jnp.zeros((b, c, n + h), jnp.float32)

    # previous block's deferred-window contribution. The reshuffle of
    # the lap buffer (identity prefix / reversed middle / shifted tail
    # around f_split = h - prev_last_ss/2) is a data-dependent gather —
    # but prev_last_ss takes only the 4 subblock size classes, so it
    # becomes a 4-way select of statically sliced layouts instead of a
    # gather with [B,C,N] indices.
    # [B,16]->[B] index selects as where-sums (exact for these
    # small-int overlap values)
    _i16 = jnp.arange(o_l.shape[1], dtype=jnp.int32)[None, :]
    first_ol = jnp.sum(
        jnp.where(_i16 == _first_active(act)[:, None], o_l, 0), axis=-1
    )
    rlap = lap[..., ::-1]
    zfill = lambda k: jnp.zeros((b, c, k), jnp.float32)
    pc = jnp.zeros((b, c, n), jnp.float32)
    for cls in range(N_CLASSES):
        pls = n >> cls
        fs = h - pls // 2
        part = jnp.concatenate(
            [lap[..., :fs], rlap[..., : h - fs], lap[..., fs:], zfill(fs)],
            axis=-1,
        )
        pc = jnp.where((prev_last_ss == pls)[:, None, None], part, pc)
    w_prev = _rise_batched(n, first_ol)[..., ::-1]  # [B, N]
    pc = pc * w_prev[:, None]
    ext = ext.at[..., :n].add(pc)

    last_k = _last_active(act)
    shifts = jnp.asarray(np.array([cc for cc, _ in candidate_list()], np.int32))
    last_ss = (n >> shifts[last_k]).astype(jnp.int32)

    v_last = jnp.zeros((b, c, h), jnp.float32)
    k = 0
    for cls in range(N_CLASSES):
        ss = n >> cls
        npos = 1 << cls
        x = coefs.reshape(b, c, npos, ss)
        v = dct4(x, cfg.transform_for(ss))
        y = imdct_expand(v)  # [B, C, npos, 2ss]
        for i in range(npos):
            ki = k + i
            active = act[:, ki] == 1
            is_last = active & (last_k == ki)
            ol = o_l[:, ki]
            nxt = _next_active(act, ki)
            orr = jnp.sum(jnp.where(_i16 == nxt[:, None], o_l, 0), axis=-1)
            orr = jnp.minimum(orr, ss)  # guard inactive-garbage
            wl = _rise_batched(ss, ol)
            wr = _rise_batched(ss, orr)[..., ::-1]
            w_full = jnp.concatenate([wl, wr], axis=-1)
            w_last = jnp.concatenate([wl, jnp.zeros_like(wr)], axis=-1)
            w = jnp.where(is_last[:, None], w_last, w_full)
            w = jnp.where(active[:, None], w, 0.0)
            a = h + i * ss - ss // 2
            if i == npos - 1:
                # end-of-block candidate: always the last subblock; only
                # its first half is synthesized now (fits in ext)
                ext = ext.at[..., a : a + ss].add((y[:, :, i] * w[:, None])[..., :ss])
            else:
                ext = ext.at[..., a : a + 2 * ss].add(y[:, :, i] * w[:, None])
            vi = jnp.concatenate(
                [v[:, :, i, : ss // 2], jnp.zeros((b, c, h - ss // 2), jnp.float32)],
                axis=-1,
            )
            v_last = jnp.where(is_last[:, None, None], vi, v_last)
        k += npos

    out = ext[..., :n]
    j = jnp.arange(h)
    f_new = h - last_ss[:, None] // 2  # [B, 1]
    spill = ext[..., n : n + h]
    # v_last shifted right by f_new: 4-way class select of static
    # layouts instead of a [B,C,h]-indexed gather (see above)
    v_part = jnp.zeros((b, c, h), jnp.float32)
    for cls in range(N_CLASSES):
        pls = n >> cls
        fs = h - pls // 2
        part = jnp.concatenate(
            [jnp.zeros((b, c, fs), jnp.float32), v_last[..., : h - fs]], axis=-1
        )
        v_part = jnp.where((last_ss == pls)[:, None, None], part, v_part)
    new_lap = jnp.where(j[None, None] < f_new[:, None], spill, v_part)
    return out, new_lap, last_ss
