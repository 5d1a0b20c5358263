"""Block-level lapped transform choreography (both directions).

Wraps the frame-level MDCT/IMDCT (ulcx.ops.mdct) into whole-block
operations under window switching. The window-control word selects one
of 16 decimation patterns; since each pattern fixes every subblock size
and offset, we dispatch through ``lax.switch`` so that *within a branch
all shapes are static* — the batched replacement for the reference's
nybble-walking subblock loops (reference
libulc/ulcEncoder_BlockTransform.c:156-305, libulc/ulcDecoder.c:217-277).

Geometry recap (see ulcx/ops/mdct.py): fold centers tile the timeline
every SubBlockSize samples starting at the middle of the output block,
so for an encode call holding [prev block, new block] every subblock
frame is a static slice of those 2N samples — no forward lap buffer.
The decoder carries N/2 floats per channel: final "spill" samples plus
the last subblock's raw half-spectrum (windowed next call, once the
boundary overlap is known; reference FormatSpecs.md:157's clipping rule
is applied to both directions identically).

window_ctrl encoding (reference FormatSpecs.md:33-55):
  bits 0..2  overlap scale for the transient subblock
  bit  3     decimation toggle (window switch active)
  bits 4..7  decimation pattern index (1 when bit3 clear)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ulcx.ops.mdct import (
    frame_window,
    imdct_expand,
    imdct_halfspec,
    mdct_fold,
    mdst_fold,
    rise_window,
)
from ulcx.ops.dct import dct4, dct4_dst4
from ulcx.ops.patterns import (
    PATTERN_TABLE,
    pattern_subblock_offsets,
    pattern_subblock_sizes,
    pattern_transient_flags,
)
from ulcx.utils.config import CodecConfig

# Per-pattern static lookup tables for the *first* subblock (used to
# compute the next block's boundary overlap; reference
# ulcEncoder_BlockTransform.c:124-128).
_SHIFT0 = np.array([PATTERN_TABLE[i] & 0x7 for i in range(16)], np.int32)
_FLAG0 = np.array([(PATTERN_TABLE[i] >> 3) & 1 for i in range(16)], np.int32)


def first_overlap(window_ctrl: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Overlap a block requests at its leading boundary (pre-clamp)."""
    pat = window_ctrl >> 4
    scale = window_ctrl & 0x7
    sub = block_size >> jnp.take(jnp.asarray(_SHIFT0), pat)
    return sub >> jnp.where(jnp.take(jnp.asarray(_FLAG0), pat) == 1, scale, 0)


def last_subblock_size(window_ctrl: jnp.ndarray, block_size: int) -> jnp.ndarray:
    sizes = np.array(
        [pattern_subblock_sizes(i or 1, block_size)[-1] for i in range(16)], np.int32
    )
    return jnp.take(jnp.asarray(sizes), window_ctrl >> 4)


def _boundary_overlaps(pattern_idx: int, scale, prev_last_ss, block_size: int):
    """Per-subblock leading-boundary overlaps [list of traced scalars].

    overlap[s] blends subblock s with subblock s-1 (s=0: with the
    previous block's last subblock): nominal SS_s >> (scale if flagged),
    clipped to the previous [sub]block size (reference
    ulcDecoder.c:233-239 / ulcEncoder_BlockTransform.c:161-172).
    """
    sizes = pattern_subblock_sizes(pattern_idx, block_size)
    flags = pattern_transient_flags(pattern_idx)
    overlaps = []
    for s, (ss, fl) in enumerate(zip(sizes, flags)):
        o = (ss >> scale) if fl else jnp.asarray(ss, jnp.int32)
        prev = prev_last_ss if s == 0 else jnp.asarray(sizes[s - 1], jnp.int32)
        overlaps.append(jnp.minimum(jnp.asarray(o, jnp.int32), prev))
    return overlaps, sizes, list(pattern_subblock_offsets(pattern_idx, block_size))


# ---------------------------------------------------------------------------
# Forward: whole-block analysis transform.


def block_mdct_mdst(
    samples: jnp.ndarray,       # [..., C, 2N]  (prev block || new block)
    window_ctrl: jnp.ndarray,   # scalar int32
    prev_last_ss: jnp.ndarray,  # scalar int32 (previous block's last subblock)
    next_overlap: jnp.ndarray,  # scalar int32 (next block's leading overlap, pre-clamp)
    cfg: CodecConfig,
):
    """Returns (mdct [..., C, N], mdst [..., C, N]) normalized by 2/SS."""
    n = cfg.block_size
    scale = window_ctrl & 0x7

    def make_branch(pattern_idx: int):
        def branch(args):
            smp, sc, prev_ss, nxt = args
            overlaps, sizes, offsets = _boundary_overlaps(pattern_idx, sc, prev_ss, n)
            mdct_parts, mdst_parts = [], []
            for s, (ss, off) in enumerate(zip(sizes, offsets)):
                o_l = overlaps[s]
                o_r = (
                    overlaps[s + 1]
                    if s + 1 < len(sizes)
                    else jnp.minimum(nxt, ss)
                )
                a = n // 2 + off - ss // 2
                frame = lax.slice_in_dim(smp, a, a + 2 * ss, axis=-1)
                w = frame_window(ss, o_l, o_r)
                z = frame * w
                backend = cfg.transform_for(ss)
                norm = jnp.float32(2.0 / ss)
                mc, ms = dct4_dst4(mdct_fold(z), mdst_fold(z), backend)
                mdct_parts.append(-mc * norm)
                mdst_parts.append(-ms * norm)
            return (
                jnp.concatenate(mdct_parts, axis=-1),
                jnp.concatenate(mdst_parts, axis=-1),
            )

        return branch

    branches = [make_branch(i or 1) for i in range(16)]
    return lax.switch(
        window_ctrl >> 4,
        branches,
        (samples, scale, prev_last_ss, next_overlap),
    )


# ---------------------------------------------------------------------------
# Inverse: whole-block synthesis with carried lap state.


def block_imdct(
    coefs: jnp.ndarray,         # [..., C, N] decoded coefficients
    window_ctrl: jnp.ndarray,   # scalar int32
    lap: jnp.ndarray,           # [..., C, N/2] carried state
    prev_last_ss: jnp.ndarray,  # scalar int32
    cfg: CodecConfig,
):
    """Returns (pcm [..., C, N], new_lap [..., C, N/2], new_last_ss).

    Carried ``lap`` layout: first N/2 - S_p/2 entries are final 'spill'
    output samples, the rest is the previous last subblock's raw
    half-spectrum v[:S_p/2] (S_p = prev_last_ss, dynamic).
    """
    n = cfg.block_size
    h = n // 2
    scale = window_ctrl & 0x7

    def make_branch(pattern_idx: int):
        def branch(args):
            cf, lp, sc, prev_ss = args
            overlaps, sizes, offsets = _boundary_overlaps(pattern_idx, sc, prev_ss, n)
            batch = cf.shape[:-1]
            ext = jnp.zeros(batch + (n + h,), cf.dtype)

            # Previous block's contribution: spill + deferred-windowed tail.
            # Positions p in [0, N): index map into lap and fall-window by
            # the (dynamic) first boundary overlap.
            o0 = overlaps[0]
            f_split = h - prev_ss // 2
            p = jnp.arange(n)
            idx = jnp.where(
                p < f_split,
                p,
                jnp.where(p < h, f_split + h - 1 - p, f_split + p - h),
            )
            idx = jnp.clip(idx, 0, h - 1)
            w_prev = rise_window(n, o0)[::-1]  # falls around N/2, 1 before, 0 after
            prev_contrib = jnp.take(lp, idx, axis=-1) * w_prev
            prev_contrib = jnp.where(p < h + prev_ss // 2, prev_contrib, 0.0)
            ext = ext.at[..., :n].add(prev_contrib)

            v_last = None
            for s, (ss, off) in enumerate(zip(sizes, offsets)):
                x = lax.slice_in_dim(cf, off, off + ss, axis=-1)
                v = dct4(x, cfg.transform_for(ss))
                a = h + off - ss // 2
                if s + 1 < len(sizes):
                    y = imdct_expand(v)
                    w = frame_window(ss, overlaps[s], overlaps[s + 1])
                    ext = ext.at[..., a : a + 2 * ss].add(y * w)
                else:
                    # Last subblock: only the part left of its right fold
                    # center minus SS/2 is added now; v is carried raw.
                    y_head = imdct_expand(v)[..., :ss]
                    w = rise_window(ss, overlaps[s])
                    ext = ext.at[..., a : a + ss].add(y_head * w)
                    v_last = v

            ss_last = sizes[-1]
            out = ext[..., :n]
            spill = ext[..., n : n + h - ss_last // 2]
            new_lap = jnp.concatenate([spill, v_last[..., : ss_last // 2]], axis=-1)
            return out, new_lap, jnp.asarray(ss_last, jnp.int32)

        return branch

    return lax.switch(
        window_ctrl >> 4,
        [make_branch(i or 1) for i in range(16)],
        (coefs, lap, scale, prev_last_ss),
    )
