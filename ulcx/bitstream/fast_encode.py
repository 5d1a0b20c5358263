"""Kernel-backed encode pass: batched rate search + materialization.

Glue around ``ulcx.bitstream.pallas_encode3``: packs per-position inputs
(segment geometry, noise decisions, monotone importance keys) into the
kernel's planes, prices the per-segment tail tokens inside the kernel
walks, runs the interp-seeded candidate ladder (_bracket_search), and
assembles final byte streams.

Chosen by ``ulcx.utils.config.kernel_mode`` for P <= 32768 (the
reference's full block envelope, ulcEncoder.c:21); otherwise the scan
path (ulcx.bitstream.encode) is used. Batches are padded up to a
multiple of the kernel's lane width and the padding is sliced off.
Semantics: noise_run_window="segment" (see CodecConfig).
"""

from __future__ import annotations

from functools import lru_cache

import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ulcx.analysis.block import AnalyzedBlock
from ulcx.bitstream.encode import _build_quantizer
from ulcx.bitstream.tables import segment_tables
from ulcx.utils.config import CodecConfig


def _cq_unsigned(v):
    q = jnp.floor(jnp.float32(0.5) + jnp.sqrt(jnp.maximum(v - jnp.float32(0.25), 0.0)))
    return jnp.where(v >= 0.5, q, 0.0).astype(jnp.int32)


from typing import NamedTuple


class FastBlockData(NamedTuple):
    """Batched per-block kernel inputs ([B, ...]).

    HF-extension fit quantities are pairwise constant, so they are kept
    in the pseudo-DFT line domain [B, L] (L = P/2) and queried at
    position>>1 — half the traffic and half the gather source size."""

    coef: jnp.ndarray        # [B, P] f32
    aux: jnp.ndarray         # [B, P] i32: segdelta | seg_start << 16 | qi << 17
    key: jnp.ndarray         # [B, P] i32 monotone importance key
    amp_noise: jnp.ndarray   # [B, L] f32 noise amplitude (line domain)
    amp_lin: jnp.ndarray     # [B, L] f32 HF-ext amplitude (line domain)
    hf_meta: jnp.ndarray     # [B, L] i32: dec_q | hf_ok << 8 (line domain)
    window_ctrl: jnp.ndarray # [B]
    header: jnp.ndarray      # [B, 2]
    n_header: jnp.ndarray    # [B]


@lru_cache(maxsize=32)
def _prep_tables(block_size: int, n_chan: int):
    """Static per-pattern tables for the line-domain prepare pass.

    Returns (segdelta [16, P] f32, is_start [16, P] f32,
    end_line [16, L] f32, sel [16*G, L] f32) where L = P/2 lines and
    G = 8*n_chan slots on the N/16-line grid. All values are small
    integers, exactly representable in f32, so per-stream selection
    is an exact one-hot matmul.
    sel[k*G+g, l] = 1 iff pattern k's line l has its segment end at
    grid slot g — used to pick segment-end cumsum values.
    """
    n, c = block_size, n_chan
    p_tot = n * c
    nl = p_tot // 2
    n_grid = 8 * c
    grid_step = (n // 8) // 2
    starts, ends, _ = segment_tables(n, c)
    idxp = np.arange(p_tot)
    # segdelta is a segment LENGTH (bound by block_size): 16 bits holds
    # a full bs32768 block — field map in pallas_encode3's docstring
    segdelta = np.clip(ends - idxp, 0, 0xFFFF).astype(np.float32)
    is_start = (idxp == starts).astype(np.float32)
    end_line = (ends[:, 0::2] // 2).astype(np.int32)  # [16, L]
    end_slot = end_line // grid_step - 1  # [16, L] in [0, G)
    sel = np.zeros((16, n_grid, nl), np.float32)
    sel[
        np.arange(16)[:, None], end_slot, np.arange(nl)[None, :]
    ] = 1.0
    return (
        segdelta,
        is_start,
        end_line.astype(np.float32),
        sel.reshape(16 * n_grid, nl),
    )


def prepare_fast(blk: AnalyzedBlock, cfg: CodecConfig) -> FastBlockData:
    """Batched prep: blk fields have leading [B].

    Runs entirely in the pseudo-DFT *line* domain (L = P/2): every
    noise/HF quantity is constant within a coefficient pair (window
    ends are (n+(p&1)+1)>>1 = identical for both parities, segment
    bounds are even), so computing per line and expanding by a 2x
    repeat at the end halves the traffic. All per-pattern selection
    (segment ends, slot grid) is one-hot [B,16] matmuls against static
    tables — no gathers, no per-slot where-chains.
    """
    n, c = cfg.block_size, cfg.n_chan
    p_tot = n * c
    nl = p_tot // 2
    n_grid = 8 * c
    grid_step = (n // 8) // 2
    b = blk.mdct.shape[0]
    segdelta_t, isstart_t, endline_t, sel_t = _prep_tables(n, c)

    pat = blk.window_ctrl >> 4
    oh = (pat[:, None] == jnp.arange(16)).astype(jnp.float32)  # [B, 16]
    hi = jax.lax.Precision.HIGHEST

    coef = blk.mdct.reshape(b, p_tot)
    noise = blk.noise.reshape(b, p_tot)
    w = noise[:, 0::2]
    wy = noise[:, 1::2]
    g = jnp.arange(nl, dtype=jnp.float32)

    # 5 prefix sums in one shot: {w, w*y, w*g, w*g^2, w*y*g}.
    # Exclusive form kept LANE-ALIGNED ([B,5,L], not an L+1 concat —
    # the odd minor dimension forces relayout copies on every
    # downstream slice); the grand totals ride separately. All values
    # bit-identical to the L+1 form.
    stacked = jnp.stack([w, wy, w * g, w * g * g, wy * g], axis=1)
    incl = jnp.cumsum(stacked, axis=-1)  # [B, 5, L]
    cs = jnp.concatenate(
        [jnp.zeros((b, 5, 1), jnp.float32), incl[:, :, :-1]], axis=-1
    )  # [B, 5, L] exclusive
    tot = incl[:, :, -1:]  # [B, 5, 1]

    # segment-end cumsum values: grid slot values (strided slice; the
    # last grid boundary is the grand total) are selected per line via
    # sel (exactly one nonzero term per output, so the f32 matmul is
    # exact)
    gv = jnp.concatenate(
        [cs[:, :, grid_step :: grid_step][:, :, : n_grid - 1], tot], axis=-1
    )  # [B, 5, G]
    y = (oh[:, None, :, None] * gv[:, :, None, :]).reshape(b, 5, 16 * n_grid)
    seg_vals = jnp.matmul(y, jnp.asarray(sel_t), precision=hi)  # [B, 5, L]

    end_line = jnp.matmul(oh, jnp.asarray(endline_t), precision=hi)  # [B, L]
    cw_a, cwy_a = cs[:, 0], cs[:, 1]
    cw_end, cwy_end = seg_vals[:, 0], seg_vals[:, 1]

    # noise amplitude window = min(line + 264, segment end): resolved
    # on indices; the +264 branch is a static shifted slice
    in_window = (g + 264.0) < end_line

    take = max(0, nl - 264)  # lines where l+264 is an in-range index

    def shifted(j):
        return jnp.concatenate(
            [cs[:, j, 264:], jnp.broadcast_to(tot[:, j], (b, nl - take))],
            axis=-1,
        )

    s_w = jnp.where(in_window, shifted(0), cw_end) - cw_a
    s_wy = jnp.where(in_window, shifted(1), cwy_end) - cwy_a
    amp = jnp.exp(s_wy / jnp.where(s_w > 0, s_w, 1.0))
    # amp is candidate-independent; the (candidate-dependent) zone
    # quantizer is folded in inside the kernel: nq = cq(amp * 2^q_ev)
    amp_noise_l = jnp.where(s_wy != 0.0, amp, 0.0)

    # HF-extension least-squares (candidate independent; window = tail)
    af = g
    sw = cw_end - cw_a
    swy = cwy_end - cwy_a
    swg = seg_vals[:, 2] - cs[:, 2, :nl]
    swg2 = seg_vals[:, 3] - cs[:, 3, :nl]
    swyg = seg_vals[:, 4] - cs[:, 4, :nl]
    sx = 2.0 * (swg - af * sw)
    sx2 = 4.0 * (swg2 - 2.0 * af * swg + af * af * sw)
    sxy = 2.0 * (swyg - af * swy)
    det = sw * sx2 - sx * sx
    solvable = det != 0.0
    det_s = jnp.where(solvable, det, 1.0)
    amp_log = (sx2 * swy - sx * sxy) / det_s
    dec_log = (sw * sxy - sx * swy) / det_s
    amp_lin_l = jnp.exp(amp_log)
    dec_lin = jnp.where(dec_log < 0, jnp.exp(dec_log), 1.0)
    dec_raw = _cq_unsigned((dec_lin - 1.0) * np.float32(-(2.0**19)))
    hf_ok_l = solvable & (dec_raw > 0)
    dec_q_l = jnp.minimum(dec_raw, 255)

    # all amplitude/HF quantities stay in the line domain (see
    # FastBlockData); the v3 kernels read them at lp >> 1 and the
    # v1/v2 dispatch expands by a 2x repeat
    hf_meta = dec_q_l | (hf_ok_l.astype(jnp.int32) << 8)

    segdelta = jnp.matmul(oh, jnp.asarray(segdelta_t), precision=hi).astype(
        jnp.int32
    )
    is_seg_start = jnp.matmul(oh, jnp.asarray(isstart_t), precision=hi).astype(
        jnp.int32
    )
    # the zone quantizer of each |coef| (BuildQuantizer) rides in aux
    # so the kernels need no log (pallas_encode3 module docstring)
    qa = _build_quantizer(jnp.abs(coef))
    aux = segdelta | (is_seg_start << 16) | (qa << 17)
    # monotone importance key: the kernels test keep-membership against
    # per-candidate (t, c) thresholds fetched from ONE sorted copy of
    # this key (pallas_encode3 module docstring) — no per-position rank
    # (and so no inverse-permutation sort) is ever materialized
    from ulcx.ops.keys import monotone_i32

    key = monotone_i32(blk.importance.reshape(b, p_tot))

    wc = blk.window_ctrl
    header = jnp.stack([wc & 0xF, (wc >> 4) & 0xF], axis=-1).astype(jnp.int32)
    n_header = jnp.where((wc & 0x8) != 0, 2, 1).astype(jnp.int32)

    return FastBlockData(
        coef, aux, key, amp_noise_l, amp_lin_l, hf_meta, wc, header, n_header
    )


def _lanes(b: int, interpret: bool) -> int:
    """Streams per kernel program. Compiled: the tuned pe3.LANES. The
    interpreter's cost is per sequential step, so interpret mode runs
    the whole (padded) batch as one program."""
    from ulcx.bitstream import pallas_encode3 as pe3

    if interpret:
        return -(-b // pe3.LANES) * pe3.LANES
    return pe3.LANES


def _pad_to(x, bp: int, fill=0):
    """Pad the leading (stream) axis of x to bp with `fill`."""
    b = x.shape[0]
    if bp == b:
        return x
    return jnp.concatenate(
        [x, jnp.full((bp - b,) + x.shape[1:], fill, x.dtype)], axis=0
    )


def _pad_fb(fb: FastBlockData, bp: int) -> FastBlockData:
    """Zero-pad every per-stream array of fb to bp streams. Zero planes
    parse as segdelta 0 / no segment starts: the walks stay finite and
    the outputs are sliced off."""
    return FastBlockData(*(_pad_to(x, bp) for x in fb))


def _to_lanes3(x, lanes: int):
    """[B, P] -> [G, P, 1, lanes]: stream = g*lanes + lane. NO candidate
    replication — the kernel broadcasts over the candidate rows."""
    g = x.shape[0] // lanes
    return x.reshape(g, lanes, -1).transpose(0, 2, 1)[:, :, None, :]


def _cand_to_b(x):
    """[G, N_CAND, L] -> [B, N_CAND]."""
    return x.transpose(0, 2, 1).reshape(-1, x.shape[1])


def _cand_to_lanes(x, lanes: int):
    """[B, N_CAND] -> [G, N_CAND, lanes]."""
    return x.reshape(-1, lanes, x.shape[1]).transpose(0, 2, 1)


class _V3Planes(NamedTuple):
    """Lane-transposed kernel input planes ([G, P(/2), 1, L] etc.).

    Built ONCE per encode; every ladder round reuses them. skey/sidx
    are the (importance-key desc, position asc) sorted copies every
    round's per-candidate keep thresholds gather from — ONE 2-operand
    sort per encode stands in for per-position ranks."""

    coef_l: jnp.ndarray
    thr_l: jnp.ndarray
    aux_l: jnp.ndarray
    key_l: jnp.ndarray
    skey: jnp.ndarray   # [B, P] keys, stable-descending per stream
    sidx: jnp.ndarray   # [B, P] their positions
    ampn_l: jnp.ndarray
    hfa_l: jnp.ndarray
    hfm_l: jnp.ndarray
    hdr_l: jnp.ndarray
    lanes: int
    p_tot: int


def _qmin_ge(m, thr_kind: str):
    """Smallest integer q in [0, 63] with m * 2**q >= threshold,
    exactly, from the f32 bit pattern (63 = never within q <= 31).

    Multiplying by 2**q only shifts the exponent (exact in f32 until
    overflow, and boundary cases are never denormal), so the kernel
    tests cq_unsigned(m * 2**q) >= {1, 2} and their kin collapse to
    integer compares q >= qmin(m):
      cq_unsigned(v) >= 1  <=>  v >= 0.5
      cq_unsigned(v) >= 2  <=>  v >= 2.5   (floor(0.5+sqrt(v-.25)) >= 2)
    With m = mant * 2**em (mant in [1, 2)):
      m >= 2.5 * 2**-q = 1.25*2**(1-q)  <=>  q >= (1 if mant>=1.25 else 2) - em
      m >= 0.5 * 2**-q = 2**(-1-q)      <=>  q >= -1 - em
      m >= 0.125 * 2**-q                <=>  q >= -3 - em
    Zeros/denormals get em <= -127 -> qmin clips to 63 ("never"),
    matching the true test (their product stays far below threshold)."""
    bits = lax.bitcast_convert_type(m.astype(jnp.float32), jnp.int32) & 0x7FFFFFFF
    em = ((bits >> 23) & 0xFF) - 127
    if thr_kind == "2.5":
        q = jnp.where((bits & 0x7FFFFF) >= 0x200000, 1 - em, 2 - em)
    elif thr_kind == "0.5":
        q = -1 - em
    elif thr_kind == "0.125":
        q = -3 - em
    else:  # pragma: no cover
        raise ValueError(thr_kind)
    return jnp.clip(jnp.where(bits == 0, 63, q), 0, 63)


def _thr_plane_l(coef_l, ampn_l, hfa_l, hfm_l):
    """Packed per-position threshold plane for the size-only kernel
    walks (field layout documented above pallas_encode3._p2). Built in
    lane layout from the already-transposed planes — elementwise plus a
    position shift and a pair->position repeat, so no extra
    [B, P] -> lane transpose."""
    qm0 = _qmin_ge(jnp.abs(coef_l), "2.5")          # [G, P, 1, L]
    qm1 = jnp.concatenate([qm0[:, 1:], qm0[:, -1:]], axis=1)
    qmn = jnp.repeat(_qmin_ge(ampn_l, "0.5"), 2, axis=1)
    qmh = jnp.repeat(_qmin_ge(hfa_l, "0.125"), 2, axis=1)
    hfok = jnp.repeat((hfm_l >> 8) & 1, 2, axis=1)
    return (
        qm0 | (qm1 << 6) | (qmn << 12) | (qmh << 18) | (hfok << 24)
    ).astype(jnp.int32)


def _v3_planes(fb: FastBlockData, lanes: int) -> _V3Planes:
    from ulcx.bitstream import pallas_encode3 as pe3

    b, p_tot = fb.coef.shape
    hdrw = fb.header[:, 0] | (fb.header[:, 1] << 4) | (fb.n_header << 8)
    hdr_l = jnp.broadcast_to(
        hdrw.reshape(b // lanes, 1, lanes), (b // lanes, pe3.N_CAND, lanes)
    )
    coef_l = _to_lanes3(fb.coef, lanes)
    ampn_l = _to_lanes3(fb.amp_noise, lanes)
    hfa_l = _to_lanes3(fb.amp_lin, lanes)
    hfm_l = _to_lanes3(fb.hf_meta, lanes)
    # stable (key desc, position asc) sort, once per encode. ~key is
    # strictly order-reversing on i32, so an ASCENDING stable sort of
    # ~key is exactly the descending key order with position-ascending
    # ties.
    iota = jax.lax.broadcasted_iota(jnp.int32, fb.key.shape, 1)
    skinv, sidx = jax.lax.sort((~fb.key, iota), dimension=1, num_keys=1)
    return _V3Planes(
        coef_l,
        _thr_plane_l(coef_l, ampn_l, hfa_l, hfm_l),
        _to_lanes3(fb.aux.astype(jnp.int32), lanes),
        _to_lanes3(fb.key, lanes),
        ~skinv,
        sidx,
        ampn_l,
        hfa_l,
        hfm_l,
        hdr_l,
        lanes,
        p_tot,
    )


def _tc_of(pl3: _V3Planes, nn):
    """Per-candidate keep thresholds for candidate counts nn
    [G, N_CAND, L]: (t, c) = the nn-th entry of the sorted (key desc,
    pos asc) order, so the kernels' `key > t | (key == t & p <= c)`
    equals `stable-desc rank < nn` bit-exactly, ties included.
    nn <= 0 maps to an unreachable threshold (keep nothing)."""
    nb = _cand_to_b(nn)
    j = jnp.clip(nb - 1, 0, pl3.p_tot - 1)
    t = jnp.take_along_axis(pl3.skey, j, axis=1)
    c = jnp.take_along_axis(pl3.sidx, j, axis=1)
    none = nb <= 0
    t = jnp.where(none, jnp.int32(2**31 - 1), t)
    c = jnp.where(none, jnp.int32(-1), c)
    return _cand_to_lanes(t, pl3.lanes), _cand_to_lanes(c, pl3.lanes)


def _v3_call_l(pl3: _V3Planes, nout_l, materialize=False, interpret=False):
    """Lane-native round: nout_l [G, N_CAND, L] i32 (candidate in row,
    stream in lane); outputs stay in kernel layout — the ladder keeps
    ALL its state in this layout, so no per-round relayout happens."""
    from ulcx.bitstream import pallas_encode3 as pe3

    t, c = _tc_of(pl3, nout_l)
    return pe3.encode_kernel_call3(
        t, c, pl3.key_l, pl3.coef_l, pl3.thr_l, pl3.ampn_l, pl3.aux_l,
        pl3.hfa_l, pl3.hfm_l, pl3.hdr_l, pl3.p_tot, materialize, interpret,
    )


def _v3_sizes(pl3: _V3Planes, n_header, nout, interpret=False):
    """Byte-rounded bit sizes [B, N_CAND] for candidates nout [B, N_CAND]
    (tails included)."""
    (bits,) = _v3_call_l(pl3, _cand_to_lanes(nout, pl3.lanes), False,
                         interpret)
    total = 4 * (_cand_to_b(bits) + n_header[:, None])
    return (total + 7) & ~7


def total_sizes(fb: FastBlockData, nout, cfg: CodecConfig, interpret=False):
    """Byte-aligned block sizes in bits for candidates nout [B, K]."""
    b = fb.coef.shape[0]
    lanes = _lanes(b, interpret)
    bp = -(-b // lanes) * lanes
    fbp = _pad_fb(fb, bp)
    return _v3_sizes(
        _v3_planes(fbp, lanes), fbp.n_header, _pad_to(nout, bp), interpret
    )[:b]


# --- interp-seeded ladder schedule -----------------------------------------
#
# The classic k-candidate ladder needs ceil(log_k P) size rounds to pin
# the largest feasible n exactly; each round is a full serial kernel
# walk over P positions. Measured on
# the bench corpus (devtools/search_seed_study.py, bs2048 stereo
# CBR-128): after ONE coarse round, linearly interpolating the bracket
# edge sizes predicts the budget crossing within |err| p50=7 p90=16
# p99=36 max=41 coefficients. So the middle rounds collapse to ONE
# round of candidates spread around the prediction, and the final
# round stretches its spacing to cover whatever bracket remains:
# exact whenever the remaining bracket is < k (the common case), at
# worst ceil(bracket/(k-1))-1 ≈ 2-5 coefficients short of the true
# maximum in the interp-miss tail — never infeasible. Rate-control
# contract unchanged: chosen size <= budget always.

# Seeded-round offsets in 1/256ths of the bracket gap (applied as
# (gap * W) >> 8). Gap-proportional spread because the interpolation
# error scales with the bracket and its BIAS scales with the curve's
# local convexity, which grows at low rates: measured |err| p99 is
# ~7% of the gap at 128 kbps but ~15% (all positive-signed) at
# 48 kbps (devtools/search_seed_study.py) — a fixed span misses there.
_SEED_W = {
    8: np.array([-51, -31, -18, -9, -4, 0, 5, 15], np.int32),
    16: np.array(
        [-64, -51, -40, -31, -23, -16, -10, -6, -3, 0, 2, 5, 9, 14, 21, 30],
        np.int32,
    ),
}


def _seed_plan(rounds: int):
    """(classic_size_rounds, use_seeded_round) before the final round.

    ONE classic round suffices at every P: the seeded round's
    gap-proportional spread covers the interpolation error even when
    the bracket is the full first-round step (P/8). Measured at bs4096
    (devtools/search_seed_study.py 48 4096, classic->seeded->final
    emulation): interp |err| max 64 vs a seeded span of ~0.32*gap;
    final selection lands exact 39% / p50 -1 / worst -5 coefficients
    of n_true p50 1219 — inside the <=1%-under contract. This drops a
    full size round (p1+p2 state rebuild + p3-size walk) at
    rounds >= 5 shapes (P >= 8192: stereo bs4096+, mono bs8192+)."""
    if rounds - 1 < 2:
        return rounds - 1, False
    return 1, True


def _bracket_search(size_fn, n_nz, budget, k: int, rounds: int):
    """Classic + interp-seeded ladder rounds; returns (lo, hi) with the
    crossing bracketed and lo = best known-feasible count (or 0).

    Layout-generic: n_nz/budget are [B] or [G, L]; candidates ride
    axis 1 (size_fn maps candidate grids to byte-rounded bit sizes of
    the same shape). All arithmetic is int32 so the flat and
    lane-layout callers produce bit-identical brackets.

    The rounds are unrolled in Python; ULCX_LADDER_SCAN=1 runs them as
    ONE lax.scan over a per-round is_seeded flag instead (the seeded
    round falls back to the classic grid when seed_ok is false, so the
    bodies unify exactly). Bit-identical brackets."""
    classic, seeded = _seed_plan(rounds)
    x1 = lambda a: jnp.expand_dims(a, 1)
    kshape = (1, k) + (1,) * (n_nz.ndim - 1)
    karr1 = jnp.arange(1, k + 1, dtype=jnp.int32).reshape(kshape)
    jidx = jnp.arange(k, dtype=jnp.int32).reshape(kshape)
    bud = x1(budget)
    lo = jnp.zeros(n_nz.shape, jnp.int32)
    hi = n_nz.astype(jnp.int32)
    s_lo = gap = jnp.zeros(n_nz.shape, jnp.int32)
    den = jnp.ones(n_nz.shape, jnp.int32)
    seed_ok = jnp.zeros(n_nz.shape, bool)

    def update(cands, cands_c, sizes, lo, hi):
        feas = (sizes <= bud) & (cands <= x1(hi))
        any_f = jnp.any(feas, axis=1)
        best = jnp.max(jnp.where(feas, cands_c, x1(lo)), axis=1)
        fbad = jnp.min(
            jnp.where(feas | (cands > x1(hi)), jnp.int32(2**30), cands), axis=1
        )
        # bracket-edge sizes for the interpolation (one-hot selects:
        # candidates ascend, so the max feasible index holds the max
        # feasible value and the min infeasible index the min)
        bestj = jnp.max(jnp.where(feas, jidx, -1), axis=1)
        badj = jnp.min(
            jnp.where(feas | (cands > x1(hi)), jnp.int32(k), jidx), axis=1
        )
        s_lo = jnp.sum(jnp.where(jidx == x1(bestj), sizes, 0), axis=1)
        s_hi = jnp.sum(jnp.where(jidx == x1(badj), sizes, 0), axis=1)
        new_lo = jnp.where(any_f, best, lo)
        new_hi = jnp.minimum(hi, fbad - 1)
        ok = any_f & (fbad < 2**30) & (fbad > new_lo)
        return (
            new_lo,
            new_hi,
            s_lo,
            fbad - new_lo,
            jnp.maximum(s_hi - s_lo, 1),
            ok,
        )

    w = jnp.asarray(_SEED_W[k]).reshape(kshape)

    def round_body(carry, is_seeded):
        lo, hi, s_lo, gap, den, seed_ok = carry
        step = jnp.maximum((hi - lo + k - 1) // k, 1)
        std = x1(lo) + x1(step) * karr1
        n_star = jnp.clip(
            lo + (budget - s_lo) * gap // den, lo, jnp.maximum(hi, lo)
        )
        off = (x1(gap) * w) >> 8
        sc = jnp.clip(x1(n_star) + off, x1(lo), x1(jnp.maximum(hi, lo)))
        cands = jnp.where(x1(seed_ok & is_seeded), sc, std)
        cands_c = jnp.minimum(cands, x1(jnp.maximum(hi, 0)))
        sizes = size_fn(cands_c)
        return update(cands, cands_c, sizes, lo, hi), None

    flags_py = [False] * classic + ([True] if seeded else [])
    carry = (lo, hi, s_lo, gap, den, seed_ok)
    if os.environ.get("ULCX_LADDER_SCAN", "0") == "1":
        carry, _ = lax.scan(round_body, carry, jnp.asarray(flags_py))
        return carry[0], carry[1]
    for f in flags_py:
        carry, _ = round_body(carry, jnp.asarray(f))
    return carry[0], carry[1]


def _final_cands(lo, hi, k: int):
    """Final-round candidate grid lo + s*(0..k-1): spacing s stretches
    to cover the remaining bracket (s = 1 -> exact max-feasible)."""
    x1 = lambda a: jnp.expand_dims(a, 1)
    hi_c = jnp.maximum(hi, lo)
    s = jnp.maximum(1, -(-(hi_c - lo) // (k - 1)))
    kshape = (1, k) + (1,) * (lo.ndim - 1)
    jidx = jnp.arange(k, dtype=jnp.int32).reshape(kshape)
    cands = x1(lo) + x1(s) * jidx
    cands_c = jnp.minimum(cands, x1(hi_c))
    return cands, cands_c, hi_c


def rate_search_fast(fb: FastBlockData, n_nz, budget, cfg: CodecConfig,
                     interpret=False):
    """Interp-seeded ladder on the kernel (cf. _cbr_search_ladder);
    candidate-for-candidate identical to search_materialize_fast so the
    fused and separate forms return the same n."""
    import math

    from ulcx.bitstream import pallas_encode3 as pe3

    b, p_tot = fb.coef.shape
    k = pe3.N_CAND
    lanes = _lanes(b, interpret)
    bp = -(-b // lanes) * lanes
    fbp = _pad_fb(fb, bp)
    pl3 = _v3_planes(fbp, lanes)
    size_fn = lambda nn: _v3_sizes(pl3, fbp.n_header, nn, interpret)
    rounds = max(1, int(math.ceil(math.log(p_tot, k))))
    budget = _pad_to(budget.astype(jnp.int32), bp)
    n_nz = _pad_to(n_nz, bp)
    lo, hi = _bracket_search(size_fn, n_nz, budget, k, rounds)
    cands, cands_c, hi_c = _final_cands(lo, hi, k)
    sizes = size_fn(cands_c)
    # clipped candidates equal hi_c (in-bracket) and stay selectable —
    # no cands <= hi_c gate here, unlike the bracketing rounds
    feas = sizes <= budget[:, None]
    feas = feas.at[:, 0].set(True)  # lane 0 = lo, always a fallback
    return jnp.max(jnp.where(feas, cands_c, lo[:, None]), axis=-1)[:b]


def _assemble_words(word, widx, freg, fwc, max_bytes: int):
    """Place in-kernel-packed stream words into byte streams: word/widx
    [G, P, L] (the emitted u32 word at each position; index 2**30 where
    no word completed), freg/fwc [G, L]; returns bytes
    [G*L, max_bytes]. Word indices of valid entries are exactly
    0..fwc-1, so one scatter places every completed word; the final
    partial register is appended at index fwc."""
    g, p_tot, lanes = word.shape
    b = g * lanes
    n_words = (2 * max_bytes) // 8
    to_b = lambda x: x.transpose(0, 2, 1).reshape(b, -1)
    rows = jnp.arange(b)[:, None]
    words = jnp.zeros((b, n_words), jnp.int32)
    words = words.at[rows, to_b(widx)].set(to_b(word), mode="drop")
    fwc_b, freg_b = fwc.reshape(b), freg.reshape(b)
    words = words.at[jnp.arange(b), fwc_b].set(freg_b, mode="drop")
    sh = jnp.arange(4) * 8
    by = ((words[:, :, None] >> sh[None, None, :]) & 0xFF).astype(jnp.uint8)
    return by.reshape(b, 4 * n_words)


def materialize_fast(fb: FastBlockData, n_out, cfg: CodecConfig, max_bytes: int,
                     interpret=False):
    """Assemble byte streams for chosen n_out [B]. Returns
    (size_bits [B], bytes [B, max_bytes])."""
    from ulcx.bitstream import pallas_encode3 as pe3

    b_in = fb.coef.shape[0]
    lanes = _lanes(b_in, interpret)
    bp = -(-b_in // lanes) * lanes
    fb = _pad_fb(fb, bp)
    g = bp // lanes
    nout_l = jnp.broadcast_to(
        _pad_to(n_out, bp).astype(jnp.int32).reshape(g, 1, lanes),
        (g, pe3.N_CAND, lanes),
    )
    bits_l, word_l, widx_l, freg_l, fwc_l = _v3_call_l(
        _v3_planes(fb, lanes), nout_l, True, interpret
    )
    size_bits = (4 * (bits_l[:, 0, :].reshape(bp) + fb.n_header) + 7) & ~7
    by = _assemble_words(
        word_l[:, :, 0, :], widx_l[:, :, 0, :], freg_l[:, 0, :],
        fwc_l[:, 0, :], max_bytes,
    )
    return size_bits[:b_in], by[:b_in]


def search_materialize_fast(fb: FastBlockData, n_nz, budget, cfg: CodecConfig,
                            max_bytes: int, interpret=False):
    """CBR/ABR: interp-seeded ladder rate search with the final round
    fused into materialization (the kernel prices and packs every
    candidate row; the best feasible row's stream is selected).
    Returns (n_out [B], size_bits [B], bytes [B, max_bytes])."""
    import math

    from ulcx.bitstream import pallas_encode3 as pe3

    b_in, p_tot = fb.coef.shape
    lanes = _lanes(b_in, interpret)
    bp = -(-b_in // lanes) * lanes
    fb = _pad_fb(fb, bp)
    g = bp // lanes
    k = pe3.N_CAND
    rounds = max(1, int(math.ceil(math.log(p_tot, k))))

    # the whole ladder runs in KERNEL LAYOUT ([G, cand-row,
    # stream-lane]): bracket state, candidate grids, feasibility and
    # the final select never round-trip through [B, k]
    pl3 = _v3_planes(fb, lanes)
    as_l = lambda x: _pad_to(x, bp).astype(jnp.int32).reshape(g, lanes)
    bud = as_l(budget)[:, None, :]
    nh_l = fb.n_header.reshape(g, lanes)[:, None, :]
    size_fn_l = lambda nn: (
        4 * (_v3_call_l(pl3, nn, False, interpret)[0] + nh_l) + 7
    ) & ~7
    lo, hi = _bracket_search(size_fn_l, as_l(n_nz), as_l(budget), k, rounds)

    # final round: adaptive-spacing candidates, fused with
    # materialization
    cands, cands_c, hi_c = _final_cands(lo, hi, k)
    bits_l, word_l, widx_l, freg_l, fwc_l = _v3_call_l(
        pl3, cands_c, True, interpret
    )
    sizes = (4 * (bits_l + nh_l) + 7) & ~7
    # clipped candidates equal hi_c (in-bracket): selectable
    feas = sizes <= bud
    feas = feas.at[:, 0, :].set(True)  # row 0 = lo, always a fallback
    jidx = jnp.arange(k)[None, :, None]
    best_j = jnp.max(jnp.where(feas, jidx, 0), axis=1)  # [G, L]

    def sel_l(x):
        # k-way row select by best_j
        if x.ndim == 3:  # [G, k, L]
            out = x[:, 0]
            for j in range(1, k):
                out = jnp.where(best_j == j, x[:, j], out)
            return out
        out = x[:, :, 0]  # [G, P, k, L]
        for j in range(1, k):
            out = jnp.where((best_j == j)[:, None, :], x[:, :, j], out)
        return out

    n_out = sel_l(cands_c).reshape(bp)
    size_bits = sel_l(sizes).reshape(bp)
    by = _assemble_words(
        sel_l(word_l), sel_l(widx_l), sel_l(freg_l), sel_l(fwc_l), max_bytes,
    )
    return n_out[:b_in], size_bits[:b_in], by[:b_in]
