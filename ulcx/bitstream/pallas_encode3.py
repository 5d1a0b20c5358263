"""Encode-pass kernels (Pallas, Triton route): streams x 8 candidates.

Each program owns LANES streams and walks every coefficient position
of its streams in one loop, the carries held in registers:

  lanes (LANES)   = distinct streams        -> inputs are [G, P, 1, LANES],
  rows (N_CAND)   = rate-search candidates     read ONCE per stream and
                                               broadcast across the rows

The grid is the stream-group axis G only. Positions are never split
across programs, so no carry crosses a program boundary (programs run
in parallel and in no order). State arrays stay per-(candidate,
stream): [G, P, N_CAND, LANES]. LANES is a power of two (Triton block
shapes are); the batch is padded up to a multiple of it by the
fast_encode glue.

Keep test: the reference keeps a coefficient when its importance RANK
is below the candidate count (heapsort ranks,
ulcEncoder_BlockTransform.c:349-355). The kernels test the equivalent
stable-descending-order predicate directly:

  kept(p, n)  <=>  key[p] > t_n  |  (key[p] == t_n  &  p <= c_n)

where key = order-preserving monotone i32 of the importance (±0.0
squashed, NaNs collapsed below -inf — ops/keys.monotone_i32) and
(t_n, c_n) = the n-th entry of ONE (key desc, idx asc) sort, fetched
per candidate. Bit-identical to rank < n, ties included.

Field widths (P = n_chan * block_size <= 32768 — the reference's full
BLOCK envelope incl. mono bs32768, ulcEncoder.c:21; many-channel shapes
past P=32768 take the scan path):
  aux:   segment length 16 bits [0..15] (a full bs32768 block =
         32768 = 0x8000), seg-start bit 16, quantizer of |coef[p]|
         5 bits [17..21]
  state: next-coded-pos 16 bits [0..15] (sentinel 65535 > P-1),
         quantizer 5 bits [16..20], coded bit 21

The kernels do no transcendental math: the zone quantizer of a
coefficient (BuildQuantizer, a log2) arrives precomputed in aux, and
companded quantization compares against exact thresholds or uses the
correctly rounded sqrt. So they are byte-identical to the scan path
(ulcx.bitstream.encode) on every backend.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ulcx.bitstream.encode import _cq_unsigned, _exp2i

N_CAND = 8     # rows: candidates
LANES = 2      # streams per program (power of two; fastest of 2-16 on an H100)
UNROLL = 4     # positions per loop trip (P is a multiple of 256)

SENT = np.int32(1 << 20)  # "no position" sentinel (> any p)


def _walk(n: int, body, carry, reverse: bool = False):
    """body(p, carry) for p = 0..n-1 (n-1..0 with reverse), UNROLL
    positions per trip of one in-kernel loop."""

    def trip(i, c):
        for u in range(UNROLL):
            k = i * UNROLL + u
            c = body(n - 1 - k if reverse else k, c)
        return c

    return lax.fori_loop(0, n // UNROLL, trip, carry)


# ---------------------------------------------------------------------------
# Phase 1: forward zone scan.
#
# The backward pass only ever consumes the *quantizer index* of the
# running zone maximum plus the 1-bit split flag, so phase 1 emits
# qi|split<<5 in ONE i32 plane. The running maximum is always either a
# reset value or some |coef[p]|, so its quantizer is carried beside it
# and taken from aux's precomputed field whenever the maximum moves.


def _p1(t_ref, c_ref, key_ref, coef_ref, aux_ref, s12_ref, *, p_tot: int):
    t = t_ref[...]
    c = c_ref[...]

    def body(p, carry):
        qmin, qmax, qi = carry
        a = jnp.abs(coef_ref[p])          # (1, LANES) -> broadcasts
        aux = aux_ref[p]
        key = key_ref[p]
        segstart = ((aux >> 16) & 1) == 1
        qa = (aux >> 17) & 0x1F
        kept = (key > t) | ((key == t) & (p <= c))
        qmin = jnp.where(segstart, jnp.float32(1000.0), qmin)
        qmax = jnp.where(segstart, jnp.float32(-1000.0), qmax)
        qi = jnp.where(segstart, 31, qi)
        nmin = jnp.minimum(qmin, a)
        nmax = jnp.maximum(qmax, a)
        split = kept & (nmax > nmin * 4.0)
        qi = jnp.where(kept & (split | (a > qmax)), qa, qi)
        qmin = jnp.where(kept, jnp.where(split, a, nmin), qmin)
        qmax = jnp.where(kept, jnp.where(split, a, nmax), qmax)
        s12_ref[p] = qi | (split.astype(jnp.int32) << 5)
        return qmin, qmax, qi

    init = (
        jnp.full(t.shape, 1000.0, jnp.float32),
        jnp.full(t.shape, -1000.0, jnp.float32),
        jnp.full(t.shape, 31, jnp.int32),
    )
    _walk(p_tot, body, init)


# ---------------------------------------------------------------------------
# Phase 2: reverse backfill.
#
# The 2.5/0.5/0.125 magnitude tests against value*2^q products are
# integer compares q >= qmin(value) (the scaling by 2^q is exact in
# f32, so the smallest passing q is a pure function of the value's bit
# pattern — fast_encode._qmin_ge builds them). The size-only walks read
# ONE packed per-position threshold plane instead of the four value
# planes (coef/coefn/ampn/hfamp + hfmeta). Field layout (i32):
#   bits 0-5   qmin(|coef[p]|, 2.5)      - resc test / p2 coded test
#   bits 6-11  qmin(|coef[p+1]|, 2.5)    - resc second-coef test
#   bits 12-17 qmin(ampn[pair], 0.5)     - noise-run amplitude test
#   bits 18-23 qmin(hfamp[pair], 0.125)  - HF-extension amplitude test
#   bit  24    hfok[pair]                - HF fit validity
# 63 = "never" (beyond the 5-bit quantizer range).


def _p2(t_ref, c_ref, key_ref, thr_ref, aux_ref, s12_ref, state_ref, *,
        p_tot: int):
    t = t_ref[...]
    c = c_ref[...]

    def body(p, carry):
        nk, nk_split, cur_qi, q_next, ncp = carry
        aux = aux_ref[p]
        key = key_ref[p]
        segdelta = aux & 0xFFFF
        kept = (key > t) | ((key == t) & (p <= c))
        s12 = s12_ref[p]
        split_p = (s12 >> 5) & 1
        diff_seg = nk >= p + segdelta
        zone_end = kept & ((nk >= SENT) | (nk_split == 1) | diff_seg)
        cur_qi = jnp.where(zone_end, s12 & 0x1F, cur_qi)
        # |coef|*2^cur_qi >= 2.5 as an integer threshold compare
        coded = kept & (cur_qi >= (thr_ref[p] & 63))
        q_next = jnp.where(coded, cur_qi, q_next)
        ncp = jnp.where(coded, p, ncp)
        state_ref[p] = (
            jnp.clip(ncp, 0, (1 << 16) - 1)
            | (q_next << 16)
            | (coded.astype(jnp.int32) << 21)
        )
        nk = jnp.where(kept, p, nk)
        nk_split = jnp.where(kept, split_p, nk_split)
        return nk, nk_split, cur_qi, q_next, ncp

    full = lambda v: jnp.full(t.shape, v, jnp.int32)
    _walk(p_tot, body, (full(SENT), full(0), full(31), full(31), full(SENT)),
          reverse=True)


# ---------------------------------------------------------------------------
# Phase 3: forward emission walk with in-kernel tail pricing + packing.
#
#  - tail tokens (ulcEncoder_NoiseFill.c:41-94 pricing; stop/zero-tail
#    codes of ulcEncoder_Encode.c) are emitted at the first in-segment
#    position past the last coded coefficient — the walk knows it is
#    there (`is_tail`) the moment it arrives, so the token is priced and
#    packed inline and `bits` already includes it;
#  - in materialize mode a per-lane nybble shift register (one u32 = 8
#    nybbles) accumulates the stream; each completed u32 word is emitted
#    at its position together with its running word index, and the glue
#    places the words afterwards (fast_encode._assemble_words).


def _p3(*refs, materialize: bool, p_tot: int):
    if materialize:
        (coef_ref, coefn_ref, amp_ref, aux_ref, hfamp_ref, hfmeta_ref,
         state_ref, hdr_ref, bits_ref, word_ref, widx_ref, freg_ref,
         fwc_ref) = refs
    else:
        # size-only walk: the value planes collapse into the packed
        # threshold plane (see the field-layout comment above _p2)
        (thr_ref, aux_ref, state_ref, bits_ref) = refs

    def body(p, carry):
        if materialize:
            covered, prev_q, bits, tail_done, reg, fill, wcount = carry
        else:
            covered, prev_q, bits, tail_done = carry
        aux = aux_ref[p]
        segdelta = aux & 0xFFFF
        segstart = (aux >> 16) & 1
        srow = state_ref[p]
        ncp = srow & 0xFFFF
        q_ev = (srow >> 16) & 0x1F
        coded = (srow >> 21) & 1

        # Every event decision below is computed from this position's
        # data only; the carry enters through the late act/neq selects,
        # which keeps the loop-carried dependence chain short. Values
        # speculated at inactive positions are masked (cnt = 0 packs a
        # zero word; covered and prev_q keep their old values).
        is_code = coded == 1
        is_tail = (ncp - p) >= segdelta
        gp = (~is_code) & (~is_tail)
        qq = q_ev
        s = qq - 5
        ext_q = (s >= 14).astype(jnp.int32)

        z_r = jnp.clip(ncp - p, 0, SENT)
        if materialize:
            scale = _exp2i(qq)
            c0 = coef_ref[p]
            c1 = coefn_ref[p]
            qn1 = jnp.minimum(_cq_unsigned(jnp.abs(c0) * scale), 7)
            qn1 = jnp.where(c0 < 0, -qn1, qn1)
            qn2 = jnp.minimum(_cq_unsigned(jnp.abs(c1) * scale), 7)
            qn2 = jnp.where(c1 < 0, -qn2, qn2)
            amp = amp_ref[p >> 1]
            nq_est = jnp.where(
                amp > 0, jnp.minimum(_cq_unsigned(amp * scale), 8), 0
            )
            resc_ok = (jnp.abs(qn1) > 1) & ((z_r < 2) | (jnp.abs(qn2) > 1))
            noise_ok = nq_est > 0
        else:
            thr = thr_ref[p]
            resc_ok = (qq >= (thr & 63)) & (
                (z_r < 2) | (qq >= ((thr >> 6) & 63))
            )
            noise_ok = qq >= ((thr >> 12) & 63)

        do_resc = gp & (z_r <= 2) & resc_ok
        do_noise = gp & (~do_resc) & (z_r >= 16) & noise_ok
        do_zs = gp & (~do_resc) & (~do_noise) & (z_r < 33)
        run_n = jnp.where(
            do_resc,
            z_r,
            jnp.where(
                do_noise,
                jnp.minimum(z_r, 527),
                jnp.where(do_zs, jnp.minimum(z_r, 16), jnp.minimum(z_r, 288)),
            ),
        )
        run_cnt = jnp.where(
            do_resc, z_r, jnp.where(do_noise, 4, jnp.where(do_zs, 2, 3))
        )
        evt = is_code | gp
        cov_evt = jnp.where(is_code, p + 1, p + run_n)
        base_cnt = jnp.where(is_code, jnp.int32(1), run_cnt)

        # --- carry chain (everything above is data-only) ---
        prev_q = jnp.where(segstart == 1, jnp.int32(-1), prev_q)
        tail_done = jnp.where(segstart == 1, jnp.int32(0), tail_done)
        skip = p < covered
        act = (~skip) & evt
        coded_ev = act & is_code
        lead = (prev_q >= 0).astype(jnp.int32)
        need_q = act & (qq != prev_q)
        q_cnt = jnp.where(need_q, 1 + ext_q + lead, 0)
        cnt = jnp.where(act, q_cnt + base_cnt, 0)
        new_covered = jnp.where(act, cov_evt, covered)
        new_prev_q = jnp.where(need_q, qq, prev_q)

        # --- tail token (fires exactly at p_tail = max(last_coded+1,
        # seg_start): the first in-segment position with nothing coded
        # ahead) ---
        tail_ev = (coded == 0) & is_tail & (tail_done == 0)
        n_tail = segdelta
        pq_valid = prev_q >= 0
        if materialize:
            meta = hfmeta_ref[p >> 1]
            hfok = (meta >> 8) == 1
            dec_t = meta & 0xFF
            pq_scale = _exp2i(prev_q)
            amp_t = hfamp_ref[p >> 1]
            nq_hf = jnp.minimum(_cq_unsigned(amp_t * pq_scale * 4.0), 16)
            hf_amp_ok = nq_hf > 0
        else:
            hfok = ((thr >> 24) & 1) == 1
            hf_amp_ok = prev_q >= ((thr >> 18) & 63)
        do_hf = tail_ev & pq_valid & (n_tail >= 16) & hfok & hf_amp_ok
        do_stop = tail_ev & (n_tail > 4) & (~do_hf)
        do_zt = tail_ev & (n_tail > 0) & (n_tail <= 4)
        cnt_tail = jnp.where(
            do_hf,
            5,
            jnp.where(
                do_stop,
                jnp.where(pq_valid, 3, 2),
                jnp.where(do_zt, 2, 0),
            ),
        )
        tail_done = jnp.where(tail_ev, jnp.int32(1), tail_done)
        bits = bits + cnt + cnt_tail

        if not materialize:
            return new_covered, new_prev_q, bits, tail_done

        qv0 = jnp.where(lead == 1, 0xF, jnp.where(ext_q == 1, 0xE, s))
        qv1 = jnp.where(lead == 1, jnp.where(ext_q == 1, 0xE, s), s - 14)
        qv2 = s - 14
        v_noise = run_n - 16
        v_long = run_n - 33
        t0 = jnp.where(
            coded_ev | do_resc,
            qn1 & 0xF,
            jnp.where(do_noise, 0x8, jnp.where(do_zs, 0x0, 0x1)),
        )
        t1 = jnp.where(
            do_resc,
            qn2 & 0xF,
            jnp.where(
                do_noise,
                (v_noise >> 5) & 0xF,
                jnp.where(do_zs, run_n - 1, (v_long >> 4) & 0xF),
            ),
        )
        t2 = jnp.where(do_noise, (v_noise >> 1) & 0xF, v_long & 0xF)
        t3 = ((v_noise & 1) | ((nq_est - 1) << 1)) & 0xF
        # arithmetic pack: quantizer nybbles, then the token nybbles
        # shifted up by 4*q_cnt, masked to cnt nybbles
        qpart = (
            (qv0 & 0xF) | ((qv1 & 0xF) << 4) | ((qv2 & 0xF) << 8)
        )
        qm = jnp.where((q_cnt & 1) == 1, 0xF, 0)
        qm = qm | jnp.where((q_cnt & 2) == 2, (qm << 8) | 0xFF, 0)
        tpart = (
            (t0 & 0xF) | ((t1 & 0xF) << 4) | ((t2 & 0xF) << 8)
            | ((t3 & 0xF) << 12)
        )
        tpart = jnp.where((q_cnt & 1) == 1, tpart << 4, tpart)
        tpart = jnp.where((q_cnt & 2) == 2, tpart << 8, tpart)
        one = jnp.full(cnt.shape, 1, jnp.int32)
        hb = jnp.where((cnt & 1) == 1, one << 4, one)
        hb = jnp.where((cnt & 2) == 2, hb << 8, hb)
        hb = jnp.where((cnt & 4) == 4, hb << 16, hb)
        packed = ((qpart & qm) | tpart) & (hb - 1)
        tail_packed = jnp.where(
            do_hf,
            0xF
            | (0xF << 4)
            | (((nq_hf - 1) & 0xF) << 8)
            | (((dec_t >> 4) & 0xF) << 12)
            | ((dec_t & 0xF) << 16),
            jnp.where(
                do_stop,
                jnp.where(pq_valid, 0xF | (0xE << 4) | (0xF << 8),
                          0xE | (0xF << 4)),
                0x0 | (jnp.clip(n_tail - 1, 0, 0xF) << 4),
            ),
        )
        pos_packed = jnp.where(
            tail_ev, jnp.where(cnt_tail > 0, tail_packed, 0), packed
        )
        pos_cnt = cnt + cnt_tail

        # per-lane nybble shift register: one u32 = 8 nybbles; the
        # shift by 4*fill decomposes over fill's bits
        lo_add = jnp.where((fill & 1) == 1, pos_packed << 4, pos_packed)
        lo_add = jnp.where((fill & 2) == 2, lo_add << 8, lo_add)
        lo_add = jnp.where((fill & 4) == 4, lo_add << 16, lo_add)
        # residue = pos_packed >> (32 - 4*fill): decompose 8 - fill
        inv = 8 - fill
        residue = jnp.where((inv & 1) == 1, pos_packed >> 4, pos_packed)
        residue = jnp.where((inv & 2) == 2, residue >> 8, residue)
        residue = jnp.where((inv & 4) == 4, residue >> 16, residue)
        residue = jnp.where(fill == 0, 0, residue)
        full = reg | lo_add
        newfill = fill + pos_cnt
        crossed = newfill >= 8
        word_ref[p] = full
        widx_ref[p] = jnp.where(crossed, wcount, jnp.int32(2**30))
        reg = jnp.where(crossed, residue, full)
        fill = newfill & 7
        wcount = wcount + crossed.astype(jnp.int32)
        return new_covered, new_prev_q, bits, tail_done, reg, fill, wcount

    shape = bits_ref.shape
    zeros = jnp.zeros(shape, jnp.int32)
    init = (zeros, jnp.full(shape, -1, jnp.int32), zeros, zeros)
    if materialize:
        h = jnp.broadcast_to(hdr_ref[...], shape)
        nh = h >> 8
        init += (jnp.where(nh == 2, h & 0xFF, h & 0xF), nh, zeros)
    out = _walk(p_tot, body, init)
    bits_ref[...] = out[2]
    if materialize:
        freg_ref[...] = out[4]
        fwc_ref[...] = out[6]


# ---------------------------------------------------------------------------
# Callers.


def _call(kernel, g: int, lanes: int, in_shapes, out_shapes, interpret: bool):
    """One program per stream group; every block spans all positions of
    its group's `lanes` streams (shapes given without the G axis)."""

    def spec(shape):
        zeros = (0,) * len(shape)
        return pl.BlockSpec((None,) + shape, lambda i: (i,) + zeros)

    return pl.pallas_call(
        kernel,
        grid=(g,),
        in_specs=[spec(s) for s in in_shapes],
        out_specs=tuple(spec(s.shape[1:]) for s in out_shapes),
        out_shape=tuple(out_shapes),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=max(1, N_CAND * lanes // 32), num_stages=1
        ),
        interpret=interpret,
    )


def p12_call(t, c, key, coef, thr, aux, p_tot: int, interpret: bool = False):
    """Phases 1+2 (forward zone scan, reverse backfill): the packed
    per-position state plane [G, P, N_CAND, LANES] consumed by phase 3.
    Exposed separately so a size pass and a materialize pass over the
    SAME candidates reuse one state build.
    t/c [G, N_CAND, L] are the per-candidate keep thresholds (see
    module docstring); key [G, P, 1, L] the monotone importance.
    p1 reads the coefficient values (zone min/max); p2 only ever tests
    |coef|*2^q >= 2.5, so it reads the packed threshold plane."""
    g, _, lanes = t.shape
    pos = (p_tot, 1, lanes)
    cand = (N_CAND, lanes)
    plane = jax.ShapeDtypeStruct((g, p_tot, N_CAND, lanes), jnp.int32)
    (s12,) = _call(
        functools.partial(_p1, p_tot=p_tot), g, lanes,
        [cand, cand, pos, pos, pos], [plane], interpret,
    )(t, c, key, coef, aux)
    (state,) = _call(
        functools.partial(_p2, p_tot=p_tot), g, lanes,
        [cand, cand, pos, pos, pos, plane.shape[1:]], [plane], interpret,
    )(t, c, key, thr, aux, s12)
    return state


def p3_call(coef, thr, ampn, aux, hfamp, hfmeta, state, hdr,
            p_tot: int, materialize: bool, interpret: bool = False):
    """Phase 3 (forward emission walk) over a prebuilt state plane.

    Size-only mode reads (thr, aux, state): the coefficient/amplitude
    value planes are replaced by the packed threshold plane (pass
    coef/ampn/hfamp/hfmeta as None). Materialize mode reads the full
    value planes (thr unused). Keep decisions are already baked into
    the state plane, so phase 3 needs no keep thresholds."""
    g, _, _, lanes = state.shape
    pos = (p_tot, 1, lanes)
    line = (p_tot // 2, 1, lanes)
    cand = (N_CAND, lanes)
    kern = functools.partial(_p3, materialize=materialize, p_tot=p_tot)
    per_cand = jax.ShapeDtypeStruct((g,) + cand, jnp.int32)
    if not materialize:
        return _call(
            kern, g, lanes, [pos, pos, state.shape[1:]], [per_cand], interpret
        )(thr, aux, state)

    coefn = jnp.concatenate([coef[:, 1:], coef[:, -1:]], axis=1)
    plane = jax.ShapeDtypeStruct(state.shape, jnp.int32)
    return _call(
        kern, g, lanes,
        [pos, pos, line, pos, line, line, state.shape[1:], cand],
        [per_cand, plane, plane, per_cand, per_cand], interpret,
    )(coef, coefn, ampn, aux, hfamp, hfmeta, state, hdr)


def encode_kernel_call3(t, c, key, coef, thr, ampn, aux, hfamp, hfmeta, hdr,
                        p_tot: int, materialize: bool,
                        interpret: bool = False):
    """One rate-search round: G groups x (L streams x N_CAND candidates).

    t/c/hdr [G, N_CAND, L] i32 (t/c = per-candidate keep thresholds);
    coef [G, P, 1, L] f32; key/aux alike i32; ampn/hfamp
    [G, P/2, 1, L] f32 and hfmeta i32 in the pseudo-DFT line domain
    (pairwise-constant, read at p >> 1).
    Returns bits [G, N_CAND, L] (tail tokens included; header excluded),
    plus in materialize mode (word [G, P, N_CAND, L], widx alike,
    freg [G, N_CAND, L], fwc [G, N_CAND, L]): emitted u32 stream words
    with their word indices (2**30 where no word completed), the final
    partial word, and the completed-word count.
    """
    state = p12_call(t, c, key, coef, thr, aux, p_tot, interpret)
    return p3_call(coef, thr, ampn, aux, hfamp, hfmeta, state, hdr,
                   p_tot, materialize, interpret)
