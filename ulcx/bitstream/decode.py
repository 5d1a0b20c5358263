"""Vectorized bitstream decoder.

Batched re-architecture of reference ulcDecoder.c:99-197. The
reference walks nybbles in a data-dependent loop writing coefficients
one at a time; here decoding is three phases, each batch-friendly:

1. **FSM scan over nybbles** — every step consumes exactly one nybble
   and advances a small finite-state carry (mode, coefficient cursor,
   quantizer, partial-token registers). Completed tokens are emitted as
   fixed-size records (type, start, count, level, decay). The scan
   length is the container's max block size in nybbles, so cost tracks
   the *bitrate*, not the coefficient count.
2. **Vectorized expansion** — records tile the coefficient axis
   exactly, so record-of-position is a scatter+cumsum, and values
   (coefficient / zero / noise level / exp-decay tail) are gathers and
   elementwise math.
3. **RNG sign scan** — the reference's noise signs come from a single
   process-global xorshift32 (seed 1234567, never reset; reference
   ulcDecoder.c:75-81) whose sign is toggled *cumulatively* per draw.
   A thin scan over coefficient positions replays it exactly; its
   state is carried across blocks (and streams decode bit-exactly vs
   the C tools when fed the same stream).

Quantizer expansion reproduces the reference's integer formula
``(1<<26) >> qi`` exactly (including the qi>26 -> 0 corner).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp
from jax import lax

from ulcx.bitstream.tables import segment_tables
from ulcx.utils.config import CodecConfig

# FSM modes
M_QUANT_START = 0
M_QUANT_EXT_S = 1
M_NORMAL = 2
M_QUANT_MID = 3
M_QUANT_EXT_M = 4
M_ZSHORT = 5
M_LRUN_Y = 6
M_LRUN_X = 7
M_NOISE_Z = 8
M_NOISE_Y = 9
M_NOISE_X = 10
M_TAIL_Z = 11
M_TAIL_Y = 12
M_TAIL_X = 13
M_DONE = 14

# record types
REC_NONE = 0
REC_COEF = 1
REC_ZERO = 2
REC_NOISE = 3
REC_TAIL = 4


class FsmCarry(NamedTuple):
    mode: jnp.ndarray      # i32
    pos: jnp.ndarray       # i32 flat coefficient cursor
    qi: jnp.ndarray        # i32 current quantizer index (biased, 0..28)
    r0: jnp.ndarray        # i32 partial-token register
    r1: jnp.ndarray        # i32
    corrupt: jnp.ndarray   # bool
    consumed: jnp.ndarray  # i32 nybbles consumed (incl. this one when active)


class Records(NamedTuple):
    emit: jnp.ndarray    # [T] bool
    rtype: jnp.ndarray   # [T] i32
    start: jnp.ndarray   # [T] i32
    count: jnp.ndarray   # [T] i32
    level: jnp.ndarray   # [T] f32 (coef value / noise level)
    decay: jnp.ndarray   # [T] f32


def _expand_quantizer(qi):
    """2^-(5+qi) via the reference's exact integer formula."""
    m = jnp.where(qi < 27, (jnp.int32(1) << 26) >> jnp.clip(qi, 0, 26), 0)
    return m.astype(jnp.float32) * jnp.float32(2.0**-31)


def decode_block_tokens(
    nybbles: jnp.ndarray,      # [T] i32 token nybbles (header already stripped)
    window_ctrl: jnp.ndarray,  # scalar i32
    cfg: CodecConfig,
):
    """Run the FSM. Returns (Records, bits_consumed(tokens), corrupt)."""
    n, c = cfg.block_size, cfg.n_chan
    p_tot = n * c
    _, ends_t, _ = segment_tables(n, c)
    seg_end = jnp.asarray(ends_t)[window_ctrl >> 4]  # [P]

    def body(carry: FsmCarry, x):
        m = carry.mode
        pos = carry.pos
        qi = carry.qi
        active = (m != M_DONE) & (~carry.corrupt)
        se = seg_end[jnp.clip(pos, 0, p_tot - 1)]
        remaining = se - pos

        # defaults
        new_m = m
        new_pos = pos
        new_qi = qi
        new_r0 = carry.r0
        new_r1 = carry.r1
        corrupt = carry.corrupt
        emit = jnp.bool_(False)
        rtype = jnp.int32(REC_NONE)
        rstart = pos
        rcount = jnp.int32(0)
        rlevel = jnp.float32(0.0)
        rdecay = jnp.float32(0.0)

        quant = _expand_quantizer(qi)

        def seg_adv(p):
            """Mode after the cursor advanced to p (token complete)."""
            return jnp.where(p >= p_tot, M_DONE, jnp.where(p == se, M_QUANT_START, M_NORMAL))

        # ---- M_QUANT_START: first nybble of a segment
        in_qs = m == M_QUANT_START
        qs_stop = in_qs & (x == 0xE + 0)  # 0xE -> extended / possibly stop
        new_m = jnp.where(in_qs, jnp.where(x == 0xE, M_QUANT_EXT_S, M_NORMAL), new_m)
        new_qi = jnp.where(in_qs & (x < 0xE), x, new_qi)
        corrupt = corrupt | (in_qs & (x == 0xF))  # F,F at segment start: meaningless

        # ---- M_QUANT_EXT_S: second nybble of extended initial quantizer
        in_qes = m == M_QUANT_EXT_S
        # x == 0xF -> [Eh,Fh] silent segment: zeros to end
        qes_stop = in_qes & (x == 0xF)
        emit = emit | qes_stop
        rtype = jnp.where(qes_stop, REC_ZERO, rtype)
        rcount = jnp.where(qes_stop, remaining, rcount)
        new_pos = jnp.where(qes_stop, se, new_pos)
        new_m = jnp.where(
            in_qes, jnp.where(x == 0xF, seg_adv(se), M_NORMAL), new_m
        )
        new_qi = jnp.where(in_qes & (x != 0xF), 0xE + x, new_qi)

        # ---- M_QUANT_MID: nybble after a mid-stream 0xF
        in_qm = m == M_QUANT_MID
        new_m = jnp.where(
            in_qm,
            jnp.where(x == 0xF, M_TAIL_Z, jnp.where(x == 0xE, M_QUANT_EXT_M, M_NORMAL)),
            new_m,
        )
        new_qi = jnp.where(in_qm & (x < 0xE), x, new_qi)

        # ---- M_QUANT_EXT_M
        in_qem = m == M_QUANT_EXT_M
        qem_stop = in_qem & (x == 0xF)
        emit = emit | qem_stop
        rtype = jnp.where(qem_stop, REC_ZERO, rtype)
        rcount = jnp.where(qem_stop, remaining, rcount)
        new_pos = jnp.where(qem_stop, se, new_pos)
        new_m = jnp.where(
            in_qem, jnp.where(x == 0xF, seg_adv(se), M_NORMAL), new_m
        )
        new_qi = jnp.where(in_qem & (x != 0xF), 0xE + x, new_qi)

        # ---- M_NORMAL
        in_n = m == M_NORMAL
        is_coef = in_n & (x != 0x0) & (x != 0x1) & (x != 0x8) & (x != 0xF)
        s = (x ^ 0x8) - 0x8
        val = jnp.where(s < 0, -(s * s), s * s).astype(jnp.float32) * quant
        emit = emit | is_coef
        rtype = jnp.where(is_coef, REC_COEF, rtype)
        rcount = jnp.where(is_coef, 1, rcount)
        rlevel = jnp.where(is_coef, val, rlevel)
        pos_c = pos + 1
        new_pos = jnp.where(is_coef, pos_c, new_pos)
        new_m = jnp.where(is_coef, seg_adv(pos_c), new_m)

        new_m = jnp.where(in_n & (x == 0x0), M_ZSHORT, new_m)
        new_m = jnp.where(in_n & (x == 0x1), M_LRUN_Y, new_m)
        new_m = jnp.where(in_n & (x == 0x8), M_NOISE_Z, new_m)
        new_m = jnp.where(in_n & (x == 0xF), M_QUANT_MID, new_m)

        # ---- M_ZSHORT: zero-run length nybble
        in_zs = m == M_ZSHORT
        n_zs = x + 1
        zs_bad = in_zs & (n_zs > remaining)
        corrupt = corrupt | zs_bad
        zs_ok = in_zs & (~zs_bad)
        emit = emit | zs_ok
        rtype = jnp.where(zs_ok, REC_ZERO, rtype)
        rcount = jnp.where(zs_ok, n_zs, rcount)
        pos_z = pos + n_zs
        new_pos = jnp.where(zs_ok, pos_z, new_pos)
        new_m = jnp.where(zs_ok, seg_adv(pos_z), new_m)

        # ---- M_LRUN_Y / M_LRUN_X
        in_ly = m == M_LRUN_Y
        new_r0 = jnp.where(in_ly, x, new_r0)
        new_m = jnp.where(in_ly, M_LRUN_X, new_m)
        in_lx = m == M_LRUN_X
        n_l = (carry.r0 << 4 | x) + 33
        l_bad = in_lx & (n_l > remaining)
        corrupt = corrupt | l_bad
        l_ok = in_lx & (~l_bad)
        emit = emit | l_ok
        rtype = jnp.where(l_ok, REC_ZERO, rtype)
        rcount = jnp.where(l_ok, n_l, rcount)
        pos_l = pos + n_l
        new_pos = jnp.where(l_ok, pos_l, new_pos)
        new_m = jnp.where(l_ok, seg_adv(pos_l), new_m)

        # ---- noise fill 8h,Z,Y,X
        in_nz = m == M_NOISE_Z
        new_r0 = jnp.where(in_nz, x, new_r0)
        new_m = jnp.where(in_nz, M_NOISE_Y, new_m)
        in_ny = m == M_NOISE_Y
        new_r0 = jnp.where(in_ny, carry.r0 << 4 | x, new_r0)
        new_m = jnp.where(in_ny, M_NOISE_X, new_m)
        in_nx = m == M_NOISE_X
        n_noise = ((carry.r0 << 1) | (x & 1)) + 16
        lvl_q = (x >> 1) + 1
        nx_bad = in_nx & (n_noise > remaining)
        corrupt = corrupt | nx_bad
        nx_ok = in_nx & (~nx_bad)
        emit = emit | nx_ok
        rtype = jnp.where(nx_ok, REC_NOISE, rtype)
        rcount = jnp.where(nx_ok, n_noise, rcount)
        rlevel = jnp.where(
            nx_ok, (lvl_q * lvl_q).astype(jnp.float32) * quant * jnp.float32(0.25), rlevel
        )
        pos_n = pos + n_noise
        new_pos = jnp.where(nx_ok, pos_n, new_pos)
        new_m = jnp.where(nx_ok, seg_adv(pos_n), new_m)

        # ---- tail noise Fh,Fh,Z,Y,X
        in_tz = m == M_TAIL_Z
        new_r0 = jnp.where(in_tz, x, new_r0)
        new_m = jnp.where(in_tz, M_TAIL_Y, new_m)
        in_ty = m == M_TAIL_Y
        new_r1 = jnp.where(in_ty, x, new_r1)
        new_m = jnp.where(in_ty, M_TAIL_X, new_m)
        in_tx = m == M_TAIL_X
        lvl_t = carry.r0 + 1
        dn = (carry.r1 << 4) | x
        emit = emit | in_tx
        rtype = jnp.where(in_tx, REC_TAIL, rtype)
        rcount = jnp.where(in_tx, remaining, rcount)
        rlevel = jnp.where(
            in_tx,
            (lvl_t * lvl_t).astype(jnp.float32) * quant * jnp.float32(1.0 / 16),
            rlevel,
        )
        rdecay = jnp.where(
            in_tx,
            jnp.float32(1.0) + (dn * dn).astype(jnp.float32) * jnp.float32(-(2.0**-19)),
            rdecay,
        )
        new_pos = jnp.where(in_tx, se, new_pos)
        new_m = jnp.where(in_tx, seg_adv(se), new_m)

        # freeze when inactive
        out = FsmCarry(
            mode=jnp.where(active, new_m, m).astype(jnp.int32),
            pos=jnp.where(active, new_pos, pos).astype(jnp.int32),
            qi=jnp.where(active, new_qi, qi).astype(jnp.int32),
            r0=jnp.where(active, new_r0, carry.r0).astype(jnp.int32),
            r1=jnp.where(active, new_r1, carry.r1).astype(jnp.int32),
            corrupt=jnp.where(active, corrupt, carry.corrupt),
            consumed=carry.consumed + active.astype(jnp.int32),
        )
        rec = (
            active & emit,
            jnp.where(active, rtype, REC_NONE).astype(jnp.int32),
            rstart.astype(jnp.int32),
            jnp.where(active, rcount, 0).astype(jnp.int32),
            rlevel,
            rdecay,
        )
        return out, rec

    init = FsmCarry(
        mode=jnp.int32(M_QUANT_START),
        pos=jnp.int32(0),
        qi=jnp.int32(0),
        r0=jnp.int32(0),
        r1=jnp.int32(0),
        corrupt=jnp.bool_(False),
        consumed=jnp.int32(0),
    )
    final, recs = lax.scan(body, init, nybbles)
    records = Records(*recs)
    done_ok = final.mode == M_DONE
    corrupt = final.corrupt | ~done_ok
    return records, final.consumed, corrupt


def expand_records(records: Records, rng_state, p_tot: int):
    """Records -> coefficients [P]; returns (coefs, new_rng_state).

    rng_state: scalar uint32 xorshift32 state carried across blocks.
    """
    emit = records.emit
    start = jnp.where(emit, records.start, p_tot)  # drop dummy scatters

    def scat(vals, dtype=jnp.float32):
        return jnp.zeros(p_tot, dtype).at[start].set(
            jnp.where(emit, vals, 0).astype(dtype), mode="drop"
        )

    mark = jnp.zeros(p_tot, jnp.int32).at[start].set(
        jnp.where(emit, 1, 0), mode="drop"
    )
    rec_cum = jnp.cumsum(mark)  # record ordinal at each position (1-based)
    type_at = scat(records.rtype, jnp.int32)
    level_at = scat(records.level)
    decay_at = scat(records.decay)
    start_idx = jnp.zeros(p_tot, jnp.int32).at[start].set(
        jnp.where(emit, records.start, 0), mode="drop"
    )

    # forward-fill record fields across each record's extent
    pos = jnp.arange(p_tot)
    # positions belong to the record whose start is the last start <= pos
    # rec_cum is constant within a record's extent after its start
    last_start = jnp.zeros(p_tot, jnp.int32).at[start].set(
        jnp.where(emit, records.start, 0), mode="drop"
    )
    last_start = lax.cummax(last_start, axis=0)
    # gather per-position fields from the start position
    type_p = type_at[last_start]
    level_p = level_at[last_start]
    decay_p = decay_at[last_start]

    is_draw = (type_p == REC_NOISE) | (type_p == REC_TAIL)
    is_tail = type_p == REC_TAIL
    is_start = pos == last_start

    def rng_body(state, xs):
        draw, st, lvl, dcy, tail = xs
        s, parity, mag = state
        s2 = s ^ (s << 13)
        s2 = s2 ^ (s2 >> 17)
        s2 = s2 ^ (s2 << 5)
        s_new = jnp.where(draw, s2, s)
        bit = (s_new >> 31) & jnp.uint32(1)
        parity = jnp.where(st, jnp.uint32(0), parity)
        parity = jnp.where(draw, parity ^ bit, parity)
        # HF-ext tail magnitude: the reference's SEQUENTIAL f32 chain
        # (emit p, then p *= r — ulcDecoder.c:155-186); a closed-form
        # level*decay^k drifts ~ulp-per-step from the C output. The
        # decay factor is always positive (r >= 1 - 255^2*2^-19), so
        # tracking |p| with the sign applied outside is exact.
        mag = jnp.where(st, lvl, mag)
        out_mag = mag
        mag = jnp.where(draw & tail, mag * dcy, mag)
        return (s_new, parity, mag), (parity, out_mag)

    (rng_out, _, _), (parity_seq, mag_seq) = lax.scan(
        rng_body,
        (rng_state, jnp.uint32(0), jnp.float32(0.0)),
        (is_draw, is_start, level_p, decay_p, is_tail),
    )
    sign = jnp.where(parity_seq == 1, -1.0, 1.0).astype(jnp.float32)

    mag = jnp.where(is_tail, mag_seq, level_p)
    coefs = jnp.where(
        type_p == REC_COEF,
        level_p,
        jnp.where(is_draw, mag * sign, 0.0),
    )
    return coefs, rng_out
