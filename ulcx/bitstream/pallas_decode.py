"""Pallas kernels (Triton route) for the bitstream decoder.

Two kernels mirror the encoder kernels' design (pallas_encode3.py):

- **FSM kernel**: the nybble syntax state machine
  (ulcx.bitstream.decode.decode_block_tokens) as one in-kernel loop
  over the tokens, one nybble per step, LANES streams per program.
  Segment ends are computed *arithmetically* from the window-control
  word (an 8-slot per-pattern next-end register file built once at
  kernel start), so there are no per-lane table gathers.
- **RNG kernel**: the xorshift32 cumulative-sign replay over coefficient
  positions (the reference's process-global noise RNG,
  ulcDecoder.c:75-81), one position per step, fused with record fill
  and coefficient assembly.

Record placement between them is gather-free vectorized JAX
(fast_decode.records_to_flags).

Each program walks the whole token (or position) axis of its streams,
the carry in registers: programs run in parallel and in no order, so
no carry crosses a program boundary. The envelope is the encoder's
full P <= 32768 (the complete reference block-size range,
ulcEncoder.c:21).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ulcx.ops.patterns import pattern_subblock_offsets, pattern_subblock_sizes

LANES = 2  # streams per program (power of two; fastest of 2-16 on an H100)

# FSM modes (shared vocabulary with ulcx.bitstream.decode)
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
M_CORRUPT = 15  # corrupt folds into the mode field (frees the carry bit)

REC_NONE = 0
REC_COEF = 1
REC_ZERO = 2
REC_NOISE = 3
REC_TAIL = 4


def _next_end_table(block_size: int):
    """[16][8]: for each pattern and N/8 slot, the in-channel coefficient
    index where the segment containing that slot ends."""
    out = np.zeros((16, 8), np.int32)
    for pat in range(16):
        pi = pat or 1
        for off, ss in zip(
            pattern_subblock_offsets(pi, block_size),
            pattern_subblock_sizes(pi, block_size),
        ):
            s0 = off // (block_size // 8)
            s1 = (off + ss) // (block_size // 8)
            out[pat, s0:s1] = off + ss
    return out


def _expand_quant(qi):
    m = jnp.where(qi < 27, (jnp.int32(1) << 26) >> jnp.clip(qi, 0, 26), 0)
    return m.astype(jnp.float32) * jnp.float32(2.0**-31)


def _fsm_kernel(wc_ref, nyb_ref, rec_ref, code_ref, meta_ref,
                *, p_tot: int, n: int, t_len: int):
    """Single packed loop carry: pos(15) | mode(4)<<15 | qi(5)<<19 |
    r0(8)<<24 — exactly 32 bits. pos only matters while the FSM is
    active (mode < M_DONE), where pos < p_tot <= 32768, so 15 bits
    cover the encoder kernels' full P=32768 envelope; corrupt is the
    mode sentinel M_CORRUPT (15). Per-step 'consumed' is recovered
    outside the kernel by summing the active bit emitted with each
    record word.
    """
    wc = wc_ref[...]
    lanes = wc.shape[0]
    pat = wc >> 4
    slot_shift = int(np.log2(n // 8))
    net = _next_end_table(n)
    nse = []
    for s in range(8):
        v = jnp.full((lanes,), int(net[1, s]), jnp.int32)
        for p in range(16):
            v = jnp.where(pat == p, jnp.int32(int(net[p, s])), v)
        nse.append(v)

    def seg_end_of(pos):
        cb = pos & ~(n - 1)
        slot = (pos & (n - 1)) >> slot_shift
        se = nse[0]
        for s in range(1, 8):
            se = jnp.where(slot == s, nse[s], se)
        return cb + se

    def body(t, st):
        pos = st & 0x7FFF
        mode = (st >> 15) & 0xF
        qi = (st >> 19) & 0x1F
        r0 = (st >> 24) & 0xFF
        x = nyb_ref[t]
        active = (mode != M_DONE) & (mode != M_CORRUPT)
        se = seg_end_of(pos)
        remaining = se - pos

        new_m = mode
        new_pos = pos
        new_qi = qi
        new_r0 = r0
        bad = jnp.zeros((lanes,), jnp.bool_)
        emit = jnp.zeros((lanes,), jnp.bool_)
        rtype = jnp.full((lanes,), REC_NONE, jnp.int32)
        # level/decay leave the kernel as small integer CODES
        # (a | dn << 5 | qi << 13); the RNG kernel reconstructs the f32
        # values with the identical expressions. One i32 plane instead
        # of two f32 planes, and the record placement outside collapses
        # from three to one.
        r_a = jnp.zeros((lanes,), jnp.int32)
        r_dn = jnp.zeros((lanes,), jnp.int32)

        def seg_adv(p):
            return jnp.where(p >= p_tot, M_DONE, jnp.where(p == se, M_QUANT_START, M_NORMAL))

        in_qs = mode == M_QUANT_START
        new_m = jnp.where(in_qs, jnp.where(x == 0xE, M_QUANT_EXT_S, M_NORMAL), new_m)
        new_qi = jnp.where(in_qs & (x < 0xE), x, new_qi)
        bad = bad | (in_qs & (x == 0xF))

        for in_qe in (mode == M_QUANT_EXT_S, mode == M_QUANT_EXT_M):
            qe_stop = in_qe & (x == 0xF)
            emit = emit | qe_stop
            rtype = jnp.where(qe_stop, REC_ZERO, rtype)
            new_pos = jnp.where(qe_stop, se, new_pos)
            new_m = jnp.where(in_qe, jnp.where(x == 0xF, seg_adv(se), M_NORMAL), new_m)
            new_qi = jnp.where(in_qe & (x != 0xF), 0xE + x, new_qi)

        in_qm = mode == M_QUANT_MID
        new_m = jnp.where(
            in_qm,
            jnp.where(x == 0xF, M_TAIL_Z, jnp.where(x == 0xE, M_QUANT_EXT_M, M_NORMAL)),
            new_m,
        )
        new_qi = jnp.where(in_qm & (x < 0xE), x, new_qi)

        in_n = mode == M_NORMAL
        is_coef = in_n & (x != 0x0) & (x != 0x1) & (x != 0x8) & (x != 0xF)
        emit = emit | is_coef
        rtype = jnp.where(is_coef, REC_COEF, rtype)
        r_a = jnp.where(is_coef, x, r_a)
        pos_c = pos + 1
        new_pos = jnp.where(is_coef, pos_c, new_pos)
        new_m = jnp.where(is_coef, seg_adv(pos_c), new_m)
        new_m = jnp.where(in_n & (x == 0x0), M_ZSHORT, new_m)
        new_m = jnp.where(in_n & (x == 0x1), M_LRUN_Y, new_m)
        new_m = jnp.where(in_n & (x == 0x8), M_NOISE_Z, new_m)
        new_m = jnp.where(in_n & (x == 0xF), M_QUANT_MID, new_m)

        in_zs = mode == M_ZSHORT
        n_zs = x + 1
        zs_bad = in_zs & (n_zs > remaining)
        zs_ok = in_zs & (~zs_bad)
        bad = bad | zs_bad
        emit = emit | zs_ok
        rtype = jnp.where(zs_ok, REC_ZERO, rtype)
        pos_z = pos + n_zs
        new_pos = jnp.where(zs_ok, pos_z, new_pos)
        new_m = jnp.where(zs_ok, seg_adv(pos_z), new_m)

        in_ly = mode == M_LRUN_Y
        new_r0 = jnp.where(in_ly, x, new_r0)
        new_m = jnp.where(in_ly, M_LRUN_X, new_m)
        in_lx = mode == M_LRUN_X
        n_l = ((r0 << 4) | x) + 33
        l_bad = in_lx & (n_l > remaining)
        l_ok = in_lx & (~l_bad)
        bad = bad | l_bad
        emit = emit | l_ok
        rtype = jnp.where(l_ok, REC_ZERO, rtype)
        pos_l = pos + n_l
        new_pos = jnp.where(l_ok, pos_l, new_pos)
        new_m = jnp.where(l_ok, seg_adv(pos_l), new_m)

        in_nz = mode == M_NOISE_Z
        new_r0 = jnp.where(in_nz, x, new_r0)
        new_m = jnp.where(in_nz, M_NOISE_Y, new_m)
        in_ny = mode == M_NOISE_Y
        new_r0 = jnp.where(in_ny, (r0 << 4) | x, new_r0)
        new_m = jnp.where(in_ny, M_NOISE_X, new_m)
        in_nx = mode == M_NOISE_X
        n_noise = ((r0 << 1) | (x & 1)) + 16
        lvl_q = (x >> 1) + 1
        nx_bad = in_nx & (n_noise > remaining)
        nx_ok = in_nx & (~nx_bad)
        bad = bad | nx_bad
        emit = emit | nx_ok
        rtype = jnp.where(nx_ok, REC_NOISE, rtype)
        r_a = jnp.where(nx_ok, lvl_q, r_a)
        pos_n = pos + n_noise
        new_pos = jnp.where(nx_ok, pos_n, new_pos)
        new_m = jnp.where(nx_ok, seg_adv(pos_n), new_m)

        # tail: r0 accumulates Z then (Z<<4)|Y; TAIL_X decodes both
        in_tz = mode == M_TAIL_Z
        new_r0 = jnp.where(in_tz, x, new_r0)
        new_m = jnp.where(in_tz, M_TAIL_Y, new_m)
        in_ty = mode == M_TAIL_Y
        new_r0 = jnp.where(in_ty, (r0 << 4) | x, new_r0)
        new_m = jnp.where(in_ty, M_TAIL_X, new_m)
        in_tx = mode == M_TAIL_X
        lvl_t = (r0 >> 4) + 1
        dn = ((r0 & 0xF) << 4) | x
        emit = emit | in_tx
        rtype = jnp.where(in_tx, REC_TAIL, rtype)
        r_a = jnp.where(in_tx, lvl_t, r_a)
        r_dn = jnp.where(in_tx, dn, r_dn)
        new_pos = jnp.where(in_tx, se, new_pos)
        new_m = jnp.where(in_tx, seg_adv(se), new_m)

        new_m = jnp.where(bad, M_CORRUPT, new_m)

        emit = active & emit
        # rec: start(15) | rtype(3)<<15 | active<<29. Record lengths are
        # implicit (records tile the positions; expansion is
        # start-marker based), so no count field bounds P.
        rec = jnp.where(
            emit,
            jnp.clip(pos, 0, 0x7FFF) | (rtype << 15),
            0,
        ) | (active.astype(jnp.int32) << 29)
        rec_ref[t] = rec
        code_ref[t] = jnp.where(emit, r_a | (r_dn << 5) | (qi << 13), 0)

        packed = (
            jnp.clip(jnp.where(active, new_pos, pos), 0, 0x7FFF)
            | (jnp.where(active, new_m, mode) << 15)
            | (jnp.where(active, new_qi, qi) << 19)
            | (jnp.where(active, new_r0 & 0xFF, r0) << 24)
        )
        return packed

    init = jnp.full((lanes,), M_QUANT_START << 15, jnp.int32)
    meta_ref[...] = lax.fori_loop(0, t_len, body, init)


def _call(kernel, g: int, lanes: int, in_shapes, out_shapes, interpret: bool):
    """One program per stream group; every block spans the whole token
    or position axis of its group's `lanes` streams (shapes given
    without the G axis)."""

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
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
    )


def fsm_kernel_call(wc, nybbles, p_tot: int, n: int, interpret: bool = False):
    """wc [G, L] i32; nybbles [G, T, L] i32 (header stripped).

    Returns (rec [G, T, L] i32 packed start|type<<15,
    code [G, T, L] i32 packed a|dn<<5|qi<<13,
    consumed [G, L] i32, corrupt [G, L] i32)."""
    g, t_len, lanes = nybbles.shape
    kern = functools.partial(_fsm_kernel, p_tot=p_tot, n=n, t_len=t_len)
    plane = jax.ShapeDtypeStruct((g, t_len, lanes), jnp.int32)
    rec, code, final = _call(
        kern, g, lanes, [(lanes,), (t_len, lanes)],
        [plane, plane, jax.ShapeDtypeStruct((g, lanes), jnp.int32)],
        interpret,
    )(wc.astype(jnp.int32), nybbles)
    consumed = jnp.sum((rec >> 29) & 1, axis=1).astype(jnp.int32)
    mode_f = (final >> 15) & 0xF
    corrupt = (mode_f != M_DONE).astype(jnp.int32)
    return rec & ((1 << 29) - 1), code, consumed, corrupt


def _rng_expand_kernel(flags_ref, seed_ref, coef_ref, seed_out_ref,
                       *, p_tot: int):
    """Fused RNG replay + record fill + coefficient assembly.

    flags[p] is ONE packed word per position (sparse fields live at
    record starts only): bit0 = record start, bit1 = draw record,
    bit2 = coded-coefficient record, bit3 = tail record,
    a<<4 | dn<<9 | qi<<17 level/decay codes. The draw bit is LATCHED
    in-kernel at record starts (records tile the positions, so the
    latch IS the forward fill). Level/decay floats are reconstructed
    here with the exact expressions the scan decoder uses
    (bit-identical). Tail decay runs as the reference's sequential
    ``mag *= r`` (ulcDecoder.c:186).
    """
    def body(p, carry):
        state, parity, drw, lvl, mag, dcy = carry
        f = flags_ref[p]
        st = (f & 1) == 1
        drw = jnp.where(st, ((f >> 1) & 1).astype(jnp.uint32), drw)
        draw = drw == jnp.uint32(1)
        is_coef = (f & 4) == 4
        is_tail = (f & 8) == 8
        a = (f >> 4) & 0x1F
        dn = (f >> 9) & 0xFF
        quant = _expand_quant((f >> 17) & 0x1F)
        s = ((a & 0xF) ^ 0x8) - 0x8
        val_coef = jnp.where(s < 0, -(s * s), s * s).astype(jnp.float32) * quant
        aa = (a * a).astype(jnp.float32) * quant
        lvl_in = jnp.where(
            is_coef,
            val_coef,
            jnp.where(
                is_tail, aa * jnp.float32(1.0 / 16), aa * jnp.float32(0.25)
            ),
        )
        dcy_in = jnp.where(
            is_tail,
            jnp.float32(1.0)
            + (dn * dn).astype(jnp.float32) * jnp.float32(-(2.0**-19)),
            0.0,
        )
        lvl = jnp.where(st, lvl_in, lvl)
        dcy = jnp.where(st, dcy_in, dcy)
        mag = jnp.where(st, lvl_in, mag)
        s2 = state ^ (state << 13)
        s2 = s2 ^ (s2 >> 17)
        s2 = s2 ^ (s2 << 5)
        state = jnp.where(draw, s2, state)
        bit = (state >> 31) & jnp.uint32(1)
        parity = jnp.where(st, jnp.uint32(0), parity)
        parity = jnp.where(draw, parity ^ bit, parity)
        sign = jnp.where(parity == 1, -1.0, 1.0).astype(jnp.float32)
        coef_ref[p] = jnp.where(
            is_coef, lvl, jnp.where(draw, mag * sign, 0.0)
        )
        # decay only inside tail runs (noise records carry dcy == 0)
        mag = jnp.where(draw & (dcy != 0.0), mag * dcy, mag)
        return state, parity, drw, lvl, mag, dcy

    seed = seed_ref[...]
    zu = jnp.zeros(seed.shape, jnp.uint32)
    zf = jnp.zeros(seed.shape, jnp.float32)
    out = lax.fori_loop(0, p_tot, body, (seed, zu, zu, zf, zf, zf))
    seed_out_ref[...] = out[0]


def rng_expand_kernel_call(flags, seed, p_tot: int, interpret: bool = False):
    """flags [G, P, L] i32 (packed per-position word); seed [G, L]
    u32. Returns (coef [G, P, L] f32, new_seed [G, L] u32)."""
    g, _, lanes = flags.shape
    kern = functools.partial(_rng_expand_kernel, p_tot=p_tot)
    return _call(
        kern, g, lanes, [(p_tot, lanes), (lanes,)],
        [
            jax.ShapeDtypeStruct((g, p_tot, lanes), jnp.float32),
            jax.ShapeDtypeStruct((g, lanes), jnp.uint32),
        ],
        interpret,
    )(flags, seed.astype(jnp.uint32))
