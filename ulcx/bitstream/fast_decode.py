"""Kernel-backed batched decoder path.

Pipeline per block (batch of streams):
  byte windows -> nybbles -> [FSM kernel] records -> gather-free record
  placement at record starts -> [RNG kernel] noise signs, record fill
  and coefficients.

Used by ulcx.codec.decoder.decode_stream_batched when
ulcx.utils.config.kernel_mode allows; the scan path remains the
bit-identical reference.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ulcx.bitstream import pallas_decode as pd
from ulcx.bitstream.decode import REC_COEF, REC_NOISE, REC_TAIL
from ulcx.utils.config import CodecConfig


def _lanes(b: int, interpret: bool) -> int:
    """Streams per kernel program: the tuned pd.LANES when compiled; the
    whole padded batch as one program in interpret mode (the
    interpreter's cost is per sequential step)."""
    if interpret:
        return -(-b // pd.LANES) * pd.LANES
    return pd.LANES


def _to_lanes(x, lanes: int, fill=0):
    """[B, ...] -> [G, ..., lanes], the batch padded with `fill` to a
    multiple of lanes."""
    b = x.shape[0]
    pad = -b % lanes
    if pad:
        x = jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)], axis=0
        )
    x = x.reshape((-1, lanes) + x.shape[1:])
    return jnp.moveaxis(x, 1, -1)


def _from_lanes(x, b: int):
    """[G, ..., L] -> [B, ...]."""
    x = jnp.moveaxis(x, -1, 1)
    return x.reshape((-1,) + x.shape[2:])[:b]


def fsm_records(windows, cfg: CodecConfig, interpret=False):
    """FSM pass only: windows [B, W] uint8 at block starts ->
    (rec [B, R], code [B, R], wc [B], hdr [B], consumed [B],
    corrupt [B] i32)."""
    n = cfg.block_size
    p_tot = n * cfg.n_chan
    b, w_bytes = windows.shape

    lo = (windows & 0xF).astype(jnp.int32)
    hi = (windows >> 4).astype(jnp.int32)
    nyb = jnp.stack([lo, hi], axis=-1).reshape(b, 2 * w_bytes)

    wc0 = nyb[:, 0]
    has2 = (wc0 & 0x8) != 0
    wc = jnp.where(has2, wc0 | (nyb[:, 1] << 4), wc0 | (1 << 4)).astype(jnp.int32)
    hdr = jnp.where(has2, 2, 1).astype(jnp.int32)
    t_len = 2 * w_bytes - 2
    tokens = jnp.where(has2[:, None], nyb[:, 2 : t_len + 2], nyb[:, 1 : t_len + 1])

    lanes = _lanes(b, interpret)
    rec, code, consumed, corrupt = pd.fsm_kernel_call(
        _to_lanes(wc, lanes, 0x10), _to_lanes(tokens, lanes), p_tot, n,
        interpret,
    )
    rec = _from_lanes(rec, b)
    code = _from_lanes(code, b)
    consumed = _from_lanes(consumed, b)
    corrupt = _from_lanes(corrupt, b)
    return rec, code, wc, hdr, consumed, corrupt


def _mm_place(emit, start, meta, p_tot: int):
    """Record placement as a factorized one-hot int8 matmul.

    plane[b, hi*128 + lo] = sum_r onehot_hi(start) * meta * onehot_lo
    with meta split into four 7-bit parts so every operand fits int8
    and the s32 accumulation is exact integer arithmetic (each position
    receives at most ONE record — starts are strictly increasing)."""
    b, r = meta.shape
    nhi = p_tot // 128
    hi = jnp.where(emit, start >> 7, nhi)  # nhi = off-grid drop bucket
    lo = start & 127
    kk = jnp.arange(4, dtype=jnp.int32)
    parts = (meta[:, None, :] >> (7 * kk[None, :, None])) & 0x7F  # [B,4,R]
    hgrid = jnp.arange(nhi, dtype=jnp.int32)
    oh_hi = hi[:, None, :] == hgrid[None, :, None]  # [B,nhi,R]
    u = (oh_hi[:, None] * parts[:, :, None]).astype(jnp.int8)
    u = u.reshape(b, 4 * nhi, r)
    lgrid = jnp.arange(128, dtype=jnp.int32)
    v = ((lo[:, :, None] == lgrid[None, None, :]) & emit[:, :, None])
    v = v.astype(jnp.int8)  # [B,R,128]
    out = lax.dot_general(
        u, v, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    ).reshape(b, 4, nhi, 128)
    sh = (7 * kk)[None, :, None, None]
    return jnp.sum(out << sh, axis=1).reshape(b, p_tot)


def records_to_flags(rec, code, p_tot: int):
    """Expansion inputs: place records at their start positions — ONE
    packed word per record (flags + level/decay/quantizer codes); the
    RNG kernel latches the draw bit at record starts itself, so no
    forward fill follows. Placement is the _mm_place int8 matmul;
    ULCX_RECSCATTER=scatter selects the .at[].set form. Returns flags
    [B, p_tot] i32."""
    import os

    b = rec.shape[0]
    rtype = (rec >> 15) & 0x7
    start = rec & 0x7FFF
    emit = rtype != 0

    draw_rec = (rtype == REC_NOISE) | (rtype == REC_TAIL)
    meta = jnp.where(
        emit,
        1 | (draw_rec.astype(jnp.int32) << 1)
        | ((rtype == REC_COEF).astype(jnp.int32) << 2)
        | ((rtype == REC_TAIL).astype(jnp.int32) << 3)
        | (code << 4),
        0,
    )
    if p_tot % 128 == 0 and os.environ.get("ULCX_RECSCATTER", "mm") != "scatter":
        return _mm_place(emit, start, meta, p_tot)
    bidx = jnp.arange(b)[:, None]
    tgt = jnp.where(emit, start, p_tot)  # non-records -> drop slot
    zi = jnp.zeros((b, p_tot), jnp.int32)
    return zi.at[bidx, tgt].set(meta, mode="drop", unique_indices=True)


def draw_counts(flags):
    """Per-stream count of RNG-draw positions, matching the kernel's
    in-loop latch exactly (a draw record's region extends to the NEXT
    record start — or the plane end for the final record, which is how
    a corrupt/truncated stream behaves on both decode paths). One
    associative scan over the [B, P] plane; used only by the pipelined
    single-stream path (decode_stream_pipelined), where it runs ONCE
    for all blocks, never inside the per-block hot loop."""

    def combine(l, r):
        return jnp.where((r & 1) == 1, r, l)

    filled = lax.associative_scan(combine, flags, axis=flags.ndim - 1)
    return jnp.sum((filled >> 1) & 1, axis=flags.ndim - 1)


def expand_coefs(flags, rng_state, p_tot: int, interpret=False):
    """Fused RNG replay + record fill + coefficient assembly
    (pd.rng_expand_kernel_call). flags [B, p_tot] i32 from
    records_to_flags; rng_state [B] u32. The RNG state advances exactly
    once per draw position (the kernel latches the record's draw bit at
    each start), so new_rng equals the seed stepped draw_counts(flags)
    times. Returns (coefs [B, p_tot], new_rng)."""
    b = flags.shape[0]
    lanes = _lanes(b, interpret)
    coefs, new_seed = pd.rng_expand_kernel_call(
        _to_lanes(flags, lanes), _to_lanes(rng_state, lanes, 1234567), p_tot,
        interpret,
    )
    return _from_lanes(coefs, b), _from_lanes(new_seed, b)


def decode_block_fast(windows, rng_state, cfg: CodecConfig, interpret=False):
    """windows: [B, W] uint8 at block starts; rng_state [B] uint32.
    Returns (coefs [B, C, N], window_ctrl [B], bits [B], corrupt [B],
    new_rng [B])."""
    n, c = cfg.block_size, cfg.n_chan
    p_tot = n * c
    b = windows.shape[0]
    rec, code, wc, hdr, consumed, corrupt = fsm_records(windows, cfg, interpret)
    flags = records_to_flags(rec, code, p_tot)
    coefs, new_seed = expand_coefs(flags, rng_state, p_tot, interpret)
    coefs = jnp.where(corrupt[:, None] == 1, 0.0, coefs)
    bits = 4 * (hdr + consumed)
    return coefs.reshape(b, c, n), wc, bits, corrupt == 1, new_seed
