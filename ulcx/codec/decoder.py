"""Block/stream decoder: bitstream FSM -> coefficients -> IMDCT -> PCM.

Mirrors reference ULC_DecodeBlock (ulcDecoder.c:198-302): parse the
window-control header, decode every (channel, subblock) segment's
coefficients, inverse-transform with deferred-window lapping, undo the
pairwise M/S. State carried across blocks is a pytree (inverse lap,
last subblock size, xorshift RNG) — trivially checkpointable and
scan/vmap-friendly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ulcx.bitstream.decode import decode_block_tokens, expand_records
from ulcx.codec.transform import block_imdct
from ulcx.utils.config import CodecConfig


class DecoderCarry(NamedTuple):
    lap: jnp.ndarray           # [C, N/2]
    prev_last_ss: jnp.ndarray  # scalar i32
    rng: jnp.ndarray           # scalar u32 (reference's global seed 1234567)

    @staticmethod
    def init(cfg: CodecConfig):
        return DecoderCarry(
            lap=jnp.zeros((cfg.n_chan, cfg.block_size // 2), jnp.float32),
            prev_last_ss=jnp.int32(0),
            rng=jnp.uint32(1234567),
        )


def inverse_ms(block: jnp.ndarray) -> jnp.ndarray:
    """Undo pairwise M/S: (m, s) -> (m+s, m-s) (reference :280-289)."""
    c = block.shape[-2]
    if c < 2:
        return block
    npair = c // 2
    pairs = block[..., : 2 * npair, :].reshape(block.shape[:-2] + (npair, 2, block.shape[-1]))
    a = pairs[..., 0, :] + pairs[..., 1, :]
    b = pairs[..., 0, :] - pairs[..., 1, :]
    out = jnp.stack([a, b], axis=-2).reshape(block.shape[:-2] + (2 * npair, block.shape[-1]))
    if c > 2 * npair:
        out = jnp.concatenate([out, block[..., 2 * npair :, :]], axis=-2)
    return out


def bytes_to_nybbles(by: jnp.ndarray) -> jnp.ndarray:
    """uint8 [W] -> int32 nybbles [2W], low nibble first."""
    lo = (by & 0xF).astype(jnp.int32)
    hi = (by >> 4).astype(jnp.int32)
    return jnp.stack([lo, hi], axis=-1).reshape(by.shape[:-1] + (2 * by.shape[-1],))


def decode_block(window: jnp.ndarray, carry: DecoderCarry, cfg: CodecConfig):
    """Decode one block from a byte window.

    window: [W] uint8 starting at the block boundary (W static, at least
    the container's max block size). Returns
    (pcm [C, N], new_carry, bits_consumed, corrupt).
    """
    n, c = cfg.block_size, cfg.n_chan
    p_tot = n * c
    nyb = bytes_to_nybbles(window)
    wc = nyb[0]
    has2 = (wc & 0x8) != 0
    wc = jnp.where(has2, wc | (nyb[1] << 4), wc | (1 << 4)).astype(jnp.int32)
    hdr = jnp.where(has2, 2, 1).astype(jnp.int32)

    t_len = nyb.shape[0] - 2
    tokens = lax.dynamic_slice(nyb, (hdr,), (t_len,))
    records, consumed, corrupt = decode_block_tokens(tokens, wc, cfg)
    flat, rng = expand_records(records, carry.rng, p_tot)
    flat = jnp.where(corrupt, 0.0, flat)
    coefs = flat.reshape(c, n)

    pcm, lap, last_ss = block_imdct(coefs, wc, carry.lap, carry.prev_last_ss, cfg)
    pcm = inverse_ms(pcm)

    new_carry = DecoderCarry(lap=lap, prev_last_ss=last_ss, rng=rng)
    bits = 4 * (hdr + consumed)
    return pcm, new_carry, bits, corrupt


def decode_stream_batched(
    streams: jnp.ndarray,
    n_blocks: int,
    window_bytes: int,
    cfg: CodecConfig,
    interpret: bool = False,
):
    """Kernel-backed batched stream decode.

    streams: [B, S] uint8 (each padded so every window slice is in
    bounds). Returns (pcm [B, n_blocks, C, N], bits [B, n_blocks],
    corrupt [B, n_blocks]).
    """
    from ulcx.bitstream.fast_decode import decode_block_fast
    from ulcx.codec.transform_batched import block_imdct_batched

    b = streams.shape[0]
    # Per-stream byte-granular window gathers are the decode path's
    # single costliest stage on this backend (u8 gather, one element
    # per byte). Slice WORDS instead — 4x fewer gathered elements —
    # and realign the 0..3-byte phase with a 4-way select of static
    # slices (byte-identical windows).
    s_pad = (-streams.shape[1]) % 4
    streams_w = jnp.concatenate(
        [streams, jnp.zeros((b, s_pad + 4), jnp.uint8)], axis=1
    ).reshape(b, -1, 4)
    streams_w = jnp.sum(
        streams_w.astype(jnp.int32) << (8 * jnp.arange(4))[None, None, :],
        axis=-1,
        dtype=jnp.int32,
    )  # [B, S/4] little-endian words
    # +3 rounds up so the worst-case phase slice byt[3:3+window_bytes]
    # stays in bounds for every window_bytes % 4 (not just 0/1)
    n_words = (window_bytes + 3) // 4 + 1

    def step(state, _):
        offset, lap, prev_ss, rng = state
        words = jax.vmap(
            lambda s, o: lax.dynamic_slice(s, (o,), (n_words,))
        )(streams_w, offset >> 2)
        sh = (8 * jnp.arange(4)).astype(jnp.int32)
        byt = (
            (words[:, :, None] >> sh[None, None, :]) & 0xFF
        ).astype(jnp.uint8).reshape(b, 4 * n_words)
        phase = (offset & 3)[:, None]
        windows = byt[:, 0:window_bytes]
        for k in (1, 2, 3):
            windows = jnp.where(
                phase == k, byt[:, k : k + window_bytes], windows
            )
        coefs, wc, bits, corrupt, rng = decode_block_fast(
            windows, rng, cfg, interpret
        )
        pcm, lap, prev_ss = block_imdct_batched(coefs, wc, lap, prev_ss, cfg)
        pcm = inverse_ms(pcm)
        offset = offset + (bits + 7) // 8
        return (offset, lap, prev_ss, rng), (pcm, bits, corrupt)

    init = (
        jnp.zeros(b, jnp.int32),
        jnp.zeros((b, cfg.n_chan, cfg.block_size // 2), jnp.float32),
        jnp.zeros(b, jnp.int32),
        jnp.full(b, 1234567, jnp.uint32),
    )
    _, (pcm, bits, corrupt) = lax.scan(step, init, None, length=n_blocks)
    return (
        jnp.swapaxes(pcm, 0, 1),
        jnp.swapaxes(bits, 0, 1),
        jnp.swapaxes(corrupt, 0, 1),
    )


def decode_stream(
    stream: jnp.ndarray,
    n_blocks: int,
    window_bytes: int,
    cfg: CodecConfig,
    offset=None,
    carry=None,
):
    """Decode ``n_blocks`` blocks from a padded byte stream.

    stream: [S] uint8 (padded so that every window slice is in bounds).
    Returns (pcm [n_blocks, C, N], bits [n_blocks], corrupt [n_blocks],
    (offset, carry)) — feed (offset, carry) back in to continue.
    """

    def step(state, _):
        offset, carry = state
        window = lax.dynamic_slice(stream, (offset,), (window_bytes,))
        pcm, carry, bits, corrupt = decode_block(window, carry, cfg)
        offset = offset + (bits + 7) // 8
        return (offset, carry), (pcm, bits, corrupt)

    if offset is None:
        offset = jnp.int32(0)
    if carry is None:
        carry = DecoderCarry.init(cfg)
    state, (pcm, bits, corrupt) = lax.scan(step, (offset, carry), None, length=n_blocks)
    return pcm, bits, corrupt, state


def decode_stream_pipelined(
    stream: jnp.ndarray,
    n_blocks: int,
    window_bytes: int,
    cfg: CodecConfig,
    offset=None,
    carry=None,
    interpret: bool = False,
):
    """Single-stream decode with the serial work cut to the FSM alone.

    decode_stream runs the FULL per-block pipeline inside the block
    scan, paying every stage's per-step fixed cost at batch 1. The block chain
    has exactly three cross-block dependencies, and each one unlocks:

      offsets  — bits consumed come out of the FSM, so a lean FSM-only
                 scan (kernel FSM + window word-slicing, nothing else)
                 resolves every block start;
      RNG      — the reference's stream-global xorshift32 advances once
                 per draw position, so per-block draw counts (popcount
                 of the filled draw flags) + GF(2) jump-ahead
                 (ulcx.ops.rngjump) give every block its exact entry
                 seed;
      lap      — new_lap depends only on the CURRENT block's synthesis
                 (the previous block's contribution never reaches the
                 spill region — transform_batched.block_imdct_batched),
                 so laps compute in one batched pass and shift by one.

    Everything after the FSM scan (expansion, RNG replay, double IMDCT,
    M/S) then runs ONCE over all n_blocks as a batch. The second IMDCT
    pass (laps, then pcm with shifted laps) costs 2x transform FLOPs —
    cheap against the per-block fixed costs it removes.

    Same interface/results as decode_stream: (pcm [T, C, N], bits [T],
    corrupt [T], (offset, carry)); bits and RNG integer state are
    exact, pcm is float-level equal (batched IMDCT accumulation).
    """
    from ulcx.bitstream.fast_decode import (
        draw_counts,
        expand_coefs,
        fsm_records,
        records_to_flags,
    )
    from ulcx.codec.transform_batched import (
        block_imdct_batched,
        last_subblock_size,
    )
    from ulcx.ops.rngjump import jump

    n, c = cfg.block_size, cfg.n_chan
    p_tot = n * c
    if offset is None:
        offset = jnp.int32(0)
    if carry is None:
        carry = DecoderCarry.init(cfg)

    # word-pack the stream once (byte-granular u8 slices are the decode
    # path's costliest op on this backend — see decode_stream_batched)
    s_pad = (-stream.shape[0]) % 4
    sw = jnp.concatenate([stream, jnp.zeros(s_pad + 4, jnp.uint8)]).reshape(-1, 4)
    sw = jnp.sum(
        sw.astype(jnp.int32) << (8 * jnp.arange(4))[None, :],
        axis=-1,
        dtype=jnp.int32,
    )
    n_words = (window_bytes + 3) // 4 + 1

    def fsm_step(off, _):
        words = lax.dynamic_slice(sw, (off >> 2,), (n_words,))
        sh = (8 * jnp.arange(4)).astype(jnp.int32)
        byt = ((words[:, None] >> sh[None, :]) & 0xFF).astype(jnp.uint8)
        byt = byt.reshape(4 * n_words)
        window = byt[0:window_bytes]
        for k in (1, 2, 3):
            window = jnp.where(
                (off & 3) == k, byt[k : k + window_bytes], window
            )
        rec, code, wc, hdr, consumed, corrupt = fsm_records(
            window[None], cfg, interpret
        )
        bits = 4 * (hdr[0] + consumed[0])
        off = off + (bits + 7) // 8
        return off, (rec[0], code[0], wc[0], bits, corrupt[0])

    offset_out, (rec, code, wc, bits, corrupt) = lax.scan(
        fsm_step, jnp.asarray(offset, jnp.int32), None, length=n_blocks
    )

    flags = records_to_flags(rec, code, p_tot)  # [T, p_tot]
    draws = draw_counts(flags)
    cum_excl = jnp.cumsum(draws) - draws
    seeds = jump(jnp.broadcast_to(carry.rng, cum_excl.shape), cum_excl)
    coefs, seed_after = expand_coefs(flags, seeds, p_tot, interpret)
    coefs = jnp.where(corrupt[:, None] == 1, 0.0, coefs)
    coefs = coefs.reshape(n_blocks, c, n)

    last_ss = last_subblock_size(wc, cfg)
    prev_ss = jnp.concatenate([carry.prev_last_ss[None], last_ss[:-1]])
    zlap = jnp.zeros((n_blocks, c, n // 2), jnp.float32)
    _, new_lap, _ = block_imdct_batched(coefs, wc, zlap, prev_ss, cfg)
    lap_in = jnp.concatenate([carry.lap[None], new_lap[:-1]])
    pcm, _, _ = block_imdct_batched(coefs, wc, lap_in, prev_ss, cfg)
    pcm = inverse_ms(pcm)

    new_carry = DecoderCarry(
        lap=new_lap[-1], prev_last_ss=last_ss[-1], rng=seed_after[-1]
    )
    return pcm, bits, corrupt == 1, (offset_out, new_carry)
