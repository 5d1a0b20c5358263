"""Top-level encoder: analysis + rate control + serialization.

Mirrors reference ulcEncoder.c: CBR performs the same binary search
over the coded-coefficient count against the bit budget (reference
:93-116) — but each probe costs only the cheap size-only scan pair, and
the stream is materialized once at the final count. ABR scales the
block's target rate by complexity/avg-complexity (:128-135); VBR maps
Quality -> target complexity -> coefficient count analytically
(:140-158).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ulcx.analysis.block import AnalyzedBlock, EncoderCarry, analyze_block
from ulcx.bitstream.encode import (
    encode_pass_materialize,
    encode_pass_size,
    prepare_block,
)
from ulcx.utils.config import CodecConfig, kernel_mode

_E_TO_E = np.float32(float.fromhex("0x1.E4EFB7p3"))  # e^e


class EncodedBlock(NamedTuple):
    data: jnp.ndarray        # [max_bytes] uint8
    size_bits: jnp.ndarray   # scalar i32 (byte aligned)
    complexity: jnp.ndarray  # scalar f32
    window_ctrl: jnp.ndarray # scalar i32


def max_block_bytes(cfg: CodecConfig) -> int:
    """Static serialization buffer bound (nybbles can't exceed ~2.2/coef)."""
    return 2 * cfg.n_chan * cfg.block_size


def cbr_bit_budget(cfg: CodecConfig, rate_kbps) -> jnp.ndarray:
    """Truncated bit budget per block (reference ulcEncoder.c:96)."""
    return (
        (jnp.float32(cfg.block_size) * jnp.float32(rate_kbps))
        * jnp.float32(1000.0 / cfg.rate_hz)
    ).astype(jnp.int32)


def _cbr_search_ladder(bd, n_nz, budget, cfg: CodecConfig, k: int = 16):
    """Parallel on-device rate search (vectorized form of the bisection).

    Each round evaluates k candidate coefficient counts *in one scan
    pair* (the candidate axis folds into the vector lanes), narrowing
    the bracket k-fold; ceil(log_k(P)) rounds make the result exact:
    the largest n with Size(n) <= budget. Identical to the reference's
    bisection whenever Size is monotone in n (it is, up to rare
    noise-fill flips), ~log2(P)/log_k(P) x fewer sequential steps.
    """
    p_tot = cfg.n_chan * cfg.block_size
    rounds = max(1, int(math.ceil(math.log(p_tot, k))))
    size_k = jax.vmap(lambda n: encode_pass_size(bd, n, cfg.noise_run_window))

    lo = jnp.int32(0)
    hi = n_nz.astype(jnp.int32)
    for _ in range(rounds):
        step = jnp.maximum((hi - lo + k - 1) // k, 1)
        cands = lo + step * jnp.arange(1, k + 1, dtype=jnp.int32)
        cands_c = jnp.minimum(cands, jnp.maximum(hi, 0))
        sizes = size_k(cands_c)
        feas = (sizes <= budget) & (cands <= hi)
        # largest feasible candidate -> new lo; smallest infeasible -> bound
        any_f = jnp.any(feas)
        best = jnp.max(jnp.where(feas, cands_c, lo))
        first_bad = jnp.min(jnp.where(feas | (cands > hi), jnp.int32(2**30), cands))
        lo = jnp.where(any_f, best, lo)
        hi = jnp.minimum(hi, first_bad - 1)
    return lo


def _cbr_search(bd, n_nz, budget, cfg: CodecConfig):
    """Vectorizable replica of the reference's bisection (ulcEncoder.c:98-115)."""
    p_tot = cfg.n_chan * cfg.block_size
    n_iter = int(math.ceil(math.log2(p_tot))) + 1

    def body(state, _):
        lo, hi, done = state
        n = (lo + hi) // 2
        size = encode_pass_size(bd, n, cfg.noise_run_window)
        run = ~done
        eq = size == budget
        lo2 = jnp.where(eq, n, jnp.where(size < budget, n, lo))
        hi2 = jnp.where(eq, hi, jnp.where(size > budget, n - 1, hi))
        done2 = done | eq | (lo2 >= hi2 - 1)
        return (
            jnp.where(run, lo2, lo),
            jnp.where(run, hi2, hi),
            jnp.where(run, done2, done),
        ), None

    lo0 = jnp.int32(0)
    hi0 = n_nz
    done0 = ~(lo0 < hi0)
    (lo, _, _), _ = lax.scan(body, (lo0, hi0, done0), None, length=n_iter)
    return lo


def _rate_search(bd, n_nz, budget, cfg: CodecConfig):
    if cfg.rate_search == "bisect":
        return _cbr_search(bd, n_nz, budget, cfg)
    return _cbr_search_ladder(bd, n_nz, budget, cfg)


def encode_analyzed_cbr(blk: AnalyzedBlock, rate_kbps, cfg: CodecConfig) -> EncodedBlock:
    bd = prepare_block(blk, cfg)
    budget = cbr_bit_budget(cfg, rate_kbps)
    n_out = _rate_search(bd, blk.n_nz, budget, cfg)
    size, data = encode_pass_materialize(bd, n_out, max_block_bytes(cfg), cfg.noise_run_window)
    return EncodedBlock(data, size, blk.complexity, blk.window_ctrl)


def encode_analyzed_abr(blk, rate_kbps, avg_complexity, cfg) -> EncodedBlock:
    target = jnp.float32(rate_kbps) * blk.complexity / jnp.float32(avg_complexity)
    bd = prepare_block(blk, cfg)
    budget = cbr_bit_budget(cfg, target)
    n_out = _rate_search(bd, blk.n_nz, budget, cfg)
    size, data = encode_pass_materialize(bd, n_out, max_block_bytes(cfg), cfg.noise_run_window)
    return EncodedBlock(data, size, blk.complexity, blk.window_ctrl)


def encode_analyzed_vbr(blk: AnalyzedBlock, quality, cfg: CodecConfig) -> EncodedBlock:
    bd = prepare_block(blk, cfg)
    target_cx = _E_TO_E * jnp.log(jnp.float32(100.0) / jnp.float32(quality))
    p_tot = cfg.n_chan * cfg.block_size
    f_target = jnp.float32(p_tot) * blk.complexity / jnp.where(target_cx > 0, target_cx, 1.0)
    n_out = jnp.where(
        (target_cx > 0) & (f_target < blk.n_nz.astype(jnp.float32)),
        f_target.astype(jnp.int32),
        blk.n_nz,
    )
    size, data = encode_pass_materialize(bd, n_out, max_block_bytes(cfg), cfg.noise_run_window)
    return EncodedBlock(data, size, blk.complexity, blk.window_ctrl)


# ---------------------------------------------------------------------------
# Block-step and stream-level drivers.


def encode_block(carry: EncoderCarry, new_block, cfg: CodecConfig, mode: str, **kw):
    """One full encode step: analysis + rate control + serialization.

    mode: 'cbr' (rate_kbps=), 'abr' (rate_kbps=, avg_complexity=),
    'vbr' (quality=).
    """
    carry, blk = analyze_block(carry, new_block, cfg)
    if mode == "cbr":
        enc = encode_analyzed_cbr(blk, kw["rate_kbps"], cfg)
    elif mode == "abr":
        enc = encode_analyzed_abr(blk, kw["rate_kbps"], kw["avg_complexity"], cfg)
    elif mode == "vbr":
        enc = encode_analyzed_vbr(blk, kw["quality"], cfg)
    else:
        raise ValueError(mode)
    return carry, enc


def _encode_analyzed(blk: AnalyzedBlock, cfg: CodecConfig, mode: str, **kw) -> EncodedBlock:
    if mode == "cbr":
        return encode_analyzed_cbr(blk, kw["rate_kbps"], cfg)
    if mode == "abr":
        return encode_analyzed_abr(blk, kw["rate_kbps"], kw["avg_complexity"], cfg)
    if mode == "vbr":
        return encode_analyzed_vbr(blk, kw["quality"], cfg)
    raise ValueError(mode)


def init_carry_batched(cfg: CodecConfig, batch: int):
    base = EncoderCarry.init(cfg)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape).copy(), base
    )


def _use_kernel(cfg: CodecConfig) -> bool:
    """Encode through the Pallas kernels (kernel_mode decides the
    backend and P <= 32768 envelope; any batch pads to the kernel's
    lane width). noise_run_window='gap' is scan-only."""
    return cfg.noise_run_window == "segment" and kernel_mode(cfg) != "off"


def _encode_analyzed_fast(blk: AnalyzedBlock, cfg: CodecConfig, mode: str, **kw):
    """Batched encode via the fused Pallas bitstream kernels."""
    from ulcx.bitstream.fast_encode import (
        materialize_fast,
        prepare_fast,
        search_materialize_fast,
    )

    interpret = kernel_mode(cfg) == "interpret"
    fb = prepare_fast(blk, cfg)
    p_tot = cfg.n_chan * cfg.block_size
    if mode == "vbr":
        target_cx = _E_TO_E * jnp.log(jnp.float32(100.0) / jnp.float32(kw["quality"]))
        f_target = (
            jnp.float32(p_tot) * blk.complexity / jnp.where(target_cx > 0, target_cx, 1.0)
        )
        n_out = jnp.where(
            (target_cx > 0) & (f_target < blk.n_nz.astype(jnp.float32)),
            f_target.astype(jnp.int32),
            blk.n_nz,
        )
        size, data = materialize_fast(fb, n_out, cfg, max_block_bytes(cfg), interpret)
    else:
        rate = jnp.float32(kw["rate_kbps"])
        if mode == "abr":
            rate = rate * blk.complexity / jnp.float32(kw["avg_complexity"])
        budget = (
            (jnp.float32(cfg.block_size) * rate) * jnp.float32(1000.0 / cfg.rate_hz)
        ).astype(jnp.int32)
        budget = jnp.broadcast_to(budget, blk.n_nz.shape)
        _, size, data = search_materialize_fast(
            fb, blk.n_nz, budget, cfg, max_block_bytes(cfg), interpret
        )
    return EncodedBlock(data, size, blk.complexity, blk.window_ctrl)


def encode_block_batched(carry, new_blocks, cfg: CodecConfig, mode: str, **kw):
    """Batched full encode step: carry leading [B], new_blocks [B, C, N].

    Analysis runs through the batch-native (branch-free) pipeline; the
    bitstream passes use the fused Pallas kernels when eligible, else
    vmap over the scan path.
    """
    from ulcx.analysis.batched import analyze_block_batched

    carry, blk = analyze_block_batched(carry, new_blocks, cfg)
    if _use_kernel(cfg):
        enc = _encode_analyzed_fast(blk, cfg, mode, **kw)
    else:
        enc = jax.vmap(lambda ab: _encode_analyzed(ab, cfg, mode, **kw))(blk)
    return carry, enc


def encode_stream_batched(blocks, cfg: CodecConfig, mode: str, carry=None,
                          scan_major: bool = False, **kw):
    """Encode [B, T, C, N] batched streams. Returns (EncodedBlock with
    leading [B, T], carry) — or leading [T, B] with scan_major=True:
    the block axis is scanned, so [T, B] is the layout the outputs are
    produced in, and scan_major skips the [T,B]->[B,T] relayout of the
    stacked byte planes. Throughput/bench paths pass scan_major=True
    and index [t, i].

    With cfg.flat_stream, only window control scans over blocks and
    everything else runs once over the flattened [B*T] batch
    (analyze_stream_batched) — byte-identical to the per-block scan
    (tests/test_stream_flat.py); the default is the per-block scan."""
    from ulcx.analysis.batched import analyze_stream_batched

    b, t = blocks.shape[0], blocks.shape[1]
    if carry is None:
        carry = init_carry_batched(cfg, b)

    if cfg.flat_stream:
        carry, ab = analyze_stream_batched(carry, blocks, cfg)
        if _use_kernel(cfg):
            enc = _encode_analyzed_fast(ab, cfg, mode, **kw)
        else:
            enc = jax.vmap(lambda a: _encode_analyzed(a, cfg, mode, **kw))(ab)
        out = jax.tree_util.tree_map(
            lambda x: x.reshape((b, t) + x.shape[1:]), enc
        )
        if scan_major:
            out = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), out)
        return out, carry

    fold = cfg.fold_bitstream
    if fold > 1 and t % fold == 0:
        # analysis stays a per-block scan (carried window control);
        # the bitstream stages run once per fold-block chunk at
        # fold*B streams — the kernel pipeline launches T/fold times
        # instead of T times, with identical bytes (streams are
        # independent; [T, B] -> [T/fold, fold*B] is a contiguous view)
        from ulcx.analysis.batched import analyze_block_batched

        def ana_step(c, blk_t):
            return analyze_block_batched(c, blk_t, cfg)

        carry, abs_t = lax.scan(ana_step, carry, blocks.transpose(1, 0, 2, 3))
        abf = jax.tree_util.tree_map(
            lambda x: x.reshape((t // fold, fold * b) + x.shape[2:]), abs_t
        )
        if _use_kernel(cfg):
            enc_fn = lambda ab: _encode_analyzed_fast(ab, cfg, mode, **kw)
        else:
            enc_fn = jax.vmap(lambda ab: _encode_analyzed(ab, cfg, mode, **kw))
        enc = lax.map(enc_fn, abf)
        reshape = lambda x: x.reshape((t, b) + x.shape[2:])
        if scan_major:
            out = jax.tree_util.tree_map(reshape, enc)
        else:
            out = jax.tree_util.tree_map(
                lambda x: jnp.swapaxes(reshape(x), 0, 1), enc
            )
        return out, carry

    def step(c, blk_t):
        return encode_block_batched(c, blk_t, cfg, mode, **kw)

    carry, out = lax.scan(step, carry, blocks.transpose(1, 0, 2, 3))
    if not scan_major:
        out = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), out)
    return out, carry


def encode_stream(blocks: jnp.ndarray, cfg: CodecConfig, mode: str, carry=None, **kw):
    """Encode [T, C, N] deinterleaved PCM blocks of ONE stream. Returns
    (EncodedBlock arrays stacked over T, final carry); pass the carry
    back in to continue a stream chunk by chunk.

    A single stream has no batch axis, so the block axis becomes one:
    this routes through encode_stream_batched with fold_bitstream = T —
    analysis stays a per-block scan (identical per-block shapes, so the
    output is bit-invariant to how the stream is chunked, which the
    checkpoint/resume contract relies on), while the prepare/kernel/
    assemble bitstream stages run ONCE over all T blocks as a batch
    rather than at batch 1 per block (the encode tool pads its chunks
    to 64).

    cfg.flat_stream=True additionally folds ANALYSIS over blocks
    (fastest single-stream form) — but the batched transform's matmul
    accumulation then depends on T, so encoded bytes can wobble at
    float boundaries with the chunk size (sizes/quality unaffected);
    opt-in only."""
    import dataclasses

    if carry is None:
        carry = EncoderCarry.init(cfg)
    t = blocks.shape[0]
    # fold_bitstream=1 (the default) means "no explicit preference":
    # fold the whole chunk, the fast single-stream form. A caller who
    # SET a fold (e.g. to bound the kernel state-plane memory on long
    # chunks) keeps it.
    if not cfg.flat_stream and cfg.fold_bitstream == 1:
        cfg = dataclasses.replace(cfg, fold_bitstream=t)
    carry_b = jax.tree_util.tree_map(lambda x: x[None], carry)
    out, carry_b = encode_stream_batched(
        blocks[None], cfg, mode, carry=carry_b, **kw
    )
    out = jax.tree_util.tree_map(lambda x: x[0], out)
    return out, jax.tree_util.tree_map(lambda x: x[0], carry_b)
