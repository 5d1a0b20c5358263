"""Pallas encode kernel vs the scan path (interpret mode on CPU)."""

import numpy as np
import jax
import jax.numpy as jnp

from test_encode_pass import synth_block, CFG, N, C
from ulcx.analysis.block import AnalyzedBlock
from ulcx.bitstream.encode import (
    encode_pass_materialize,
    encode_pass_size,
    prepare_block,
)
from ulcx.bitstream.fast_encode import (
    materialize_fast,
    prepare_fast,
    total_sizes,
)

B = 8


def _batched_blocks(rng, wcs):
    pass_through = None
    blks, bds, raw = [], [], []
    for wc in wcs:
        blk, coef, noise, rank = synth_block(
            rng, wc, sparsity=float(rng.uniform(0.2, 0.8))
        )
        blks.append(blk)
        bds.append(prepare_block(blk, CFG))
        raw.append((coef, noise, rank))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blks)
    return batched, bds, raw


def test_kernel_sizes_match_scan(rng):
    """B=8 batch rides the kernel via the 128-lane padding path."""
    wcs = [0x10, 0x10, 0x28, 0x59, 0xFB, 0x10, 0x3A, 0x6C]
    batched, bds, _ = _batched_blocks(rng, wcs)
    fb = prepare_fast(batched, CFG)
    size_scan = jax.jit(lambda bd, k: encode_pass_size(bd, k, "segment"))

    nouts = np.stack(
        [np.linspace(5, 2 * N - 1, 8).astype(np.int32) for _ in range(B)]
    )
    got = np.asarray(
        jax.jit(lambda f, n: total_sizes(f, n, CFG, interpret=True))(
            fb, jnp.asarray(nouts)
        )
    )
    assert got.shape == (B, 8)  # padding sliced back off
    for i in range(B):
        for j in range(8):
            want = int(size_scan(bds[i], jnp.int32(int(nouts[i, j]))))
            assert got[i, j] == want, (i, j, wcs[i], int(nouts[i, j]), got[i, j], want)


def test_kernel_materialize_matches_scan(rng):
    wcs = [0x10, 0x28, 0x59, 0xFB, 0x10, 0x3A, 0x6C, 0x10]
    batched, bds, _ = _batched_blocks(rng, wcs)
    fb = prepare_fast(batched, CFG)
    n_out = jnp.asarray(
        rng.integers(20, 2 * N - 1, B).astype(np.int32)
    )
    sizes, bys = jax.jit(
        lambda f, n: materialize_fast(f, n, CFG, 2 * C * N, interpret=True)
    )(fb, n_out)
    sizes, bys = np.asarray(sizes), np.asarray(bys)
    for i in range(B):
        want_bits, want_by = jax.jit(
            lambda bd, k: encode_pass_materialize(bd, k, 2 * C * N, "segment")
        )(bds[i], n_out[i])
        want_bits = int(want_bits)
        assert sizes[i] == want_bits, (i, wcs[i], sizes[i], want_bits)
        nb = want_bits // 8
        assert bys[i, :nb].tobytes() == np.asarray(want_by)[:nb].tobytes(), (
            i,
            wcs[i],
        )


def test_search_materialize_fused(rng):
    """Fused search+materialize == separate ladder + materialize."""
    from ulcx.bitstream.fast_encode import (
        materialize_fast,
        rate_search_fast,
        search_materialize_fast,
    )

    wcs = [0x10, 0x28, 0x59, 0xFB, 0x10, 0x3A, 0x6C, 0x10]
    batched, bds, _ = _batched_blocks(rng, wcs)
    fb = prepare_fast(batched, CFG)
    n_nz = jnp.full(B, 2 * N, jnp.int32)
    budget = jnp.full(B, int(N * 128.0 * 1000 / 44100), jnp.int32)

    n1 = rate_search_fast(fb, n_nz, budget, CFG, interpret=True)
    s1, b1 = materialize_fast(fb, n1, CFG, 2 * C * N, interpret=True)
    n2, s2, b2 = search_materialize_fast(fb, n_nz, budget, CFG, 2 * C * N, True)
    assert (np.asarray(n1) == np.asarray(n2)).all(), (np.asarray(n1), np.asarray(n2))
    assert (np.asarray(s1) == np.asarray(s2)).all()
    assert (np.asarray(b1) == np.asarray(b2)).all()
    assert (np.asarray(s1) <= int(N * 128.0 * 1000 / 44100) + 7).all()


def test_kernel_padding_matches_scan(rng):
    """Non-128 batches (here 24 -> padded to 128 lanes) are byte-exact
    vs the scan path — pad lanes parse as inert zero planes and are
    sliced off)."""
    from ulcx.bitstream.fast_encode import materialize_fast

    nb = 24
    wcs = [int(w) for w in rng.choice([0x10, 0x28, 0x59, 0xFB, 0x3A, 0x6C], nb)]
    batched, bds, _ = _batched_blocks(rng, wcs)
    fb = prepare_fast(batched, CFG)
    nout = jnp.broadcast_to(
        (jnp.arange(8) * 64 + 16)[None, :], (nb, 8)
    ).astype(jnp.int32)
    got = np.asarray(
        jax.jit(lambda f, n: total_sizes(f, n, CFG, interpret=True))(fb, nout)
    )
    assert got.shape == (nb, 8)
    size_scan = jax.jit(lambda bd, k: encode_pass_size(bd, k, "segment"))
    for i in range(0, nb, 5):
        for j in range(0, 8, 3):
            want = int(size_scan(bds[i], nout[i, j]))
            assert got[i, j] == want, (i, j, wcs[i], got[i, j], want)

    n_out = jnp.asarray(rng.integers(20, 2 * N - 1, nb).astype(np.int32))
    sizes, bys = jax.jit(
        lambda f, n: materialize_fast(f, n, CFG, 2 * C * N, interpret=True)
    )(fb, n_out)
    assert np.asarray(sizes).shape == (nb,)
    for i in range(0, nb, 7):
        want_bits, want_by = jax.jit(
            lambda bd, k: encode_pass_materialize(bd, k, 2 * C * N, "segment")
        )(bds[i], n_out[i])
        nbytes = int(want_bits) // 8
        assert int(sizes[i]) == int(want_bits), (i, wcs[i])
        assert np.asarray(bys)[i, :nbytes].tobytes() == np.asarray(want_by)[:nbytes].tobytes()


def test_kernel_v3_matches_scan(rng):
    """128-stream transposed kernels (candidates in rows, no input
    replication) == scan path (sizes + bytes)."""
    from ulcx.bitstream.fast_encode import (
        materialize_fast,
        rate_search_fast,
    )
    from ulcx.bitstream.pallas_encode3 import N_CAND

    nb = 128
    assert N_CAND == 8
    wcs = [int(w) for w in rng.choice([0x10, 0x28, 0x59, 0xFB, 0x3A, 0x6C], nb)]
    batched, bds, _ = _batched_blocks(rng, wcs)
    fb = prepare_fast(batched, CFG)
    nout = jnp.broadcast_to(
        (jnp.arange(8) * 64 + 16)[None, :], (nb, 8)
    ).astype(jnp.int32)
    got = np.asarray(
        jax.jit(lambda f, n: total_sizes(f, n, CFG, interpret=True))(fb, nout)
    )
    size_scan = jax.jit(lambda bd, k: encode_pass_size(bd, k, "segment"))
    for i in range(0, nb, 16):
        for j in range(0, 8, 3):
            want = int(size_scan(bds[i], nout[i, j]))
            assert got[i, j] == want, (i, j, wcs[i], got[i, j], want)

    n_out = jnp.asarray(rng.integers(20, 2 * N - 1, nb).astype(np.int32))
    sizes, bys = jax.jit(
        lambda f, n: materialize_fast(f, n, CFG, 2 * C * N, interpret=True)
    )(fb, n_out)
    for i in range(0, nb, 21):
        want_bits, want_by = jax.jit(
            lambda bd, k: encode_pass_materialize(bd, k, 2 * C * N, "segment")
        )(bds[i], n_out[i])
        nbytes = int(want_bits) // 8
        assert int(sizes[i]) == int(want_bits), (i, wcs[i])
        assert np.asarray(bys)[i, :nbytes].tobytes() == np.asarray(want_by)[:nbytes].tobytes()

    # 4-round 8-candidate ladder lands on the largest feasible count
    n_nz = jnp.full(nb, 2 * N, jnp.int32)
    budget = jnp.full(nb, int(N * 128.0 * 1000 / 44100), jnp.int32)
    n_sel = rate_search_fast(fb, n_nz, budget, CFG, interpret=True)
    s_sel, b_sel = materialize_fast(fb, n_sel, CFG, 2 * C * N, interpret=True)
    assert (np.asarray(s_sel) <= int(N * 128.0 * 1000 / 44100) + 7).all()

    # fused final round (search_materialize_fast) == separate search +
    # materialize, bytes and all
    from ulcx.bitstream.fast_encode import search_materialize_fast

    n_f, s_f, b_f = search_materialize_fast(
        fb, n_nz, budget, CFG, 2 * C * N, True
    )
    np.testing.assert_array_equal(np.asarray(n_f), np.asarray(n_sel))
    np.testing.assert_array_equal(np.asarray(s_f), np.asarray(s_sel))
    np.testing.assert_array_equal(np.asarray(b_f), np.asarray(b_sel))
