"""Parallel-prefix helpers for the codec's first-order recurrences.

The reference's transient detector is built from exponential-moving-
average smears over the block (reference
libulc/ulcEncoder_WindowControl.c:72-134): x[n] = r*x[n-1] + (1-r)*v[n].
A constant-coefficient first-order recurrence is a linear filter, so
we evaluate it as Toeplitz matmuls instead of a sample loop.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import lax

# Precision of the EMA matmuls. On an H100 HIGH runs the products in
# TF32: the EMA's relative error against float64 is ~1.3e-4 instead of
# ~5e-7 at HIGHEST, and no transient decision of the window control
# changed over 4096 headline blocks. The consumers are log-ratio
# threshold tests, already tolerance-bounded against the float64 oracle.
EMA_PRECISION = lax.Precision.HIGH


@lru_cache(maxsize=64)
def _ema_matrix(length: int, rate: float) -> np.ndarray:
    """Lower-triangular Toeplitz kernel of the EMA as a linear filter:
    L[i, j] = (1-r) * r^(i-j) for j <= i (float64 powers, f32 cast)."""
    i = np.arange(length)
    d = i[:, None] - i[None, :]
    with np.errstate(over="ignore", under="ignore"):
        mat = (1.0 - rate) * np.power(float(rate), np.maximum(d, 0).astype(np.float64))
    mat = np.where(d >= 0, mat, 0.0)
    return mat.astype(np.float32)


@lru_cache(maxsize=64)
def _ema_init_weights(length: int, rate: float) -> np.ndarray:
    return np.power(float(rate), np.arange(1, length + 1, dtype=np.float64)).astype(
        np.float32
    )


def ema_matmul(v: jnp.ndarray, rate: float, init, reverse: bool = False):
    """EMA along the last axis as one matmul (static python rate).

    Float association differs from the sequential form by O(eps) only
    (the kernel is a convergent geometric series). The products run at
    EMA_PRECISION.
    """
    n = v.shape[-1]
    if reverse:
        v = v[..., ::-1]
    mat = jnp.asarray(_ema_matrix(n, float(rate)))
    out = jnp.matmul(v, mat.T, precision=EMA_PRECISION)
    init = jnp.asarray(init, v.dtype)
    out = out + init[..., None] * jnp.asarray(_ema_init_weights(n, float(rate)))
    if reverse:
        out = out[..., ::-1]
    return out


def ema_matmul_chunked(
    v: jnp.ndarray, rate: float, init, reverse: bool = False, chunk: int = 1024
):
    """EMA along the last axis as per-chunk Toeplitz matmuls plus an
    exact cross-chunk carry recurrence.

    Splitting x[m] = (1-r)*sum_{i<=m} r^(m-i) v[i] + r^(m+1)*x[-1] at
    chunk boundaries m = j*K + i gives
        x[jK+i] = local[j, i] + r^(i+1) * c_j
    where ``local`` is the K-point EMA of chunk j from a zero initial
    state (one [K, K] Toeplitz matmul shared across chunks) and the
    chunk-boundary values obey c_{j+1} = local[j, K-1] + r^K * c_j —
    a J-term affine recurrence closed with one tiny [J, J] matmul.

    Same result as ``ema_matmul`` up to float association, at N*K MACs
    instead of N^2 and with an O(K^2) kernel constant instead of O(N^2)
    (the N=4096 dense constant is ~67 MB; see
    window_control._transient_filtering).
    """
    n = v.shape[-1]
    if n <= chunk:
        return ema_matmul(v, rate, init, reverse=reverse)
    assert n % chunk == 0, (n, chunk)
    j_chunks, k = n // chunk, chunk
    if reverse:
        v = v[..., ::-1]
    r = float(rate)
    mat = jnp.asarray(_ema_matrix(k, r))
    vr = v.reshape(v.shape[:-1] + (j_chunks, k))
    local = jnp.matmul(vr, mat.T, precision=EMA_PRECISION)  # [..., J, K]

    # carry c_j = x[j*K - 1]: c_0 = init, c_{j+1} = e_j + r^K * c_j
    e = local[..., : j_chunks - 1, -1]  # e_0 .. e_{J-2}
    jj = np.arange(j_chunks)
    with np.errstate(over="ignore", under="ignore"):
        tri = np.power(r, (k * (jj[:, None] - 1 - jj[None, :])).astype(np.float64))
    tri = np.where(jj[:, None] - 1 - jj[None, :] >= 0, tri, 0.0)[:, : j_chunks - 1]
    init = jnp.asarray(init, v.dtype)
    # HIGHEST: the carry feeds every position of its chunk, and the
    # matmul is [J-1, J]-tiny, so full f32 costs nothing.
    c = jnp.matmul(
        e, jnp.asarray(tri.astype(np.float32)).T, precision=lax.Precision.HIGHEST
    ) + init[..., None] * jnp.asarray(
        np.power(r, (k * jj).astype(np.float64)).astype(np.float32)
    )  # [..., J]
    out = local + c[..., None] * jnp.asarray(_ema_init_weights(k, r))
    out = out.reshape(v.shape)
    if reverse:
        out = out[..., ::-1]
    return out


def ema(v: jnp.ndarray, rate, init, axis: int = -1, reverse: bool = False):
    """Run x[n] = rate*x[n-1] + (1-rate)*v[n] along ``axis``.

    Returns the *post-update* envelope at every position (same shape as
    v). ``init`` is x[-1] and broadcasts against v with ``axis`` removed.
    """
    if axis < 0:
        axis += v.ndim
    r = jnp.asarray(rate, v.dtype)
    a = jnp.broadcast_to(r, v.shape)
    b = (1 - r) * v

    def combine(l, rgt):
        a1, b1 = l
        a2, b2 = rgt
        return a1 * a2, b1 * a2 + b2

    pa, pb = lax.associative_scan(combine, (a, b), axis=axis, reverse=reverse)
    init = jnp.asarray(init, v.dtype)
    if init.ndim:
        init = jnp.expand_dims(init, axis)
    return pb + pa * init
