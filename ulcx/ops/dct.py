"""Type-IV DCT/DST.

The lapped transforms at the heart of the codec (MDCT/MDST forward,
IMDCT inverse; reference FormatSpecs.md:148-155) reduce, after
fold/unfold, to length-N DCT-IV / DST-IV:

    dct4(x)[k] = sum_n x[n] * cos(pi/N * (n+1/2) * (k+1/2))
    dst4(x)[k] = sum_n x[n] * sin(pi/N * (n+1/2) * (k+1/2))

Two backends:

- **matmul** — the transform as one batched [.., N] @ [N, N] product,
  the most accurate option for the codec's common block sizes (<= 2k):
  one N=2048 basis matrix is 16 MiB of device memory, shared by the
  whole batch of streams x channels.
- **fft** — O(N log N) via a single complex FFT of length 2N with
  pre/post twiddles; used for very large blocks (up to the reference's
  32768 limit) where an N^2 matrix would not be sensible.
- **fact** — the DCT-IV as ONE complex FFT of length M = N/2 (the
  classic even/odd fold: y[m] = x[2m] + i*x[N-1-2m], pre-twiddle,
  FFT_M, post-twiddle; c[2j] = Re T[j], c[N-1-2j] = -Im T[j]), with
  the FFT itself realized as a two-stage Cooley-Tukey factorization
  M = M1*M2 whose stages are small BATCHED MATMULS ([M2,M2] then
  [M1,M1], twiddles folded into the stage matrices). Cost is
  N*(M1+M2)*2 real MACs instead of the dense N^2 — ~21x fewer FLOPs
  at N=4096 — and the program constants are a few KiB instead of the
  67 MiB dense basis pair. Everything is matmuls; no jnp.fft
  involved.

All are float32-accurate transforms; the choice is performance-only
(fact relative error ~1e-6 at N=4096, far below the codec's 3-bit
companded quantization).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


# ---------------------------------------------------------------------------
# Basis matrices (host-side, cached; computed in float64 then cast).


@lru_cache(maxsize=32)
def _dct4_matrix(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    arg = np.pi / n * np.outer(k + 0.5, k + 0.5)
    return np.cos(arg).astype(np.float32)


@lru_cache(maxsize=32)
def _dst4_matrix(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    arg = np.pi / n * np.outer(k + 0.5, k + 0.5)
    return np.sin(arg).astype(np.float32)


@lru_cache(maxsize=32)
def _fft_twiddles(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(pre, post) twiddles for the 2N-FFT DCT-IV/DST-IV algorithm.

    c[k] = sum_n x[n] exp(-i pi (n+1/2)(k+1/2) / N)
         = post[k] * FFT_2N(pre * x, zero-padded)[k]
    with pre[n] = exp(-i pi n / (2N)), post[k] = exp(-i pi (k/2 + 1/4)/N).
    Then dct4 = Re(c), dst4 = -Im(c).
    """
    nn = np.arange(n, dtype=np.float64)
    pre = np.exp(-1j * np.pi * nn / (2.0 * n)).astype(np.complex64)
    post = np.exp(-1j * np.pi * (nn / 2.0 + 0.25) / n).astype(np.complex64)
    return pre, post


# ---------------------------------------------------------------------------
# Public transforms. All operate on the last axis; any leading batch dims.


# Transform matmul precision: HIGHEST = full f32 products (the default);
# HIGH lets the backend use a faster reduced-precision form (on a GPU,
# TF32). Env-tunable for A/B on hardware; CPU backends ignore precision
# flags entirely (tests unaffected).
import os as _os

_MM_PRECISION = {
    "high": lax.Precision.HIGH,
    "highest": lax.Precision.HIGHEST,
}[_os.environ.get("ULCX_TRANSFORM_PRECISION", "highest").lower()]


def dct4_matmul(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[-1]
    m = jnp.asarray(_dct4_matrix(n))
    return jnp.matmul(x, m, precision=_MM_PRECISION)


def dst4_matmul(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[-1]
    m = jnp.asarray(_dst4_matrix(n))
    return jnp.matmul(x, m, precision=_MM_PRECISION)


def _c4_fft(x: jnp.ndarray) -> jnp.ndarray:
    """Complex c[k] = dct4(x)[k] - i*dst4(x)[k] via a 2N FFT."""
    n = x.shape[-1]
    pre, post = _fft_twiddles(n)
    z = x.astype(jnp.complex64) * jnp.asarray(pre)
    z = jnp.concatenate([z, jnp.zeros_like(z)], axis=-1)
    f = jnp.fft.fft(z, axis=-1)[..., :n]
    return f * jnp.asarray(post)


def dct4_fft(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.real(_c4_fft(x))


def dst4_fft(x: jnp.ndarray) -> jnp.ndarray:
    return -jnp.imag(_c4_fft(x))


def dct4_dst4_fft(x_c: jnp.ndarray, x_s: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """dct4(x_c) and dst4(x_s) sharing one batched FFT."""
    c = _c4_fft(jnp.stack([x_c, x_s], axis=0))
    return jnp.real(c[0]), -jnp.imag(c[1])


# ---------------------------------------------------------------------------
# Factorized backend: DCT-IV via one M=N/2 complex FFT done as two
# matmul stages (see module docstring). Derivation:
#
#   c[k] = sum_n x[n] cos(pi/N (n+1/2)(k+1/2))
#   y[m] = x[2m] + i x[N-1-2m],  z[m] = y[m] e^{-i pi m / N}
#   T[j] = e^{-i pi (j+1/4)/N} * FFT_M(z)[j]
#   c[2j] = Re T[j],   c[N-1-2j] = -Im T[j]
#
# FFT_M by Cooley-Tukey with m = m1 + M1*m2, j = j2 + M2*j1:
#   inner [M2,M2] DFT over m2, twiddle W_M^{m1 j2}, outer [M1,M1] DFT
#   over m1; output [j1, j2] flattens row-major to j = j2 + M2*j1.
# All scalar twiddles are folded into the nearest stage constant.
# DST-IV comes for free: dst4(x)[k] = (-1)^k dct4(reverse(x))[k].


@lru_cache(maxsize=32)
def _fact_consts(n: int):
    """(M1, M2, F2, mid, F1) as float32 (real, imag) pairs."""
    m = n // 2
    m1n = 1 << ((m.bit_length() + 1) // 2)  # M1 >= M2, both powers of 2
    m2n = m // m1n
    assert m1n * m2n == m and m2n >= 1
    m1 = np.arange(m1n, dtype=np.float64)
    m2 = np.arange(m2n, dtype=np.float64)
    j1 = m1
    j2 = m2
    # inner stage: W_{M2}^{m2 j2} * (m2 part of the pre-twiddle e^{-i pi m/N})
    f2 = np.exp(-2j * np.pi * np.outer(m2, j2) / m2n) * np.exp(
        -1j * np.pi * m1n * m2 / n
    )[:, None]
    # mid twiddle W_M^{m1 j2} * (m1 part of pre) * (j2 part of post)
    mid = (
        np.exp(-2j * np.pi * np.outer(j2, m1) / m)
        * np.exp(-1j * np.pi * m1 / n)[None, :]
        * np.exp(-1j * np.pi * (j2 + 0.25) / n)[:, None]
    )
    # outer stage: W_{M1}^{m1 j1} * (j1 part of post e^{-i pi M2 j1 / N})
    f1 = np.exp(-2j * np.pi * np.outer(m1, j1) / m1n) * np.exp(
        -1j * np.pi * m2n * j1 / n
    )[None, :]

    def ri(a):
        return a.real.astype(np.float32), a.imag.astype(np.float32)

    return m1n, m2n, ri(f2), ri(mid), ri(f1)


def _fact_core(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(Re T, Im T) of the factorized transform, each [..., N/2]."""
    n = x.shape[-1]
    m1n, m2n, (f2r, f2i), (midr, midi), (f1r, f1i) = _fact_consts(n)
    f2r, f2i = jnp.asarray(f2r), jnp.asarray(f2i)
    midr, midi = jnp.asarray(midr), jnp.asarray(midi)
    f1r, f1i = jnp.asarray(f1r), jnp.asarray(f1i)
    yr = x[..., 0::2]
    yi = x[..., 1::2][..., ::-1]
    # [..., m2, m1]: flat index m = m1 + M1*m2
    yr = yr.reshape(*yr.shape[:-1], m2n, m1n)
    yi = yi.reshape(*yi.shape[:-1], m2n, m1n)

    def cmm(ar, ai, br, bi, eq):
        rr = jnp.einsum(eq, ar, br, precision=_MM_PRECISION)
        ri_ = jnp.einsum(eq, ar, bi, precision=_MM_PRECISION)
        ir = jnp.einsum(eq, ai, br, precision=_MM_PRECISION)
        ii = jnp.einsum(eq, ai, bi, precision=_MM_PRECISION)
        return rr - ii, ri_ + ir

    # inner DFT over m2 -> [..., j2, m1]
    vr, vi = cmm(yr, yi, f2r, f2i, "...ba,bj->...ja")
    # mid twiddle (elementwise complex, [j2, m1])
    vr, vi = vr * midr - vi * midi, vr * midi + vi * midr
    # outer DFT over m1 -> [..., j1, j2]
    ur, ui = cmm(vr, vi, f1r, f1i, "...ja,ak->...kj")
    # flatten: j = j2 + M2*j1 == row-major [j1, j2]
    ur = ur.reshape(*ur.shape[:-2], n // 2)
    ui = ui.reshape(*ui.shape[:-2], n // 2)
    return ur, ui


def _interleave(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(*out.shape[:-2], even.shape[-1] * 2)


def dct4_fact(x: jnp.ndarray) -> jnp.ndarray:
    tr, ti = _fact_core(x)
    return _interleave(tr, (-ti)[..., ::-1])


def dst4_fact(x: jnp.ndarray) -> jnp.ndarray:
    # dst4(x)[k] = (-1)^k dct4(rev x)[k]: even outputs unchanged, odd
    # outputs negated — the negation folds into the interleave.
    tr, ti = _fact_core(x[..., ::-1])
    return _interleave(tr, ti[..., ::-1])


def dct4_dst4_fact(x_c: jnp.ndarray, x_s: jnp.ndarray):
    """dct4(x_c) and dst4(x_s) through ONE stacked factorized core.

    Stacking keeps the fact path at the same launch count as the dense
    pair (two matmul stages total)."""
    tr, ti = _fact_core(jnp.stack([x_c, x_s[..., ::-1]], axis=0))
    return (
        _interleave(tr[0], (-ti[0])[..., ::-1]),
        _interleave(tr[1], ti[1][..., ::-1]),
    )


_DCT4 = {"matmul": dct4_matmul, "fft": dct4_fft, "fact": dct4_fact}
_DST4 = {"matmul": dst4_matmul, "fft": dst4_fft, "fact": dst4_fact}


def dct4_dst4(x_c: jnp.ndarray, x_s: jnp.ndarray, backend: str = "matmul"):
    """(dct4(x_c), dst4(x_s)) — pair-fused where the backend allows."""
    if backend == "fact":
        return dct4_dst4_fact(x_c, x_s)
    if backend == "fft":
        return dct4_dst4_fft(x_c, x_s)
    return dct4_matmul(x_c), dst4_matmul(x_s)


def dct4(x: jnp.ndarray, backend: str = "matmul") -> jnp.ndarray:
    return _DCT4[backend](x)


def dst4(x: jnp.ndarray, backend: str = "matmul") -> jnp.ndarray:
    return _DST4[backend](x)
