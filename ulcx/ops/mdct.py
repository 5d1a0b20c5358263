"""Lapped MDCT/MDST/IMDCT with sine windows and per-boundary overlap.

This replaces the reference's external libfourier transforms
(Fourier_MDCT_MDST / Fourier_IMDCT; used at reference
libulc/ulcEncoder_BlockTransform.c:229 and libulc/ulcDecoder.c:243)
with a batched formulation. The bitstream-defined contract
(reference FormatSpecs.md:24-28,148-157) is:

- IMDCT basis  y[n] = -sum_k X[k] cos(pi/N (n+1/2+N/2)(k+1/2)),
  completely unnormalized; all scaling lives on the encoder side
  (coefficients scaled 2/N so |x| <= 4/pi).
- Sine windows; a [sub]block's boundary overlap is
  ``SubBlockSize * 2^-Scale`` samples, clipped to the previous
  [sub]block's size.

Reduction used here (derived from the basis symmetries):

  forward:  u = fold(window * frame2N);  X = -(2/N) * dct4(u)
  inverse:  v = dct4(X);  y = concat(-v[N/2:], reverse(v), v[:N/2])

with fold(z) = concat(-rev(z[N:3N/2]) - z[3N/2:],
                       z[:N/2] - rev(z[N/2:N])).

Streaming geometry (both sides share it): the crossfade between
consecutive [sub]blocks is centered at the *fold centers*, which tile
the timeline every SubBlockSize samples starting at the middle of the
output block. For an encode call holding [prev block, new block]
(2*block_size samples), subblock s of size S at coefficient offset P
has its 2S-sample frame at sample offset  N/2 + P - S/2 ..  — i.e.
everything any subblock needs lives inside the two buffered blocks, so
no separate forward lap buffer is required (the reference's
TransformFwdLap is an artifact of its C library's streaming API).

The decoder carries exactly block_size/2 floats per channel (same as
the reference's TransformInvLap): the last subblock's raw half-spectrum
``v[:S/2]`` (windowing deferred until the next block reveals the
boundary overlap) plus already-final "spill" samples.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ulcx.ops.dct import dct4 as _dct4, dct4_dst4 as _dct4_dst4


# ---------------------------------------------------------------------------
# Windows.  All shapes static (subblock size S is a python int inside the
# decimation-pattern switch branches); overlap widths are traced scalars.


def rise_window(length: int, overlap) -> jnp.ndarray:
    """[length] window half that rises around its center.

    Positions j in [0, length); transition centered at length/2 with
    width ``overlap`` (traced, power of two, >= 1): zero before, sine
    rise over the transition, one after.
    """
    o = jnp.asarray(overlap, jnp.float32)
    j = jnp.arange(length, dtype=jnp.float32)
    start = jnp.float32(length / 2) - o / 2
    t = (j - start + jnp.float32(0.5)) / o  # in (0,1) inside the transition
    w = jnp.sin(jnp.float32(jnp.pi / 2) * jnp.clip(t, 0.0, 1.0))
    return jnp.where(j < start, 0.0, jnp.where(j >= start + o, 1.0, w)).astype(jnp.float32)


def fall_window(length: int, overlap) -> jnp.ndarray:
    """[length] window half that falls around its center (mirror of rise)."""
    return rise_window(length, overlap)[::-1]


def frame_window(s: int, o_left, o_right) -> jnp.ndarray:
    """Full [2S] window: rise centered at S/2, fall centered at 3S/2."""
    return jnp.concatenate([rise_window(s, o_left), fall_window(s, o_right)])


# ---------------------------------------------------------------------------
# Forward (analysis).


def mdct_fold(z: jnp.ndarray) -> jnp.ndarray:
    """[..., 2S] windowed frame -> [..., S] DCT-IV input."""
    s = z.shape[-1] // 2
    h = s // 2
    zc = z[..., s : s + h][..., ::-1]      # rev(z[S:3S/2])
    zd = z[..., s + h :]                   # z[3S/2:2S]
    za = z[..., :h]                        # z[:S/2]
    zb = z[..., h:s][..., ::-1]            # rev(z[S/2:S])
    return jnp.concatenate([-zc - zd, za - zb], axis=-1)


def mdst_fold(z: jnp.ndarray) -> jnp.ndarray:
    s = z.shape[-1] // 2
    h = s // 2
    zc = z[..., s : s + h][..., ::-1]
    zd = z[..., s + h :]
    za = z[..., :h]
    zb = z[..., h:s][..., ::-1]
    return jnp.concatenate([zc - zd, za + zb], axis=-1)


def mdct_mdst_frame(frame: jnp.ndarray, o_left, o_right, backend: str = "matmul"):
    """MDCT and MDST of a [..., 2S] raw frame, normalized by 2/S.

    Returns (mdct, mdst), each [..., S]. The normalization matches the
    encoder-side 2/SubBlockSize of the reference
    (ulcEncoder_BlockTransform.c:243); the MDST sign convention is
    irrelevant downstream (only Im^2 is used).
    """
    s = frame.shape[-1] // 2
    w = frame_window(s, o_left, o_right)
    z = frame * w
    norm = jnp.float32(2.0 / s)
    mc, ms = _dct4_dst4(mdct_fold(z), mdst_fold(z), backend)
    return -mc * norm, -ms * norm


def mdct_frame(frame: jnp.ndarray, o_left, o_right, backend: str = "matmul"):
    s = frame.shape[-1] // 2
    w = frame_window(s, o_left, o_right)
    return -_dct4(mdct_fold(frame * w), backend) * jnp.float32(2.0 / s)


# ---------------------------------------------------------------------------
# Inverse (synthesis).


def imdct_halfspec(x: jnp.ndarray, backend: str = "matmul") -> jnp.ndarray:
    """[..., S] coefficients -> [..., S] half-spectrum v (unnormalized).

    v fully determines the 2S-sample IMDCT output y via
    ``y = concat(-v[S/2:], reverse(v), v[:S/2])`` (see module docstring).
    """
    return _dct4(x, backend)


def imdct_expand(v: jnp.ndarray) -> jnp.ndarray:
    """Half-spectrum v [..., S] -> full aliased output y [..., 2S]."""
    s = v.shape[-1]
    h = s // 2
    return jnp.concatenate([-v[..., h:], v[..., ::-1], v[..., :h]], axis=-1)
