"""Bark-band psychoacoustic masking and noise log-spectrum.

Port of reference libulc/ulcEncoder_Psyopt.c onto vectorized prefix
sums: the reference walks 25 Bark bands with incremental lo/hi line
cursors (LineSum_t, reference :16-51); here band sums are differences
of cumulative sums gathered at *static* band-edge line indices (the
edges depend only on (pseudo-DFT size, sample rate), both static), and
the per-line output is a static gather + lerp over the 25 band values.

Masking bands span [Bark-0.75, Bark+0.25] (lower bands mask higher
ones; reference :102-116); the noise analysis spans [Bark, Bark+2]
(noise must extend upward before we inject it; reference :190-205).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import lax

from ulcx.ops.fastlog import fast_log
from ulcx.utils.config import N_BARK_BANDS

_LOG2 = np.float32(float.fromhex("0x1.62E430p-1"))
_TINY = np.float32(2.0**-126)


def _freq_to_line(f, nyquist, m):
    return np.float32(f) * np.float32(m) / np.float32(nyquist) - np.float32(0.5)


def _line_to_freq(line, nyquist, m):
    return (np.float32(line) + np.float32(0.5)) * np.float32(nyquist) / np.float32(m)


def _bark_to_freq(bark):
    return np.float32(600.0) * np.sinh(np.float32(bark) * np.float32(1.0 / 6.0))


def _freq_to_bark(f):
    return np.float32(6.0) * np.arcsinh(np.float32(f) * np.float32(1.0 / 600.0))


@lru_cache(maxsize=64)
def band_edges(m: int, rate_hz: int, lo_off: float, hi_off: float):
    """(beg[25], end[25]) static line indices for one pseudo-DFT size."""
    nyq = np.float32(rate_hz) * np.float32(0.5)
    beg, end = [], []
    for band in range(N_BARK_BANDS):
        fb = _bark_to_freq(np.float32(band) + np.float32(lo_off))
        fe = _bark_to_freq(np.float32(band) + np.float32(hi_off))
        lb = int(np.floor(_freq_to_line(fb, nyq, m)))
        le = int(np.ceil(_freq_to_line(fe, nyq, m)))
        lb = min(max(lb, 0), m - 1)
        le = min(max(le, 0), m)
        beg.append(lb)
        end.append(le)
    return np.asarray(beg, np.int32), np.asarray(end, np.int32)


@lru_cache(maxsize=64)
def line_interp_tables(m: int, rate_hz: int):
    """Static (band_idx[m], frac[m]) for per-line Bark interpolation."""
    nyq = np.float32(rate_hz) * np.float32(0.5)
    bark = _freq_to_bark(_line_to_freq(np.arange(m, dtype=np.float32), nyq, m))
    bidx = bark.astype(np.int32)  # truncation, like the C cast
    frac = bark - bidx.astype(np.float32)
    il = np.minimum(bidx, N_BARK_BANDS - 1)
    ir = np.where(bidx + 1 < N_BARK_BANDS, bidx + 1, il)
    return il, ir, frac.astype(np.float32)


@lru_cache(maxsize=64)
def _interp_onehots(m: int, rate_hz: int):
    """One-hot [25, m] selection matrices for the left/right band of
    each line (f32 matmul with exactly one nonzero per output column is
    exact)."""
    il, ir, frac = line_interp_tables(m, rate_hz)
    eye = np.eye(N_BARK_BANDS, dtype=np.float32)
    return eye[:, il].copy(), eye[:, ir].copy(), frac


def _band_lerp(bark_vals: jnp.ndarray, m: int, rate_hz: int) -> jnp.ndarray:
    """Per-line lerp of [..., 25] band values -> [..., m]; identical
    arithmetic to gather+lerp (selection is exact; the lerp itself is
    the same f32 elementwise expression)."""
    oh_l, oh_r, frac = _interp_onehots(m, rate_hz)
    hi = lax.Precision.HIGHEST
    bl = jnp.matmul(bark_vals, jnp.asarray(oh_l), precision=hi)
    br = jnp.matmul(bark_vals, jnp.asarray(oh_r), precision=hi)
    return bl * (1.0 - frac) + br * frac


def _forward_fill(values, valid, init):
    """Per-band forward fill: carry the last valid value, else ``init``
    (associative scan — the former cummax + take_along_axis pair lowers
    to a gather, pathological on this backend)."""

    def combine(l, r):
        fl, vl = l
        fr, vr = r
        return fl | fr, jnp.where(fr, vr, vl)

    f, v = lax.associative_scan(
        combine,
        (valid, jnp.where(valid, values, 0)),
        axis=values.ndim - 1,
    )
    return jnp.where(f, v, jnp.asarray(init, values.dtype))


@lru_cache(maxsize=64)
def _band_onehot(m: int, beg: tuple, end: tuple):
    oh = np.zeros((m, N_BARK_BANDS), np.float32)
    for b in range(N_BARK_BANDS):
        oh[beg[b] : end[b], b] = 1.0
    return oh


def _band_sums(data, log_data, beg, end):
    """(floor, peak, peak_w) over [beg, end) per band.

    NOT a prefix-sum difference: the reference accumulates its LineSum
    cursors in DOUBLE (ulcEncoder_Psyopt.c:16-50) exactly because band
    sums of wide-dynamic-range spectra cancel catastrophically when
    formed as differences of whole-spectrum running totals — in f32 a
    quiet band's peak_w comes out ~1e-7 * total instead of its own
    ~1e-13, and log(peak_w) is then off by up to ~15 nepers (measured
    on polyphonic material). Instead each band sums only its OWN
    [beg, end) lines through a 0/1 [m, 25] matmul — positive
    same-magnitude in-band accumulation, relative error ~1e-7."""
    oh = jnp.asarray(_band_onehot(data.shape[-1], tuple(beg), tuple(end)))
    stacked = jnp.stack([log_data, log_data * data, data], axis=-2)
    hi = lax.Precision.HIGHEST
    s = jnp.matmul(stacked, oh, precision=hi)  # [..., 3, n_bands]
    return s[..., 0, :], s[..., 1, :], s[..., 2, :]


def masking_curve(amp2: jnp.ndarray, m: int, rate_hz: int) -> jnp.ndarray:
    """Per-line masking offset (nepers) for one subblock.

    amp2: [..., m] pseudo-DFT line energies (all channels accumulated).
    Implements reference ULCi_CalculatePsychoacoustics for one subblock.
    """
    beg, end = band_edges(m, rate_hz, -0.75, 0.25)
    log_amp = fast_log(_TINY + amp2)
    floor, peak, peak_w = _band_sums(amp2, log_amp, beg, end)
    nlines = jnp.asarray((end - beg).astype(np.float32))
    valid = peak_w > 0
    safe_w = jnp.where(valid, peak_w, 1.0)
    ratio = peak / safe_w - floor / jnp.maximum(nlines, 1.0) - jnp.log(safe_w)
    bark_unmasked = _forward_fill(jnp.where(valid, ratio, 0.0), valid, 0.0)
    return _band_lerp(bark_unmasked, m, rate_hz)


def noise_log_spectrum(energy: jnp.ndarray, m: int, rate_hz: int) -> jnp.ndarray:
    """Per-channel noise-fill spectrum for one subblock.

    energy: [..., m] pseudo-DFT line energies for one channel.
    Returns [..., 2m] interleaved {w, w*(log-level + log 2)} pairs
    (the +log2 pre-scales by the noise quantizer's 4.0/2 factor;
    reference ULCi_CalculateNoiseLogSpectrum, Psyopt.c:236-249).
    """
    beg, end = band_edges(m, rate_hz, 0.0, 2.0)
    log_e = fast_log(_TINY + energy)
    floor, peak, peak_w = _band_sums(energy, log_e, beg, end)
    nlines = jnp.maximum(jnp.asarray((end - beg).astype(np.float32)), 1.0)
    valid = peak_w > 0
    safe_w = jnp.where(valid, peak_w, 1.0)
    scale = 1.0 / nlines
    level = 0.5 * (jnp.log(safe_w * scale) + floor * scale - peak / safe_w)
    bark_noise = _forward_fill(jnp.where(valid, level, -100.0), valid, -100.0)
    noise = _band_lerp(bark_noise, m, rate_hz)
    w = jnp.exp(0.5 * noise)
    pairs = jnp.stack([w, w * (noise + _LOG2)], axis=-1)
    return pairs.reshape(pairs.shape[:-2] + (2 * m,))
