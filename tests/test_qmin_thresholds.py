"""Exactness of the packed quantizer-threshold planes.

The size-only kernel walks replace cq_unsigned(m * 2**q) >= {1, 2}
tests with integer compares q >= qmin(m) (fast_encode._qmin_ge). This
must hold for EVERY f32 magnitude and every q in [0, 31] — the kernel
byte-equality tests cover realistic values; this pins the boundary
cases (exact thresholds, one-ulp neighbors, denormals, zeros).
"""

import numpy as np
import jax.numpy as jnp

from ulcx.bitstream.fast_encode import _qmin_ge


def test_qmin_exact_on_boundaries_and_randoms():
    rng = np.random.default_rng(0)
    vals = [0.0, 1e-45, 1e-38]  # zero, smallest denormal, near-min normal
    for q in range(32):
        for thr in (2.5, 0.5, 0.125):
            m = np.float32(thr * 2.0 ** -q)
            vals += [
                m,
                np.nextafter(m, np.float32(0), dtype=np.float32),
                np.nextafter(m, np.float32(np.inf), dtype=np.float32),
            ]
    vals += list(rng.uniform(0, 4, 1500).astype(np.float32))
    vals += list((rng.uniform(0, 1, 500) ** 8).astype(np.float32) * 1e-6)
    m = np.abs(np.asarray(vals, np.float32))

    for thr, kind in ((2.5, "2.5"), (0.5, "0.5"), (0.125, "0.125")):
        qmin = np.asarray(_qmin_ge(jnp.asarray(m), kind))
        for q in range(32):
            # the product m * 2**q is what the kernel would compute:
            # exact exponent shift (boundary cases are never denormal)
            truth = (m * np.float32(2.0**q)) >= np.float32(thr)
            mine = q >= qmin
            bad = np.nonzero(truth != mine)[0]
            assert len(bad) == 0, (kind, q, m[bad[:5]], qmin[bad[:5]])


def test_exp2i_is_exact_power_of_two():
    """The scan and kernel encode paths scale by _exp2i(q): exactly 2**q
    for every quantizer q, so no backend's exp2 rounding can move a
    coefficient across a quantizer boundary."""
    from ulcx.bitstream.encode import _exp2i

    q = np.arange(32, dtype=np.int32)
    got = np.asarray(_exp2i(jnp.asarray(q)))
    np.testing.assert_array_equal(got, np.ldexp(np.float32(1), q))
    assert got.dtype == np.float32
