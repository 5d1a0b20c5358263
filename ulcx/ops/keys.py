"""Order-preserving sort-key maps.

``monotone_i32`` is the f32 -> i32 key map the threshold-keep scheme
builds on (pallas_encode3 docstring): the encode kernels' keep test
compares these integer keys against per-candidate thresholds fetched
from ONE stable sort, and the scan path ranks with a stable argsort of
the float importance — the two agree bit-exactly only if the key map
orders EXACTLY like jax's float comparator, ties included.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def monotone_i32(f):
    """f32 -> signed i32 preserving order; ±0.0 collapse to one key so
    ties (and thus stable-index order) match IEEE comparison. The -0.0
    squash runs in the int domain: ``f + 0.0f`` gets algebraically
    simplified away by XLA, silently keeping -0.0 distinct.

    NaNs (any sign/payload) collapse to ONE key too: jax's argsort
    canonicalizes every NaN to a single value sorted LAST in stable
    index order, so under our DESCENDING rank comparator NaNs must map
    to the minimum key. INT32_MIN is free — the most negative key a
    real float can produce is -inf's 0x807fffff. The canonicalization
    assumption is version-pinned by
    tests/test_ops.py::test_monotone_i32_matches_argsort_order, which
    compares against a live jnp.argsort over NaN-laden data."""
    u = lax.bitcast_convert_type(f, jnp.int32)
    is_nan = (u & jnp.int32(0x7FFFFFFF)) > jnp.int32(0x7F800000)
    u = jnp.where(u == jnp.int32(-(2**31)), jnp.int32(0), u)
    m = jnp.where(u < 0, jnp.bitwise_xor(~u, jnp.int32(-(2**31))), u)
    return jnp.where(is_nan, jnp.int32(-(2**31)), m)
