"""Native C++ I/O runtime vs NumPy reference implementations."""

import sys

import numpy as np
import pytest

from ulcx.io import native


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_conversions_match_numpy(rng):
    # compare against the pure-NumPy formulas (bypassing the native hook)
    from ulcx.io.wavio import _float_to_pcm24, _pcm24_to_float

    x = np.clip(rng.standard_normal(4096).astype(np.float32) * 0.4, -1, 1)
    # 16-bit
    got = native.float_to_raw(x, 16, 1).view("<i2")
    want = np.rint(np.clip(x * 2.0**15, -0x8000, 0x7FFF)).astype("<i2")
    assert (got == want).all()
    back = native.raw_to_float(got.view(np.uint8), 16, 1)
    assert np.abs(back - got.astype(np.float32) * 2.0**-15).max() == 0
    # 8-bit
    got8 = native.float_to_raw(x, 8, 1)
    want8 = (
        np.rint(np.clip(x * 2.0**7, -0x80, 0x7F)).astype(np.int8).view(np.uint8) ^ 0x80
    )
    assert (got8 == want8).all()
    # 24-bit
    got24 = native.float_to_raw(x, 24, 1)
    want24 = _float_to_pcm24(x)
    assert (got24 == want24).all()
    back24 = native.raw_to_float(got24, 24, 1)
    assert np.allclose(back24, _pcm24_to_float(got24), atol=0)


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_pack_blocks(rng):
    t, stride = 5, 64
    data = rng.integers(0, 255, (t, stride), dtype=np.uint8)
    sizes = np.array([8 * 10, 8 * 3, 8 * 64, 8 * 1, 8 * 20], np.int32)
    got = native.pack_blocks(data, sizes)
    want = b"".join(data[i, : sizes[i] // 8].tobytes() for i in range(t))
    assert got == want
