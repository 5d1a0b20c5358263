"""Extra envelope coverage: odd channel counts, large-P fallback path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ulcx.codec.decoder import decode_stream
from ulcx.codec.encoder import encode_stream, max_block_bytes
from ulcx.utils.config import CodecConfig


def _roundtrip(cfg, rng, t=4, kbps=220.0):
    n, c = cfg.block_size, cfg.n_chan
    tt = np.arange(t * n) / cfg.rate_hz
    base = 0.4 * np.sin(2 * np.pi * 700 * tt).astype(np.float32)
    x = np.stack([base * (0.5 + 0.2 * k) for k in range(c)], axis=0)
    blocks = jnp.asarray(x.reshape(c, t, n).transpose(1, 0, 2))
    out, _ = jax.jit(lambda b: encode_stream(b, cfg, "cbr", rate_kbps=kbps))(blocks)
    sizes = np.asarray(out.size_bits)
    datas = np.asarray(out.data)
    stream = b"".join(datas[i, : sizes[i] // 8].tobytes() for i in range(t))
    pad = np.zeros(max_block_bytes(cfg) + 8, np.uint8)
    sj = jnp.asarray(np.concatenate([np.frombuffer(stream, np.uint8), pad]))
    pcm, bits, corrupt, _ = jax.jit(
        lambda s: decode_stream(s, t, max_block_bytes(cfg), cfg)
    )(sj)
    assert not np.asarray(corrupt).any()
    got = np.asarray(pcm).transpose(1, 0, 2).reshape(c, t * n)
    # decoded block t covers input block t-1
    seg = slice(n, (t - 2) * n)
    want = x[:, seg]
    err = got[:, n:][:, seg] - want
    snr = 10 * np.log10((want**2).mean() / max((err**2).mean(), 1e-12))
    return snr


def _roundtrip_vbr(cfg, rng, t=4, quality=60.0):
    n, c = cfg.block_size, cfg.n_chan
    tt = np.arange(t * n) / cfg.rate_hz
    base = 0.4 * np.sin(2 * np.pi * 700 * tt).astype(np.float32)
    x = np.stack([base * (0.5 + 0.2 * k) for k in range(c)], axis=0)
    blocks = jnp.asarray(x.reshape(c, t, n).transpose(1, 0, 2))
    out, _ = jax.jit(lambda b: encode_stream(b, cfg, "vbr", quality=quality))(blocks)
    sizes = np.asarray(out.size_bits)
    datas = np.asarray(out.data)
    stream = b"".join(datas[i, : sizes[i] // 8].tobytes() for i in range(t))
    pad = np.zeros(max_block_bytes(cfg) + 8, np.uint8)
    sj = jnp.asarray(np.concatenate([np.frombuffer(stream, np.uint8), pad]))
    pcm, bits, corrupt, _ = jax.jit(
        lambda s: decode_stream(s, t, max_block_bytes(cfg), cfg)
    )(sj)
    assert not np.asarray(corrupt).any()
    got = np.asarray(pcm).transpose(1, 0, 2).reshape(c, t * n)
    seg = slice(n, (t - 2) * n)
    want = x[:, seg]
    err = got[:, n:][:, seg] - want
    return 10 * np.log10((want**2).mean() / max((err**2).mean(), 1e-12))


def test_three_channels_odd_ms(rng):
    """Odd channel count: pair 0/1 gets M/S, channel 2 passes through
    (reference ulcEncoder_BlockTransform.c:102, ulcDecoder.c:281)."""
    cfg = CodecConfig(rate_hz=44100, n_chan=3, block_size=256)
    assert _roundtrip(cfg, rng, kbps=330.0) > 8.0


def test_five_channels(rng):
    cfg = CodecConfig(rate_hz=32000, n_chan=5, block_size=256)
    assert _roundtrip(cfg, rng, kbps=550.0) > 8.0


def test_large_p_scan_fallback(rng):
    """P = n_chan*block_size > 32768 must route around the kernels
    (the reference envelope runs to 255ch x bs32768, ulcEncoder.c:18-22)."""
    from ulcx.codec.encoder import _use_kernel

    cfg = CodecConfig(rate_hz=44100, n_chan=8, block_size=8192)
    assert not _use_kernel(cfg)    # P=65536 over the cap
    cfg2 = CodecConfig(rate_hz=44100, n_chan=2, block_size=4096)
    assert _roundtrip(cfg2, rng, t=4, kbps=128.0) > 5.0


def test_kernel_gate_p32768():
    """One kernel family holds the full P<=32768 BLOCK envelope (mono
    bs32768, stereo bs16384, 8ch bs4096): segdelta is a 16-bit segment
    length (a full-block bs32768 segment = 0x8000 needs it), state ncp
    16 bits (sentinel 65535 > P-1), and the keep test is
    threshold-based so no rank field bounds P; any batch pads to the
    kernel's lane width. Gate + field-packing bounds; byte-equality at
    the envelope shapes runs on the GPU (chip_smoke.py phase 3 —
    interpret mode at P>=8192 x B=128 is too slow for CI)."""
    from ulcx.codec.encoder import _use_kernel
    from ulcx.bitstream.fast_encode import _prep_tables

    for c, n in ((1, 8192), (2, 8192), (1, 16384), (2, 16384),
                 (1, 32768), (4, 4096), (8, 4096)):
        cfg = CodecConfig(
            rate_hz=44100, n_chan=c, block_size=n, use_pallas="on"
        )
        assert _use_kernel(cfg), (c, n)
    # use_pallas='on' FORCES the kernels: an out-of-envelope shape is a
    # loud ValueError (mirrors the noise_run_window='gap' gate), never a
    # silent scan fallback. 'auto' falls back quietly.
    cfg2 = CodecConfig(
        rate_hz=44100, n_chan=8, block_size=8192, use_pallas="on"
    )
    with pytest.raises(ValueError, match="outside the kernel envelope"):
        _use_kernel(cfg2)  # P=65536 over the cap
    cfg2a = CodecConfig(
        rate_hz=44100, n_chan=8, block_size=8192, use_pallas="auto"
    )
    assert not _use_kernel(cfg2a)  # auto: quiet fallback

    segdelta, _, _, _ = _prep_tables(32768, 1)
    assert segdelta.max() == 32768.0   # needs the 16th bit, unclipped
    aux = np.int32(32768) | (np.int32(1) << 16)
    assert aux & 0xFFFF == 32768
    assert (aux >> 16) & 1 == 1


def test_large_block_backend_end_to_end_bs8192(rng):
    """Full pipeline through the large-block transform backend (block
    sizes above matmul_max_n route to ulcx.ops.dct.dct4_fact — the
    two-stage matmul factorization). VBR keeps this single-pass; 8192
    bounds the CPU suite's compile time (the 16-branch window switch
    at 32768 takes minutes to compile on CPU — the transform itself is
    exercised at 32768 below)."""
    cfg = CodecConfig(rate_hz=48000, n_chan=1, block_size=8192)
    assert cfg.transform_for(cfg.block_size) == "fact"
    assert _roundtrip_vbr(cfg, rng, t=4, quality=60.0) > 5.0


def test_block_size_32768_transform_roundtrip(rng):
    """The reference's maximum block size (libulc/ulcEncoder.c:21):
    MDCT -> IMDCT perfect reconstruction at N=32768 via the FFT
    backend, full-overlap streaming geometry (same OLA convention as
    tests/test_mdct.py::_pr_roundtrip)."""
    import jax.numpy as jnp
    from ulcx.ops.mdct import (
        frame_window,
        imdct_expand,
        imdct_halfspec,
        mdct_frame,
    )

    n = 32768
    nblk = 3
    x = rng.standard_normal((nblk + 1) * n).astype(np.float32) * 0.4
    ys, ws = [], []
    for t in range(nblk):
        frame = jnp.asarray(x[t * n : (t + 2) * n])
        co = mdct_frame(frame, n, n, backend="fft")
        ys.append(np.asarray(imdct_expand(imdct_halfspec(co, backend="fft"))))
        ws.append(np.asarray(frame_window(n, n, n)))
    for t in range(1, nblk):
        out = ws[t - 1][n:] * ys[t - 1][n:] + ws[t][:n] * ys[t][:n]
        err = np.abs(out - x[t * n : (t + 1) * n]).max()
        assert err < 2e-3, (t, err)


def test_sixteen_channels(rng):
    """High channel count (reference allows 1..255, ulcEncoder.c:18):
    8 M/S pairs through analysis, serialization, and decode."""
    cfg = CodecConfig(rate_hz=44100, n_chan=16, block_size=256)
    assert _roundtrip(cfg, rng, t=4, kbps=1600.0) > 8.0
