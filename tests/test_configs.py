"""End-to-end coverage of the five BASELINE.json benchmark configs
(at test scale: small blocks, short streams, CPU backend)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ulcx.io.wavio import WavReader, WavWriter
from ulcx.tools.batch_tool import main as batch_main
from ulcx.tools.decode_tool import main as decode_main
from ulcx.tools.encode_tool import main as encode_main
from ulcx.utils.config import CodecConfig

N = 256
RATE = 44100


def _write_wav(path, x, n_chan):
    w = WavWriter(path, RATE, n_chan, 16, 1)
    w.write_frames(x.reshape(-1))
    w.close()


def _sig(rng, n_samp, transients=False):
    t = np.arange(n_samp) / RATE
    x = 0.4 * np.sin(2 * np.pi * 523 * t) + 0.1 * np.sin(2 * np.pi * 2093 * t)
    if transients:
        for k in range(40, n_samp, 700):
            x[k : k + 8] += rng.uniform(0.3, 0.7)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _snr(want, got):
    e = want - got
    return 10 * np.log10((want**2).mean() / max((e**2).mean(), 1e-12))


def test_config1_mono_cbr_roundtrip(tmp_path, rng):
    # "Mono 44.1kHz 16-bit WAV -> 96kbps CBR + decode round-trip"
    x = _sig(rng, 5 * N)
    wav = str(tmp_path / "m.wav")
    _write_wav(wav, x, 1)
    assert encode_main(["e", wav, str(tmp_path / "m.ulc"), "96", f"-blocksize:{N}"]) == 0
    assert decode_main(["d", str(tmp_path / "m.ulc"), str(tmp_path / "m2.wav")]) == 0
    r = WavReader(str(tmp_path / "m2.wav"))
    y = r.read_frames(r.info.n_samples)
    r.close()
    seg = slice(2 * N, 4 * N)
    assert _snr(x[seg], y[N:][seg]) > 8.0


def test_config3_vbr_quality_sweep(tmp_path, rng):
    # "VBR quality sweep on stereo input" — sizes grow with quality
    x = _sig(rng, 4 * N)
    st = np.stack([x, 0.8 * x], -1)
    wav = str(tmp_path / "s.wav")
    _write_wav(wav, st, 2)
    sizes = []
    for q in (20, 90):  # each distinct quality is its own jit compile
        ulc = str(tmp_path / f"q{q}.ulc")
        assert encode_main(["e", wav, ulc, f"-{q}", f"-blocksize:{N}"]) == 0
        sizes.append(os.path.getsize(ulc))
    assert sizes[0] < sizes[1], sizes


def test_config4_abr_blocksize_sweep(tmp_path, rng):
    # "ABR mode with AvgComplexity + blocksize sweep"
    x = _sig(rng, 6 * N, transients=True)
    st = np.stack([x, x], -1)
    wav = str(tmp_path / "a.wav")
    _write_wav(wav, st, 2)
    for bs in (N, 2 * N):
        ulc = str(tmp_path / f"a{bs}.ulc")
        assert encode_main(["e", wav, ulc, "128,0.5", f"-blocksize:{bs}"]) == 0
        out = str(tmp_path / f"a{bs}.wav")
        assert decode_main(["d", ulc, out]) == 0


def test_config5_batched_corpus_all_formats(tmp_path, rng):
    # "Batched corpus encode of transient-heavy material, decode to
    #  PCM8/16/24/FLOAT32"
    paths = []
    for i in range(3):
        x = _sig(rng, (3 + i) * N, transients=True)
        st = np.stack([x, 0.9 * x], -1)
        p = str(tmp_path / f"c{i}.wav")
        _write_wav(p, st, 2)
        paths.append(p)
    outdir = str(tmp_path / "out")
    rc = batch_main(["b", outdir, "112", f"-blocksize:{N}", "-chunk:4"] + paths)
    assert rc == 0
    for i, fmt in zip(range(3), ("PCM8", "PCM24", "FLOAT32")):
        ulc = os.path.join(outdir, f"c{i}.ulc")
        assert os.path.exists(ulc)
        dec = str(tmp_path / f"d{i}.wav")
        assert decode_main(["d", ulc, dec, f"-format:{fmt}"]) == 0
        r = WavReader(dec)
        assert r.info.n_chan == 2
        y = r.read_frames(r.info.n_samples)
        r.close()
        assert np.abs(y).max() > 0.05  # decoded something real


def test_gap_window_rejects_forced_kernels():
    """noise_run_window='gap' is scan-only; forcing the kernels with it
    must fail loudly instead of silently falling back."""
    import pytest

    from ulcx.utils.config import CodecConfig

    with pytest.raises(ValueError, match="scan-only"):
        CodecConfig(
            rate_hz=44100, n_chan=2, block_size=256,
            noise_run_window="gap", use_pallas="on",
        )
    # auto/off remain valid combinations
    CodecConfig(rate_hz=44100, n_chan=2, block_size=256,
                noise_run_window="gap")
    CodecConfig(rate_hz=44100, n_chan=2, block_size=256,
                noise_run_window="gap", use_pallas="off")


def test_forced_kernels_reject_bad_shapes():
    """use_pallas='on' FORCES the kernels: shapes outside the kernel
    envelope (P = n_chan * block_size > 32768 here) raise instead of
    silently taking the scan path; any batch size is inside it (the
    batch pads to the kernel's lane width)."""
    import jax.numpy as jnp
    import pytest

    from ulcx.codec.encoder import encode_stream_batched
    from ulcx.utils.config import CodecConfig

    big = CodecConfig(rate_hz=44100, n_chan=4, block_size=16384,
                      use_pallas="on")
    with pytest.raises(ValueError, match="kernel"):
        encode_stream_batched(jnp.zeros((3, 1, 4, 16384), jnp.float32), big,
                              "cbr", rate_kbps=128.0)
    blocks = jnp.zeros((3, 2, 2, 256), jnp.float32)  # batch 3: padded
    for use_pallas in ("on", "auto"):
        cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=256,
                          use_pallas=use_pallas)
        out, _ = encode_stream_batched(blocks, cfg, "cbr", rate_kbps=128.0)
        assert out.size_bits.shape == (3, 2)
