"""Full-pipeline proof at the top of the block-size envelope:
encode -> decode roundtrip at mono bs16384 and bs32768 (reference
envelope ulcEncoder.c:21), with compile-time figures.

These sizes are config-accepted and transform-tested; this runs the
whole encode->decode path at them (the 16-branch window switch is the
compile-time risk). Both directions ride the Pallas kernels on a GPU
(P <= 32768 envelope).

Usage: python devtools/bigblock_check.py [16384|32768|both]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(n: int):
    import jax
    import jax.numpy as jnp

    from ulcx.codec.encoder import encode_stream_batched, max_block_bytes
    from ulcx.parallel.mesh import batch_decode
    from ulcx.utils.config import CodecConfig

    b, t, c = 8, 2, 1
    cfg = CodecConfig(rate_hz=44100, n_chan=c, block_size=n)
    rng = np.random.default_rng(21)
    tt = np.arange(t * n) / 44100.0
    x = (
        0.4 * np.sin(2 * np.pi * 520.0 * tt)
        + 0.1 * np.sin(2 * np.pi * 3100.0 * tt + 0.4)
        + 0.01 * rng.standard_normal(t * n)
    ).astype(np.float32)
    blocks = jnp.asarray(
        np.broadcast_to(x.reshape(1, t, 1, n), (b, t, c, n)).copy()
    )
    blocks = blocks * jnp.linspace(0.5, 1.0, b)[:, None, None, None]

    enc = jax.jit(
        lambda bb: encode_stream_batched(bb, cfg, "cbr", rate_kbps=128.0)[0]
    )
    t0 = time.perf_counter()
    out = enc(blocks)
    sizes = np.asarray(out.size_bits)
    enc_compile = time.perf_counter() - t0
    datas = np.asarray(out.data)
    kbps = sizes.mean() * 44100.0 / n / 1000.0
    print(
        f"bs{n}: encode ok — compile+run {enc_compile:.1f}s, "
        f"avg {kbps:.1f} kbps, max block {sizes.max()//8} B "
        f"(bound {max_block_bytes(cfg)} B)", flush=True,
    )

    win = -(-int(sizes.max() // 8) // 64) * 64 + 64
    streams = np.zeros((b, t * win + win + 64), np.uint8)
    for i in range(b):
        offs = 0
        for j in range(t):
            nb = int(sizes[i, j]) // 8
            streams[i, offs : offs + nb] = datas[i, j, :nb]
            offs += nb
    dec = jax.jit(lambda s: batch_decode(s, t, win, cfg))
    t0 = time.perf_counter()
    pcm, bits, corrupt = dec(jnp.asarray(streams))
    pcm = np.asarray(pcm)
    dec_compile = time.perf_counter() - t0
    assert not np.asarray(corrupt).any(), "corrupt flagged"
    assert ((np.asarray(bits) + 7) & ~7 == sizes).all(), "bit accounting"
    assert np.isfinite(pcm).all()
    # decoded block t reconstructs input block t-1 (one-block delay)
    ref = np.asarray(blocks)[:, 0, :, :]
    got = pcm[:, 1, :, :]
    err = got - ref
    snr = 10 * np.log10(
        (ref**2).sum() / max((err**2).sum(), 1e-30)
    )
    print(
        f"bs{n}: decode ok — compile+run {dec_compile:.1f}s, "
        f"roundtrip SNR {snr:.1f} dB (expect > 12 at 128kbps tonal)",
        flush=True,
    )
    assert snr > 12.0, snr
    return enc_compile, dec_compile, snr


def main():
    sys.path.insert(0, ROOT)
    import jax

    from ulcx.utils.compileopts import enable_compile_cache

    enable_compile_cache()

    mode = sys.argv[1] if len(sys.argv) > 1 else "both"
    sizes = {"16384": [16384], "32768": [32768]}.get(mode, [16384, 32768])
    for n in sizes:
        run(n)
    print("bigblock_check: OK")


if __name__ == "__main__":
    main()
