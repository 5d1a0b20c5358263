"""Smoke run of ulcx on one GPU: the main path through its user-facing
entry points, each kernel against the plain path, the codec against
the float64 oracle, and the CLI tools.

Usage:
    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --four-cards  # the sharded batch path on 4 GPUs

Phases (each prints what it finds; a failing phase raises, so the run
exits non-zero and prints no result line):
  1. device: jax.devices(), nvidia-smi name and power limit; GPU only.
  2. batch path at full width: batch_encode + batch_decode, stereo
     44.1 kHz CBR-128 bs2048, B=512 streams x T=64 blocks.
  3. kernels vs plain path (use_pallas="off") on the card at the
     headline shape and the top of the P envelope: identical bytes and
     sizes; identical decoded bits and corrupt flags, PCM within
     PCM_TOL.
  4. against the float64 oracle (tests/oracle.py): 8 streams x 16
     blocks, CBR and VBR: total size within 1%, round-trip SNR within
     0.3 dB (PARITY.md bounds).
  5. CLI tools in-process on a 30 s WAV: CBR, VBR (-55), ABR (128,0.5).
With --four-cards only the sharded phase runs: batch_encode and
batch_decode over a 4-GPU data mesh at B=4x512, T=16, compared shard by
shard with one-card runs of the same streams.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

# Decoded PCM of the kernel and plain decoders: the coefficients are
# the same (the decoded bits and corrupt flags must be identical), but
# the kernel path runs the batched IMDCT (transform_batched) and the
# plain path the per-stream one (codec/transform), so f32 sums are
# taken in another order. Full-scale PCM is |x| <= ~1 and a reordered
# f32 sum over at most 32768 products moves by ~1e-5; 1e-4 keeps a
# margin, while one wrong coefficient moves its block by far more.
PCM_TOL = 1e-4

# Sizes of each phase: (streams, blocks) or per-shape tuples.
BATCH = (512, 64)
ENVELOPE = ((2, 2048, 512, 4), (2, 16384, 128, 2), (1, 32768, 128, 2))
ORACLE = (8, 16)
CLI_SECONDS = 30
FOUR_CARDS = (512, 16)
# use_pallas of the kernel side: "auto" compiles the kernels on a GPU
KERNELS = "auto"


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    log(f"  {label}: {time.perf_counter() - t0:.2f} s (compile included)")
    return out


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    err = out.astype(np.float64) - ref
    return float(10 * np.log10(np.sum(ref**2) / max(np.sum(err**2), 1e-30)))


def codec_cfg(n_chan=2, block_size=2048, use_pallas=None):
    from ulcx.utils.config import CodecConfig

    return CodecConfig(rate_hz=44100, n_chan=n_chan, block_size=block_size,
                       use_pallas=use_pallas or KERNELS)


@functools.lru_cache(maxsize=None)
def _encode_fn(cfg, mode, mesh, kw):
    import jax
    from ulcx.parallel.mesh import batch_encode

    return jax.jit(lambda x: batch_encode(x, cfg, mode, mesh=mesh, **dict(kw))[0])


@functools.lru_cache(maxsize=None)
def _decode_fn(cfg, t, win, mesh):
    import jax
    from ulcx.parallel.mesh import batch_decode

    return jax.jit(lambda s: batch_decode(s, t, win, cfg, mesh=mesh))


def encode_batch(blocks, cfg, mode="cbr", mesh=None, **kw):
    """batch_encode -> (sizes [B, T] bits, data [B, T, max_bytes])."""
    kw = tuple(sorted((kw or {"rate_kbps": 128.0}).items()))
    out = timed(f"encode {mode} use_pallas={cfg.use_pallas} {blocks.shape}",
                _encode_fn(cfg, mode, mesh, kw), blocks)
    return np.asarray(out.size_bits), np.asarray(out.data)


def decode_batch(streams, t, win, cfg, mesh=None):
    """batch_decode -> (pcm [B, T, C, N], bits [B, T], corrupt [B, T])."""
    out = timed(f"decode use_pallas={cfg.use_pallas} {streams.shape}",
                _decode_fn(cfg, t, win, mesh), streams)
    return tuple(np.asarray(x) for x in out)


def check_roundtrip(sizes, pcm, bits, corrupt):
    assert not corrupt.any(), f"{int(corrupt.sum())} corrupt blocks"
    assert np.isfinite(pcm).all(), "non-finite PCM"
    # decoder reports unpadded bits; encoder sizes are byte-aligned
    assert ((bits + 7) & ~7 == sizes).all(), "decoded bits != encoded sizes"


def phase_device():
    import jax

    from bench import gpu_name_and_power_limit

    log("phase 1: device")
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {jax.default_backend()!r}"
        )
    log(f"  jax.devices(): {jax.devices()}")
    log(f"  nvidia-smi: {gpu_name_and_power_limit()}")


def phase_batch_path():
    import jax.numpy as jnp

    from bench import assemble_streams, make_corpus
    from ulcx.codec.encoder import cbr_bit_budget

    b, t = BATCH
    log(f"phase 2: batch path, stereo CBR-128 bs2048, B={b} T={t}")
    cfg = codec_cfg()
    x = make_corpus(b, t, 2048)
    sizes, data = encode_batch(jnp.asarray(x), cfg)
    budget = int(cbr_bit_budget(cfg, 128.0))
    assert sizes.max() <= budget, (int(sizes.max()), budget)
    streams, win = assemble_streams(sizes, data)
    pcm, bits, corrupt = decode_batch(jnp.asarray(streams), t, win, cfg)
    check_roundtrip(sizes, pcm, bits, corrupt)
    # decoded block t reconstructs input block t-1
    snr = snr_db(x[:, :-1], pcm[:, 1:])
    log(f"  {b * t} blocks, max block {int(sizes.max())} <= budget {budget} "
        f"bits, 0 corrupt, round-trip SNR {snr:.2f} dB")
    assert snr > 10.0, snr


@functools.lru_cache(maxsize=None)
def _same_n_fn(cfg):
    """CBR bitstream stages on one shared analysis: the kernels' rate
    search and materialization, then the scan encode pass at the
    counts the kernels chose. -> (kernel sizes, kernel bytes, scan
    sizes, scan bytes), each with leading [T, B]."""
    import jax
    from jax import lax

    from ulcx.analysis.batched import analyze_block_batched
    from ulcx.bitstream.encode import encode_pass_materialize, prepare_block
    from ulcx.bitstream.fast_encode import prepare_fast, search_materialize_fast
    from ulcx.codec.encoder import cbr_bit_budget, init_carry_batched, max_block_bytes
    from ulcx.utils.config import kernel_mode

    interpret = kernel_mode(cfg) == "interpret"
    mb = max_block_bytes(cfg)

    def step(carry, blk_t):
        carry, ab = analyze_block_batched(carry, blk_t, cfg)
        budget = jnp.broadcast_to(cbr_bit_budget(cfg, 128.0), ab.n_nz.shape)
        n, size_k, data_k = search_materialize_fast(
            prepare_fast(ab, cfg), ab.n_nz, budget, cfg, mb, interpret)
        size_s, data_s = jax.vmap(
            lambda a, k: encode_pass_materialize(
                prepare_block(a, cfg), k, mb, cfg.noise_run_window)
        )(ab, n)
        return carry, (size_k, data_k, size_s, data_s)

    import jax.numpy as jnp

    def run(blocks):
        carry = init_carry_batched(cfg, blocks.shape[0])
        return lax.scan(step, carry, blocks.transpose(1, 0, 2, 3))[1]

    return jax.jit(run)


def phase_kernels_vs_plain():
    import jax.numpy as jnp

    from bench import assemble_streams, make_corpus

    log("phase 3: kernels vs plain path (use_pallas='off')")
    for n_chan, n, b, t in ENVELOPE:
        log(f"  n_chan={n_chan} bs{n} B={b} T={t}")
        cfg = codec_cfg(n_chan, n)
        off = codec_cfg(n_chan, n, "off")
        x = jnp.asarray(make_corpus(b, t, n)[:, :, :n_chan])

        # VBR has no rate search: the whole encode must match
        vbr = {"quality": 50.0}
        sizes, data = encode_batch(x, cfg, "vbr", **vbr)
        sizes_o, data_o = encode_batch(x, off, "vbr", **vbr)
        assert (sizes == sizes_o).all(), "VBR sizes differ"
        streams, win = assemble_streams(sizes, data)
        assert (streams == assemble_streams(sizes, data_o)[0]).all(), (
            "VBR bytes differ")
        log(f"    VBR q50 encode: {sizes.size} blocks, sizes and bytes identical")

        # CBR: the kernel rate search (8-candidate seeded ladder) and the
        # scan path's 16-candidate ladder may settle on different counts;
        # at the count the kernels chose, the bytes must be the scan's
        size_k, data_k, size_s, data_s = (np.asarray(v).swapaxes(0, 1) for v in
                                          timed("CBR-128 kernels + scan at the same n",
                                                _same_n_fn(cfg), x))
        assert (size_k == size_s).all(), "CBR sizes differ at equal n"
        streams, win = assemble_streams(size_k, data_k)
        assert (streams == assemble_streams(size_s, data_s)[0]).all(), (
            "CBR bytes differ at equal n")
        log(f"    CBR-128 encode: {size_k.size} blocks, sizes and bytes "
            f"identical to the scan encode pass at the kernels' counts")

        # decode the CBR streams both ways
        s = jnp.asarray(streams)
        pcm, bits, corrupt = decode_batch(s, t, win, cfg)
        pcm_o, bits_o, corrupt_o = decode_batch(s, t, win, off)
        check_roundtrip(size_k, pcm, bits, corrupt)
        assert (bits == bits_o).all() and (corrupt == corrupt_o).all()
        err = float(np.abs(pcm - pcm_o).max())
        log(f"    decode: bits and corrupt identical, max |PCM diff| "
            f"{err:.3g} <= {PCM_TOL}")
        assert err <= PCM_TOL, err


def _oracle_stream(args):
    """Encode + decode one stream with the float64 oracle (runs in a
    worker process that never imports JAX)."""
    import oracle

    blocks, mode, kw = args
    enc = oracle.OracleEncoder(44100, blocks.shape[1], blocks.shape[2])
    sizes, parts = [], []
    for blk in blocks:
        if mode == "cbr":
            s, d = enc.encode_block_cbr(blk, kw["rate_kbps"])
        else:
            s, d = enc.encode_block_vbr(blk, kw["quality"])
        sizes.append(s)
        parts.append(d)
    pcm = oracle.decode_stream(b"".join(parts), len(blocks),
                               blocks.shape[2], blocks.shape[1])
    return sum(sizes), pcm


def phase_oracle():
    import multiprocessing

    import jax.numpy as jnp

    from bench import assemble_streams, make_corpus

    b, t = ORACLE
    log(f"phase 4: against the float64 oracle, stereo bs2048, B={b} T={t}")
    cfg = codec_cfg()
    x = make_corpus(b, t, 2048)
    cases = (("cbr", {"rate_kbps": 128.0}), ("vbr", {"quality": 50.0}))
    # few workers: the oracle runs beside the encode compiles, which
    # need the host's cores more
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        pending = {
            mode: pool.map_async(_oracle_stream, [(x[i], mode, kw) for i in range(b)])
            for mode, kw in cases
        }
        for mode, kw in cases:
            sizes, data = encode_batch(jnp.asarray(x), cfg, mode, **kw)
            streams, win = assemble_streams(sizes, data)
            pcm, bits, corrupt = decode_batch(jnp.asarray(streams), t, win, cfg)
            check_roundtrip(sizes, pcm, bits, corrupt)
            ref = pending[mode].get(timeout=900)
            o_bits = sum(r[0] for r in ref)
            o_pcm = np.stack([r[1] for r in ref])
            size_d = (float(sizes.sum()) - o_bits) / o_bits
            snr_u = snr_db(x[:, :-1], pcm[:, 1:])
            snr_o = snr_db(x[:, :-1], o_pcm[:, 1:])
            log(f"  {mode}: size {int(sizes.sum())} vs oracle {o_bits} bits "
                f"({100 * size_d:+.3f}%); SNR {snr_u:.3f} vs oracle "
                f"{snr_o:.3f} dB ({snr_u - snr_o:+.3f} dB)")
            assert abs(size_d) <= 0.01, size_d
            assert abs(snr_u - snr_o) <= 0.3, (snr_u, snr_o)


def phase_cli():
    from ulcx.io.wavio import WAVE_FORMAT_PCM, WavReader, WavWriter
    from ulcx.tools import decode_tool, encode_tool

    log(f"phase 5: CLI tools on a {CLI_SECONDS} s stereo WAV")
    n, rate = 2048, 44100
    rng = np.random.default_rng(5)
    tt = np.arange(CLI_SECONDS * rate) / rate
    sig = 0.3 * np.sin(2 * np.pi * 440 * tt) + 0.1 * np.sin(2 * np.pi * 2500 * tt)
    sig = sig + 0.01 * rng.standard_normal(tt.size)
    for pos in rng.integers(0, tt.size - 1000, 20):
        sig[pos:pos + 1000] += 0.4 * rng.standard_normal(1000) * np.exp(
            -np.arange(1000) / 150.0)
    x = np.clip(np.stack([sig, 0.8 * sig], axis=1), -1, 1).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.wav")
        w = WavWriter(src, rate, 2, 16, WAVE_FORMAT_PCM)
        w.write_frames(x.reshape(-1))
        w.close()
        ref = WavReader(src)
        x16 = ref.read_frames(ref.info.n_samples).reshape(-1, 2)
        ref.close()
        for name, spec in (("cbr", "128"), ("vbr", "-55"), ("abr", "128,0.5")):
            ulc = os.path.join(d, f"{name}.ulc")
            out = os.path.join(d, f"{name}.wav")
            t0 = time.perf_counter()
            assert encode_tool.main(["ulcencodetool", src, ulc, spec]) == 0
            assert decode_tool.main(["ulcdecodetool", ulc, out]) == 0
            dec = WavReader(out)
            y = dec.read_frames(dec.info.n_samples).reshape(-1, 2)
            dec.close()
            # decoded frame f reconstructs input frame f - block_size
            m = min(len(x16), len(y) - n)
            snr = snr_db(x16[:m], y[n:n + m])
            log(f"  {name} ({spec}): {os.path.getsize(ulc)} bytes, "
                f"round-trip SNR {snr:.2f} dB, "
                f"{time.perf_counter() - t0:.1f} s")
            assert snr > 10.0, (name, snr)


def phase_four_cards():
    import jax
    import jax.numpy as jnp

    from bench import assemble_streams, make_corpus
    from ulcx.parallel.mesh import data_mesh

    devs = jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    b1, t = FOUR_CARDS
    log(f"phase 6: data mesh over 4 GPUs, B=4x{b1} T={t}, stereo CBR-128 bs2048")
    cfg = codec_cfg()
    x = make_corpus(4 * b1, t, 2048)
    mesh = data_mesh(devs)
    sizes, data = encode_batch(jnp.asarray(x), cfg, mesh=mesh)
    streams, win = assemble_streams(sizes, data)
    pcm, bits, corrupt = decode_batch(jnp.asarray(streams), t, win, cfg, mesh=mesh)
    check_roundtrip(sizes, pcm, bits, corrupt)
    for k in range(4):
        sl = slice(k * b1, (k + 1) * b1)
        with jax.default_device(devs[0]):
            s1, d1 = encode_batch(jnp.asarray(x[sl]), cfg)
            assert (s1 == sizes[sl]).all() and (d1 == data[sl]).all(), k
            p1, bt1, c1 = decode_batch(jnp.asarray(streams[sl]), t, win, cfg)
        assert (bt1 == bits[sl]).all() and (c1 == corrupt[sl]).all(), k
        err = float(np.abs(p1 - pcm[sl]).max())
        log(f"  shard {k}: bytes identical to a one-card run, decode bits "
            f"identical, max |PCM diff| {err:.3g}")
        assert err <= PCM_TOL, (k, err)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded batch path on 4 GPUs")
    args = ap.parse_args(argv)

    # No GEMM autotuning: its timing runs add to every compile, and a
    # choice made by timing may differ between the two compiles that a
    # phase compares. Read when the backend starts, in phase_device.
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_gpu_autotune_level" not in flags:
        os.environ["XLA_FLAGS"] = f"{flags} --xla_gpu_autotune_level=0".strip()

    t0 = time.perf_counter()
    phase_device()
    import jax

    from ulcx.utils.compileopts import enable_compile_cache

    log(f"  compile cache: {enable_compile_cache()}")
    phases = ((phase_four_cards,) if args.four_cards else
              (phase_batch_path, phase_kernels_vs_plain, phase_oracle, phase_cli))
    for phase in phases:
        t1 = time.perf_counter()
        phase()
        log(f"  ({time.perf_counter() - t1:.1f} s)")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))


if __name__ == "__main__":
    main()
