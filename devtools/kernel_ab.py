"""End-to-end A/B of the Pallas bitstream kernels against the plain XLA
path on one GPU: batch_encode and batch_decode of the bench corpus
(stereo 44.1 kHz bs2048, CBR-128) with the kernels at one or more lane
widths, and with use_pallas="off". With --decode-families it also
times decode with one of its two kernels (token FSM, noise replay) run
as Pallas interpret mode, i.e. the same loop compiled by XLA as a while
loop, to attribute the decode gain to each kernel.

Usage: python devtools/kernel_ab.py [--batch 512] [--blocks 64]
                                    [--lanes 2,4] [--reps 3] [--no-off]
                                    [--decode-families]

Prints one JSON line per (variant, direction) with the best wall time
of --reps calls after a warm-up (compile) call, the realtime factor,
and the card (name and power limit from nvidia-smi). The kernel
variants must produce identical bytes; the "off" encode runs another
rate search (PARITY.md §3), so only its time is compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--lanes", default="2")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-off", action="store_true",
                    help="skip the use_pallas='off' variant")
    ap.add_argument("--decode-families", action="store_true",
                    help="also time decode with the FSM or the replay kernel "
                         "replaced by its XLA-compiled interpret form")
    args = ap.parse_args()

    from bench import assemble_streams, best_time, make_corpus, require_gpu

    device = require_gpu()
    import jax
    import jax.numpy as jnp

    from ulcx.bitstream import fast_decode as fd
    from ulcx.bitstream import pallas_decode as pd
    from ulcx.bitstream import pallas_encode3 as pe3
    from ulcx.parallel.mesh import batch_decode, batch_encode
    from ulcx.utils.compileopts import enable_compile_cache
    from ulcx.utils.config import CodecConfig

    enable_compile_cache()
    b, t = args.batch, args.blocks
    x = jnp.asarray(make_corpus(b, t, 2048))
    seconds = b * t * 2048 / 44100.0
    variants = [("kernels", int(w)) for w in args.lanes.split(",")]
    if args.decode_families:
        variants += [("fsm-xla", variants[0][1]), ("replay-xla", variants[0][1])]
    if not args.no_off:
        variants.append(("off", None))
    # decode_block_fast passes (args..., interpret) positionally
    kernels = {"fsm-xla": ("fsm_records", 2), "replay-xla": ("expand_coefs", 3)}

    def emit(variant, lanes, direction, best, compile_s):
        print(json.dumps({
            "variant": variant, "lanes": lanes, "direction": direction,
            "batch": b, "blocks": t, "best_s": best,
            "x_realtime": seconds / best, "first_call_s": compile_s,
            **device,
        }), flush=True)

    ref = None
    streams = win = None
    for variant, lanes in variants:
        if lanes is not None:  # read when the kernels are traced
            pe3.LANES = pd.LANES = lanes
        cfg = CodecConfig(rate_hz=44100, n_chan=2, block_size=2048,
                          use_pallas="off" if variant == "off" else "auto")
        if variant in kernels:
            name, n_args = kernels[variant]
            orig = getattr(fd, name)
            setattr(fd, name, lambda *a: orig(*a[:n_args], interpret=True))
            try:
                dec = jax.jit(lambda s: batch_decode(s, t, win, cfg))
                t0 = time.perf_counter()
                best, (_, bits, corrupt) = best_time(dec, streams, reps=args.reps)
                first = time.perf_counter() - t0 - best * args.reps
            finally:
                setattr(fd, name, orig)
            assert not np.asarray(corrupt).any(), variant
            emit(variant, lanes, "decode", best, first)
            continue
        enc = jax.jit(lambda v: batch_encode(v, cfg, "cbr", rate_kbps=128.0)[0])
        t0 = time.perf_counter()
        best, out = best_time(enc, x, reps=args.reps)
        first = time.perf_counter() - t0 - best * args.reps  # upper bound
        emit(variant, lanes, "encode", best, first)
        sizes, data = np.asarray(out.size_bits), np.asarray(out.data)
        if variant == "kernels":
            if ref is None:
                ref = (sizes, data)
                streams, win = assemble_streams(sizes, data)
                streams = jnp.asarray(streams)
            else:
                assert (sizes == ref[0]).all() and (data == ref[1]).all(), lanes
        dec = jax.jit(lambda s: batch_decode(s, t, win, cfg))
        t0 = time.perf_counter()
        best, (_, bits, corrupt) = best_time(dec, streams, reps=args.reps)
        first = time.perf_counter() - t0 - best * args.reps
        assert not np.asarray(corrupt).any(), variant
        emit(variant, lanes, "decode", best, first)


if __name__ == "__main__":
    main()
