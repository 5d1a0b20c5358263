"""Measure ulcx-vs-oracle deviation across configs (CPU).

Prints size delta, RMS(ulcx-oracle), and round-trip SNRs of both
stacks vs the (1-block-delayed) input. Used to calibrate the
test_oracle_quality thresholds and PARITY.md numbers.
"""

import os
import sys
import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import oracle
from test_oracle_quality import _material, _encode_ulcx, _decode_ulcx
import jax

jax.config.update("jax_platforms", "cpu")
from ulcx.utils.config import CodecConfig


def run(n, c, mode, t=4, transients=True, kind=None, **kw):
    if kind is not None:
        # realistic synthesized material (tests/material.py)
        import material

        blocks = material.blocks_of(kind, n, t, c)
    else:
        blocks = _material(n, t, c, transients=transients)
    cfg = CodecConfig(rate_hz=44100, n_chan=c, block_size=n, noise_run_window="gap")
    su, du = _encode_ulcx(blocks, cfg, mode, **kw)
    pu = _decode_ulcx(su, du, t, cfg)
    enc = oracle.OracleEncoder(44100, c, n)
    so, do = [], []
    for bb in blocks:
        if mode == "cbr":
            s, d = enc.encode_block_cbr(bb, kw["rate_kbps"])
        elif mode == "abr":
            s, d = enc.encode_block_abr(bb, kw["rate_kbps"], kw["avg_complexity"])
        else:
            s, d = enc.encode_block_vbr(bb, kw["quality"])
        so.append(s)
        do.append(d)
    po = oracle.decode_stream(b"".join(do), t, n, c)
    sd = abs(float(np.sum(su)) - sum(so)) / sum(so)
    rms = float(np.sqrt(np.mean((pu.astype(np.float64) - po) ** 2)))
    ref = blocks[:-1].astype(np.float64)

    def snr(p):
        e = p[1:] - ref
        return 10 * np.log10(np.sum(ref**2) / max(np.sum(e**2), 1e-30))

    # per-block decomposition: how much of the f32-vs-
    # f64 deviation is byte-identical blocks vs tie-flipped coding
    # decisions, and does any flip degrade quality?
    n_match = 0
    dsnrs = []
    for i in range(len(do)):
        bu = np.asarray(du[i][: int(su[i]) // 8]).tobytes()
        n_match += bu == do[i]
        r = blocks[i].astype(np.float64) if i + 1 < len(do) else None
        if r is not None:
            eu = pu[i + 1] - r
            eo = po[i + 1] - r
            p_ref = max(np.sum(r**2), 1e-30)
            s_u = 10 * np.log10(p_ref / max(np.sum(eu**2), 1e-30))
            s_o = 10 * np.log10(p_ref / max(np.sum(eo**2), 1e-30))
            dsnrs.append(s_u - s_o)
    per_block = dict(
        match_frac=n_match / len(do),
        worst_dsnr=float(min(dsnrs)) if dsnrs else 0.0,
        best_dsnr=float(max(dsnrs)) if dsnrs else 0.0,
    )
    return sd, rms, snr(pu), snr(po), per_block


CASES = [
    ("cbr mono96 bs1024 trans", dict(n=1024, c=1, mode="cbr", rate_kbps=96.0)),
    ("cbr mono96 bs1024 plain", dict(n=1024, c=1, mode="cbr", transients=False, rate_kbps=96.0)),
    ("cbr st128 bs2048 trans", dict(n=2048, c=2, mode="cbr", t=3, rate_kbps=128.0)),
    ("cbr st128 bs2048 plain", dict(n=2048, c=2, mode="cbr", t=3, transients=False, rate_kbps=128.0)),
    ("vbr q50 st bs1024 trans", dict(n=1024, c=2, mode="vbr", quality=50.0)),
    ("abr st128 bs1024 trans", dict(n=1024, c=2, mode="abr", rate_kbps=128.0, avg_complexity=0.5)),
    # bs4096 rides the factorized transform backend (auto: n > matmul_max_n)
    ("abr st128 bs4096 trans", dict(n=4096, c=2, mode="abr", t=3, rate_kbps=128.0, avg_complexity=0.5)),
    # realistic synthesized material (tests/material.py)
    ("cbr st128 bs2048 speech", dict(n=2048, c=2, mode="cbr", kind="speech", rate_kbps=128.0)),
    ("cbr st128 bs2048 percus", dict(n=2048, c=2, mode="cbr", kind="percussion", rate_kbps=128.0)),
    ("cbr st128 bs2048 poly", dict(n=2048, c=2, mode="cbr", kind="poly", rate_kbps=128.0)),
    ("vbr q50 st bs1024 poly", dict(n=1024, c=2, mode="vbr", kind="poly", quality=50.0)),
    ("abr st128 bs1024 percus", dict(n=1024, c=2, mode="abr", kind="percussion", rate_kbps=128.0, avg_complexity=0.5)),
]

if sys.argv[1:]:
    CASES = [(nm, kw) for nm, kw in CASES if any(a in nm for a in sys.argv[1:])]

for name, kw in CASES:
    sd, rms, s_u, s_o, pb = run(**kw)
    print(
        f"{name:28s} sizeD {100*sd:6.3f}%  rms {rms:.2e}  "
        f"snr_ulcx {s_u:6.2f}  snr_oracle {s_o:6.2f}  dsnr {s_u-s_o:+.2f}  "
        f"blocks byte-id {100*pb['match_frac']:5.1f}%  "
        f"per-block dsnr [{pb['worst_dsnr']:+.2f}, {pb['best_dsnr']:+.2f}] dB",
        flush=True,
    )
