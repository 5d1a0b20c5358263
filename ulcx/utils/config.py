"""Codec configuration.

The reference's only configuration is three compile-time feature flags
(reference include/ulcEncoder.h:9-33: ULC_USE_PSYCHOACOUSTICS,
ULC_USE_NOISE_CODING, ULC_USE_WINDOW_SWITCHING) plus the CLI parameters
(rate mode, block size, output PCM format). Here they are one runtime
dataclass; everything is static from XLA's point of view (baked into the
jitted program), so toggling a flag triggers a recompile, exactly like
the reference's #ifdef but without rebuilding.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property


MIN_CHANS = 1
MAX_CHANS = 255
MIN_BANDS = 256          # reference libulc/ulcEncoder.c:20 (transient detector limit)
MAX_BANDS = 32768
MAX_BLOCK_DECIMATION_FACTOR = 8   # reference include/ulcEncoder.h:30
MAX_SUBBLOCKS = 4
COEF_EPS = 2.0 ** -31    # reference include/ulcEncoder.h:36

N_BARK_BANDS = 25


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Static codec parameters shared by encoder and decoder.

    Mirrors the reference's ULC_EncoderState_t globals (RateHz, nChan,
    BlockSize; reference include/ulcEncoder.h:47-52) plus the three
    feature flags as runtime switches.
    """

    rate_hz: int = 44100
    n_chan: int = 2
    block_size: int = 2048
    use_psychoacoustics: bool = True
    use_noise_coding: bool = True
    use_window_switching: bool = True
    # Transform backend: "matmul" uses cosine-matrix products (exact,
    # fastest for block sizes <= matmul_max_n), "fact" factorizes the
    # DCT-IV into two small matmul stages via an M=N/2 Cooley-Tukey FFT
    # (~N^1.5 MACs, KiB-scale constants — the fast choice for large
    # blocks), "fft" uses jnp.fft (O(N log N)), "auto" picks per
    # subblock size (matmul up to matmul_max_n, fact above).
    transform_backend: str = "auto"
    # 2048: the n=4096 cosine matrices alone are ~67 MB of f32 program
    # constants (x2 for DST); the factorized transform takes over above
    matmul_max_n: int = 2048
    # CBR/ABR rate search: "ladder" evaluates 16 candidates per scan
    # round (exact under monotone Size(n)); "bisect" replicates the
    # reference's sequential bisection step-for-step.
    rate_search: str = "ladder"
    # Noise-run amplitude analysis window: "segment" averages the noise
    # spectrum over min(seg_end - pos, 527) lines — candidate-independent,
    # which makes the whole noise decision precomputable once per block.
    # "gap" replicates the reference exactly (window = min(gap_len, 527);
    # reference ulcEncoder_Encode.c:150-153), at the cost of a
    # per-candidate recompute. Both windows coincide whenever the gap
    # runs to the end of the [sub]block; levels differ by at most ~1
    # quantization step otherwise (measured corpus impact <= 0.114%
    # size / <= 0.12 dB, PARITY.md §2).
    #
    # "gap" is SCAN-ONLY: the run end is candidate-dependent state the
    # encode kernels do not carry, so "gap" encodes on the scan path
    # (ValueError under use_pallas="on" rather than a silent fallback).
    noise_run_window: str = "segment"
    # Pallas bitstream kernels (see kernel_mode): "auto" compiles them on
    # a GPU whenever n_chan*block_size <= 32768; "on" also runs them on
    # the CPU, in interpret mode, and raises ValueError on shapes outside
    # the kernel envelope (never a silent fallback); "off" always uses
    # the XLA scan path.
    use_pallas: str = "auto"
    # Whole-chunk pipeline shape: fold the block axis T into the batch
    # (scan only over window control). Byte-identical to the per-block
    # scan (tests/test_stream_flat.py); default off.
    flat_stream: bool = False
    # Fold the BITSTREAM stages (prepare/rate-search/materialize/
    # assemble) over chunks of fold_bitstream blocks while analysis
    # stays a per-block scan: the kernel pipeline then launches once
    # per chunk at fold*B streams instead of once per block, with
    # identical bytes (per-stream independence). 1 = off (per-block);
    # memory for the kernel state planes scales with fold*B.
    fold_bitstream: int = 1

    def __post_init__(self):
        if not (MIN_CHANS <= self.n_chan <= MAX_CHANS):
            raise ValueError(f"n_chan must be in [{MIN_CHANS},{MAX_CHANS}], got {self.n_chan}")
        bs = self.block_size
        if not (MIN_BANDS <= bs <= MAX_BANDS) or (bs & (bs - 1)) != 0:
            raise ValueError(f"block_size must be a power of 2 in [{MIN_BANDS},{MAX_BANDS}], got {bs}")
        if self.rate_hz < 1:
            raise ValueError(f"rate_hz must be >= 1, got {self.rate_hz}")
        if self.transform_backend not in ("auto", "matmul", "fact", "fft"):
            raise ValueError(f"bad transform_backend {self.transform_backend!r}")
        if self.rate_search not in ("ladder", "bisect"):
            raise ValueError(f"bad rate_search {self.rate_search!r}")
        if self.noise_run_window not in ("segment", "gap"):
            raise ValueError(f"bad noise_run_window {self.noise_run_window!r}")
        if self.use_pallas not in ("auto", "on", "off"):
            raise ValueError(f"bad use_pallas {self.use_pallas!r}")
        if self.noise_run_window == "gap" and self.use_pallas == "on":
            raise ValueError(
                "noise_run_window='gap' is scan-only (the C-exact run "
                "window is candidate-dependent state the streaming "
                "kernels cannot address); use use_pallas='auto'/'off' "
                "with it, or the default 'segment' window for the fast "
                "path (corpus impact <= 0.114% size, PARITY.md §2)"
            )
        if not (isinstance(self.fold_bitstream, int) and self.fold_bitstream >= 1):
            raise ValueError(
                f"fold_bitstream must be an int >= 1, got {self.fold_bitstream!r}"
            )

    @cached_property
    def max_decimation(self) -> int:
        return MAX_BLOCK_DECIMATION_FACTOR if self.use_window_switching else 1

    @cached_property
    def subblock_sizes(self) -> tuple[int, ...]:
        """All possible subblock sizes (block_size >> {0,1,2,3})."""
        if not self.use_window_switching:
            return (self.block_size,)
        return tuple(self.block_size >> s for s in range(4))

    def transform_for(self, n: int) -> str:
        """Backend name for a length-n DCT-IV/DST-IV."""
        if self.transform_backend != "auto":
            return self.transform_backend
        return "matmul" if n <= self.matmul_max_n else "fact"


KERNEL_MAX_P = 32768  # kernel envelope: n_chan * block_size


def kernel_mode(cfg: CodecConfig) -> str:
    """How the Pallas bitstream kernels run on JAX's default backend.

    "compiled" on a GPU (the Triton route); "interpret" on the CPU, and
    only when cfg.use_pallas == "on" (tests and CPU rehearsals ask for
    it); "off" means the XLA scan path, which every backend runs and
    which shapes past KERNEL_MAX_P take. Any other backend raises: the
    kernels are written for the GPU, and no other accelerator is
    supported.
    """
    import jax

    backend = jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise RuntimeError(
            f"ulcx runs on a GPU or on the CPU; the default JAX backend is "
            f"{backend!r}"
        )
    if cfg.use_pallas == "off" or (backend == "cpu" and cfg.use_pallas == "auto"):
        return "off"
    p_tot = cfg.n_chan * cfg.block_size
    if p_tot > KERNEL_MAX_P:
        if cfg.use_pallas == "on":
            raise ValueError(
                "use_pallas='on' but the shape is outside the kernel "
                f"envelope: need n_chan*block_size <= {KERNEL_MAX_P} (got "
                f"{p_tot}); use use_pallas='auto' to take the scan path on "
                "such shapes"
            )
        return "off"
    return "compiled" if backend == "gpu" else "interpret"
