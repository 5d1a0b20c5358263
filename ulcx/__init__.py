"""ulcx — batched ULC audio codec framework for GPUs.

A brand-new JAX/XLA implementation of the capabilities of the ulc-codec
reference (an MDCT audio codec with sine windows, window switching +
overlap scaling, Bark-band psychoacoustics, noise-fill, companded
quantization, a nybble bitstream, and CBR/ABR/VBR rate control),
re-architected batch-first for an accelerator (an NVIDIA GPU):

- streams are a batch axis (``vmap`` / ``shard_map`` over a device mesh),
- blocks are a ``lax.scan`` carrying a functional codec state pytree,
- the lapped transforms are batched matmuls / factorized FFTs,
- rate control is an on-device vectorized bisection.

Reference semantics: /root/reference (Aikku93/ulc-codec); see SURVEY.md.
"""

__version__ = "0.1.0"

from ulcx.utils.config import CodecConfig  # noqa: F401
