"""Data-parallel batch execution over a device mesh.

The codec's only meaningful distribution axis is the *stream batch*
(the reference is a strictly sequential per-block streaming codec; see
SURVEY.md §2): streams are independent, so we shard them over the mesh
and let every device run the identical block pipeline on its shard. No
codec state ever crosses devices — the only collectives are ``psum``s
of bitrate/complexity metrics.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ulcx.analysis.block import EncoderCarry
from ulcx.codec.decoder import DecoderCarry, decode_stream
from ulcx.codec.encoder import encode_stream
from ulcx.utils.config import CodecConfig


def data_mesh(devices=None, name: str = "data") -> Mesh:
    devices = jax.devices() if devices is None else devices
    import numpy as np

    return Mesh(np.asarray(devices), (name,))


def batch_encode(blocks, cfg: CodecConfig, mode: str, mesh: Mesh | None = None,
                 scan_major: bool = False, **kw):
    """Encode a batch of streams: blocks [B, T, C, N] -> EncodedBlock
    arrays with leading [B, T] ([T, B] with scan_major=True — skips the
    output relayout; see encode_stream_batched), plus psum'd aggregate
    stats.

    Without a mesh this is a plain vmap; with a mesh the batch axis is
    sharded over it (pure DP, collective-free except metric reduction).
    """

    from ulcx.codec.encoder import encode_stream_batched

    def vmapped(bb):
        out, _ = encode_stream_batched(bb, cfg, mode, scan_major=scan_major, **kw)
        return out

    if mesh is None:
        out = vmapped(blocks)
        total_bits = jnp.sum(out.size_bits)
        return out, {"total_bits": total_bits, "avg_complexity": jnp.mean(out.complexity)}

    from jax import shard_map

    axis = mesh.axis_names[0]
    # scan_major leaves are [T, B_shard, ...]: the batch axis moves to 1
    out_spec = P(None, axis) if scan_major else P(axis)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(out_spec, P()),
        check_vma=False,
    )
    def sharded(b):
        out = vmapped(b)
        stats = jnp.stack(
            [
                jnp.sum(out.size_bits).astype(jnp.float32),
                jnp.sum(out.complexity),
            ]
        )
        stats = jax.lax.psum(stats, axis)
        return out, stats

    out, stats = sharded(blocks)
    nblk = blocks.shape[0] * blocks.shape[1]
    return out, {"total_bits": stats[0], "avg_complexity": stats[1] / nblk}


def batch_decode(
    streams, n_blocks: int, window_bytes: int, cfg: CodecConfig, mesh: Mesh | None = None
):
    """Decode a batch of padded byte streams [B, S] -> pcm [B, T, C, N]."""
    from ulcx.codec.decoder import decode_stream_batched
    from ulcx.utils.config import kernel_mode

    mode = kernel_mode(cfg)

    def vmapped(ss):
        if mode != "off":
            return decode_stream_batched(
                ss, n_blocks, window_bytes, cfg, interpret=mode == "interpret"
            )
        return jax.vmap(
            lambda s: decode_stream(s, n_blocks, window_bytes, cfg)[:3]
        )(ss)
    if mesh is None:
        return vmapped(streams)

    from jax import shard_map

    axis = mesh.axis_names[0]
    return shard_map(
        vmapped,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )(streams)
