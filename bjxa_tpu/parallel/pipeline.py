"""The flagship end-to-end device step: sharded corpus transcode.

One step = decode a sharded batch of XA streams, run the exhaustive
profile-search re-encoder over the decoded PCM, and reduce a global
quality metric — the codec-engine analog of a "training step", exercising
every hot kernel (fused decode, 80-candidate search, deflate)
under one jit over a device mesh.

Sharding layout: files over ``dp``, channels over ``cp`` (stereo filters
are fully independent given their own state — the free lane dimension the
reference exploits as two sequential calls, SURVEY §2.5).  All lane math is
elementwise, so XLA partitions without communication; only the scalar
metric reduction becomes a cross-device collective.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bjxa_tpu.ops.decode import lanes_decoder
from bjxa_tpu.ops.deflate import deflate_blocks
from bjxa_tpu.ops.encode import encode_search


@partial(jax.jit, static_argnames=("bits",))
def transcode_step(blocks: jnp.ndarray, states: jnp.ndarray, *, bits: int):
    """Decode + search-re-encode one batch; returns re-encoded blocks and a
    global mean-squared reconstruction error.

    Args:
      blocks: ``uint8[N, C, B, block_size]``.
      states: ``int32[N, C, 2]``.

    Returns ``(xa uint8[N, B, C, block_size], mse float32)``.
    """
    N, C, B, S = blocks.shape
    blocks_t = blocks.transpose(2, 3, 0, 1).reshape(B, S, N * C)
    pcm, _end = lanes_decoder(blocks_t, bits)(
        states.reshape(N * C, 2).astype(jnp.int32), True
    )

    enc_prof, coded, recon, _ = encode_search(
        pcm.astype(jnp.int32), jnp.zeros((N * C, 2), jnp.int32), bits=bits
    )
    err = (recon.astype(jnp.float32) - pcm.astype(jnp.float32)) ** 2
    mse = jnp.mean(err)

    xa = deflate_blocks(
        enc_prof, coded.transpose(0, 2, 1), bits
    )  # [B, N*C, block_size]
    xa = xa.reshape(B, N, C, S).transpose(1, 0, 2, 3)
    return xa, mse


def corpus_shardings(mesh: Mesh):
    """Input shardings for :func:`transcode_step` on a (dp, cp) mesh."""
    return (
        NamedSharding(mesh, P("dp", "cp", None, None)),
        NamedSharding(mesh, P("dp", "cp", None)),
    )
