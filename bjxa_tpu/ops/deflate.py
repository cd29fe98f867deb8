"""Vectorized XA bit-pack ("deflate") on device.

Inverse of :mod:`bjxa_tpu.ops.inflate`; device equivalent of the reference's
pack callbacks (``src/libbjxa.c:349-391``).  Keeps the top ``bits`` bits of
each 16-bit sample value and packs them densely.
"""

from __future__ import annotations

import jax.numpy as jnp

from bjxa_tpu.ops.tables import BLOCK_SAMPLES


def pack_payload(samples: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Pack int16-domain "top-bits" samples into payload bytes.

    ``samples``: int32-like ``[..., 32]`` (low 16 bits significant).
    Returns ``uint8[..., bits*4]``.
    """
    u = samples.astype(jnp.int32) & 0xFFFF  # value as uint16
    lead = u.shape[:-1]
    if bits == 4:
        pair = u.reshape(*lead, BLOCK_SAMPLES // 2, 2)
        by = ((pair[..., 0] >> 8) & 0xF0) | (pair[..., 1] >> 12)
    elif bits == 6:
        quad = (u >> 10).reshape(*lead, BLOCK_SAMPLES // 4, 4)
        w = (
            (quad[..., 0] << 18)
            | (quad[..., 1] << 12)
            | (quad[..., 2] << 6)
            | quad[..., 3]
        )
        by = jnp.stack([w >> 16, (w >> 8) & 0xFF, w & 0xFF], axis=-1).reshape(
            *lead, 24
        )
    elif bits == 8:
        by = u >> 8
    else:
        raise ValueError(f"pack_payload: bad bit depth {bits}")
    return by.astype(jnp.uint8)


def deflate_blocks(profiles: jnp.ndarray, samples: jnp.ndarray, bits: int):
    """Assemble raw XA blocks: profile byte + packed payload.

    ``profiles``: int-like ``[...]``; ``samples``: ``[..., 32]``.
    Returns ``uint8[..., block_size]``.
    """
    payload = pack_payload(samples, bits)
    prof = profiles.astype(jnp.uint8)[..., None]
    return jnp.concatenate([prof, payload], axis=-1)
