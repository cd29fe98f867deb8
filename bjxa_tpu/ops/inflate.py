"""Vectorized XA bit-unpack ("inflate") on device.

Device equivalent of the reference's per-block unpack callbacks
(``src/libbjxa.c:286-345``): instead of one 32-sample block at a time through
a function pointer, whole ``[..., blocks, block_size]`` arrays are unpacked
with a handful of fused elementwise integer ops — embarrassingly parallel,
VPU-friendly, specialized on the static bit depth (no dynamic dispatch under
jit).

Packed samples land in the *top* ``bits`` bits of an int16 (the format
produces negative values by design); everything here stays in int32 with the
low 16 bits holding the sign-extended int16 value.
"""

from __future__ import annotations

import jax.numpy as jnp

from bjxa_tpu.ops.tables import BLOCK_SAMPLES


def sign_extend_16(x: jnp.ndarray) -> jnp.ndarray:
    """Sign-extend the low 16 bits of an int32 array in place of int16."""
    x = x.astype(jnp.int32)
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def unpack_payload(payload: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Unpack packed sample bytes to int32 "top-bits" sample values.

    ``payload``: ``uint8[..., bits*4]``.  Returns ``int32[..., 32]``.
    The bit layouts mirror the format spec exactly (4-bit: two nibbles per
    byte; 6-bit: 3 bytes -> 4 samples through a 24-bit window; 8-bit: one
    byte shifted high).
    """
    b = payload.astype(jnp.int32)
    lead = b.shape[:-1]
    if bits == 4:
        hi = (b & 0xF0) << 8
        lo = (b & 0x0F) << 12
        out = jnp.stack([hi, lo], axis=-1).reshape(*lead, BLOCK_SAMPLES)
    elif bits == 6:
        trip = b.reshape(*lead, 8, 3)
        w = (trip[..., 0] << 16) | (trip[..., 1] << 8) | trip[..., 2]
        out = jnp.stack(
            [
                (w & 0x00FC0000) >> 8,
                (w & 0x0003F000) >> 2,
                (w & 0x00000FC0) << 4,
                (w & 0x0000003F) << 10,
            ],
            axis=-1,
        ).reshape(*lead, BLOCK_SAMPLES)
    elif bits == 8:
        out = b << 8
    else:
        raise ValueError(f"unpack_payload: bad bit depth {bits}")
    return sign_extend_16(out)


def unpack_payload_lanes(payload: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Lane-major twin of :func:`unpack_payload`.

    ``payload``: ``uint8[B, bits*4, L]`` — packed sample bytes with the lane
    axis minor (the layout the fused kernel and the corpus engine stage).
    Returns ``int16[B, 32, L]``.  Every op is elementwise over ``[B, ·, L]``
    slabs — no full-array relayout; only small stacks along the sample axis.
    """
    b = payload.astype(jnp.int32)
    B, nbytes, L = b.shape
    if bits == 4:
        hi = (b & 0xF0) << 8  # [B, 16, L] -> samples 0, 2, 4, ...
        lo = (b & 0x0F) << 12  # -> samples 1, 3, 5, ...
        out = jnp.stack([hi, lo], axis=2).reshape(B, BLOCK_SAMPLES, L)
    elif bits == 6:
        t0 = b[:, 0::3]  # [B, 8, L] first byte of each 3-byte triple
        t1 = b[:, 1::3]
        t2 = b[:, 2::3]
        s0 = (t0 & 0xFC) << 8
        s1 = ((t0 & 0x03) << 14) | ((t1 & 0xF0) << 6)
        s2 = ((t1 & 0x0F) << 12) | ((t2 & 0xC0) << 4)
        s3 = (t2 & 0x3F) << 10
        out = jnp.stack([s0, s1, s2, s3], axis=2).reshape(
            B, BLOCK_SAMPLES, L
        )
    elif bits == 8:
        out = b << 8
    else:
        raise ValueError(f"unpack_payload_lanes: bad bit depth {bits}")
    return sign_extend_16(out).astype(jnp.int16)


def inflate_lanes(blocks_t: jnp.ndarray, bits: int):
    """Lane-major twin of :func:`inflate_blocks`.

    ``blocks_t``: ``uint8[B, block_size, L]`` raw blocks, lane-minor.
    Returns ``(profile int32[B, L], samples int16[B, 32, L])``.
    """
    profiles = blocks_t[:, 0, :].astype(jnp.int32)
    samples = unpack_payload_lanes(blocks_t[:, 1:, :], bits)
    return profiles, samples


def inflate_blocks(blocks: jnp.ndarray, bits: int):
    """Split raw XA blocks into profiles and unpacked sample values.

    ``blocks``: ``uint8[..., block_size]`` with the leading profile byte.
    Returns ``(profile int32[...], samples int16[..., 32])`` — samples are
    int16 by construction (top-bits domain), and keeping them narrow
    halves the HBM traffic of the layout passes between unpack and the
    filter kernel.
    """
    profiles = blocks[..., 0].astype(jnp.int32)
    samples = unpack_payload(blocks[..., 1:], bits).astype(jnp.int16)
    return profiles, samples
