"""The two-tap ADPCM prediction filter as a lane-vectorized scan.

This is the sequential hot loop of the codec (reference:
``bjxa_decode_inflated``, ``src/libbjxa.c:533-578``).  The recurrence

    sample[n] = clamp_i16(ranged[n] + trunc(prev0*k0 + prev1*k1, /256))
    prev1, prev0 = prev0, sample[n]

is non-associative (int16 saturation + truncating division), so the
device formulation keeps the honest sample-order recurrence but runs it
simultaneously over a large *lane* axis — independent channel streams
(files x channels, or chunks of one stream for the fixed-point parallel
decoder in :mod:`bjxa_tpu.ops.decode`).  Each scan step is a handful of
elementwise ops over ``[lanes]`` vectors; the per-block inner 32 steps
are unrolled so gain coefficients are loop-invariant within a step.

C integer semantics reproduced exactly:

* ``gain / 256`` truncates toward zero -> ``(g + ((g >> 31) & 255)) >> 8``
* ``value >> range`` is an arithmetic shift of the int16 value
* clamp saturates to [-32768, 32767] before state update
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from bjxa_tpu.ops.tables import (
    BLOCK_SAMPLES,
    GAIN_K0,
    GAIN_K1,
    INT16_MAX,
    INT16_MIN,
    NUM_FACTORS,
)


def trunc_div_256(g: jnp.ndarray) -> jnp.ndarray:
    """C-style ``g / 256`` (truncation toward zero) without a hardware div."""
    return (g + ((g >> 31) & 255)) >> 8


def profile_gains(profiles: jnp.ndarray):
    """Decode profile bytes into (k0, k1, shift, valid).

    ``profiles``: int32 ``[...]``.  Gathers are clipped so invalid factors
    (>= 5) still produce defined (garbage) output; ``valid`` lets the host
    raise the EPROTO-equivalent, mirroring ``src/libbjxa.c:550``.
    """
    factor = (profiles >> 4) & 0x0F
    shift = profiles & 0x0F
    valid = factor < NUM_FACTORS
    k0 = jnp.asarray(GAIN_K0)[jnp.minimum(factor, NUM_FACTORS - 1)]
    k1 = jnp.asarray(GAIN_K1)[jnp.minimum(factor, NUM_FACTORS - 1)]
    return k0.astype(jnp.int32), k1.astype(jnp.int32), shift, valid


def adpcm_filter_lanes(
    ranged: jnp.ndarray,
    k0: jnp.ndarray,
    k1: jnp.ndarray,
    state: jnp.ndarray,
    with_output: bool = True,
):
    """Run the prediction filter over every lane simultaneously.

    Args:
      ranged: ``int32[B, 32, L]`` — unpacked samples already shifted by the
        block range (i.e. the ``ranged`` operand of the recurrence).
      k0, k1: ``int32[B, L]`` — per-block gain coefficients per lane.
      state:  ``int32[L, 2]`` — (prev0, prev1) predictor state per lane.
      with_output: when False only the end state is computed (used by the
        state-propagation passes of the parallel decoder); the compiler
        then allocates no output buffer.

    Returns:
      ``(pcm int16[B, 32, L] | None, end_state int32[L, 2])``
    """
    p0 = state[:, 0]
    p1 = state[:, 1]

    def step(carry, xs):
        c0, c1 = carry
        r_blk, k0_b, k1_b = xs  # [32, L], [L], [L]
        outs = []
        for n in range(BLOCK_SAMPLES):
            gain = c0 * k0_b + c1 * k1_b
            s = r_blk[n] + trunc_div_256(gain)
            s = jnp.clip(s, INT16_MIN, INT16_MAX)
            c1 = c0
            c0 = s
            if with_output:
                outs.append(s)
        y = (
            jnp.stack(outs, axis=0).astype(jnp.int16)
            if with_output
            else None
        )
        return (c0, c1), y

    (p0, p1), pcm = lax.scan(step, (p0, p1), (ranged, k0, k1))
    end_state = jnp.stack([p0, p1], axis=-1)
    return pcm, end_state


#: The kernel route for each JAX platform: hand-written Pallas kernels
#: compiled through Triton on the GPU, plain XLA programs on the CPU.
ROUTES = {"gpu": "triton", "cpu": "xla"}


def kernel_route() -> str:
    """The kernel route of the default JAX backend: ``"triton"`` or ``"xla"``.

    The one place that maps the platform to a code path; every device
    dispatch asks it at trace time.  A platform with no route is an error.
    """
    platform = jax.default_backend()
    if platform not in ROUTES:
        raise RuntimeError(f"no kernel route for JAX platform {platform!r}")
    return ROUTES[platform]


def decode_lanes(
    profiles: jnp.ndarray,
    samples: jnp.ndarray,
    state: jnp.ndarray,
    with_output: bool = True,
):
    """Full per-lane block decode (XLA): profile decode, range shift, filter.

    Args:
      profiles: ``int32[B, L]`` — profile byte per block per lane.
      samples:  ``int32[B, 32, L]`` — unpacked top-bits sample values.
      state:    ``int32[L, 2]``.

    Returns ``(pcm int16[B, 32, L] | None, end_state int32[L, 2],
    valid bool[B, L])``.
    """
    k0, k1, shift, valid = profile_gains(profiles)
    # keep the ranged array in the narrowest dtype the domain allows:
    # int16 when samples arrive as int16 (arithmetic shift stays in range)
    if samples.dtype == jnp.int16:
        ranged = samples >> shift.astype(jnp.int16)[:, None, :]
    else:
        ranged = samples >> shift[:, None, :]
    pcm, end_state = adpcm_filter_lanes(
        ranged, k0, k1, state, with_output=with_output
    )
    return pcm, end_state, valid
