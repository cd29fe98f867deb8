"""Device-mesh helpers.

Axis conventions:

* ``dp`` — data parallel over independent files (each file carries its own
  decoder state, so no communication at all; the device analog of the
  reference's decoder-per-file model, ``bjxa.3.rst.in:119-120``).
* ``sp`` — sequence parallel over the block range of one stream; shards
  exchange the 2-scalars-per-channel predictor state with ``ppermute``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    devices=None, dp: int | None = None, sp: int = 1, axis_names=("dp", "sp")
) -> Mesh:
    """Build a (dp, sp) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, axis_names)


def dp_sharding(mesh: Mesh, ndim: int, axis: str = "dp") -> NamedSharding:
    """Shard the leading (file) axis over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))
