"""Device mesh construction helpers."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    axis_sizes: "dict[str, int] | None" = None,
    devices: "list | None" = None,
) -> Mesh:
    """Build a Mesh over the available devices.

    ``axis_sizes`` maps axis name -> size, e.g. {"stream": 2, "time": 4}.
    Defaults to a 1-D "time" mesh over all devices.
    """
    if devices is None:
        devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = {"time": len(devices)}
    shape = tuple(axis_sizes.values())
    total = int(np.prod(shape))
    if total > len(devices):
        raise ValueError(
            f"mesh needs {total} devices, only {len(devices)} available"
        )
    # Plain enumeration order: the devices are joined all to all, so no
    # ordering puts mesh neighbours closer than any other pair.
    grid = np.asarray(devices[:total]).reshape(shape)
    return Mesh(grid, tuple(axis_sizes.keys()))
