"""Helper for registering consts dataclasses as JAX pytrees.

Device constants are passed to jitted programs as pytree leaves (so they
live in HBM once, instead of being baked into every compiled executable),
while shape-defining scalars are static metadata that participate in the
jit cache key.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def static_field(**kwargs: Any) -> Any:
    """Dataclass field treated as static (aux) data by jax pytree flattening."""
    return dataclasses.field(metadata=dict(static=True), **kwargs)


def host_const(x: Any, dtype: Any) -> Any:
    """Upload a host array as a device constant, converting dtype on HOST.

    ``jnp.asarray(x, dtype=...)`` with a mismatched host dtype stages a
    ``convert_element_type`` program on the device; doing the cast in numpy
    first uploads the final buffer directly.
    """
    import jax.numpy as jnp
    import numpy as np

    return jnp.asarray(np.asarray(x, dtype=dtype))


def int_const(x: Any) -> Any:
    """Upload integer constants as float32 (exact below 2**24).

    Every host→device buffer of the program is f32: integer constants
    cross the boundary as f32 and are converted back in-graph (`as_i32`, a
    fused convert inside the compiled program). Whether int32 and bool
    buffers can cross as themselves instead is what ``chip_smoke.py``'s
    upload phase reports.
    """
    import numpy as np

    arr = np.asarray(x)
    if arr.size and np.abs(arr).max() >= 2**24:
        # A real exception (not an assert): ``python -O`` must not strip
        # the guard and let positions silently round in f32. The detector
        # validates chunk-size configs up front with a user-facing message
        # (models/detector.py); this is the backstop for internal callers.
        raise ValueError(
            f"integer constant {np.abs(arr).max()} exceeds float32 "
            f"exactness (2**24)"
        )
    return host_const(arr, np.float32)


def mask_const(x: Any) -> Any:
    """Upload a boolean mask as float32 0/1 (see :func:`int_const`)."""
    import numpy as np

    return host_const(np.asarray(x, dtype=bool), np.float32)


def as_i32(a: Any) -> Any:
    """In-graph f32 → int32 for constants uploaded via :func:`int_const`."""
    import jax.numpy as jnp

    return a.astype(jnp.int32)


def as_mask(a: Any) -> Any:
    """In-graph f32 0/1 → bool for :func:`mask_const` uploads."""
    return a != 0
