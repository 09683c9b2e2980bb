"""Contiguous-window extraction primitives.

Every hot-path window extraction goes through vmapped
``lax.dynamic_slice`` (one contiguous slice per window) instead of an
element gather (``take_along_axis`` / integer fancy-indexing), so XLA
sees slice-granularity gathers of contiguous windows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def slice_rows_windows(
    x: jnp.ndarray,  # (G, L)
    starts: jnp.ndarray,  # (G, K) int32, pre-clipped to [0, L - width]
    width: int,
) -> jnp.ndarray:  # (G, K, width)
    """Per-row contiguous windows: out[g, k] = x[g, starts[g, k]:+width]."""

    def per_row(row, st):
        return jax.vmap(lambda s: jax.lax.dynamic_slice(row, (s,), (width,)))(st)

    return jax.vmap(per_row)(x, starts)


def slice_shared_windows(
    x: jnp.ndarray,  # (L,)
    starts: jnp.ndarray,  # (...,) int32, pre-clipped to [0, L - width]
    width: int,
) -> jnp.ndarray:  # (*starts.shape, width)
    """Contiguous windows of a shared 1-D signal at arbitrary starts."""
    flat = starts.reshape(-1)
    out = jax.vmap(lambda s: jax.lax.dynamic_slice(x, (s,), (width,)))(flat)
    return out.reshape(*starts.shape, width)
