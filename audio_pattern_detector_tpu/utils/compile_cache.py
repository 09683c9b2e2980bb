"""Persistent on-disk XLA executable cache for cold-start reduction.

The reference project's native-helper exists largely to cut container
cold-start (reference: docs/native-helper.md:9-15). The analogous
cold-start cost here is XLA compilation: without a persistent cache every
CLI process recompiles the bank programs. JAX serializes compiled
executables to a directory; later processes with identical programs load
instead of compiling.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set → JAX reads it itself and this module
  sets nothing;
* otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (a fixed path, because the path is part of the cache key);
* ``APD_COMPILE_CACHE=off`` (or ``0``/``none``/empty) → no cache.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str | None:
    """Point JAX's compilation cache at its persistent directory.

    Returns the cache directory in use, or None when disabled. Safe to
    call any time before the first compilation; idempotent.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    switch = os.environ.get("APD_COMPILE_CACHE")
    if switch is not None and switch.strip().lower() in ("off", "0", "none", ""):
        return None
    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
    except OSError:  # read-only checkout: run uncached
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # Default threshold (1 s) skips small programs; the per-class
    # detection programs routinely sit near it, so lower the bar.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
