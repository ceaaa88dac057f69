"""Persistent XLA compilation cache wiring.

The test suite and the scripts compile many small programs; caching them
on disk lets every process after the first skip those compiles. Call
:func:`enable` before the first jit compile (idempotent).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and this module sets no directory of its own; otherwise the cache
lives at the fixed ``<repo>/.jax_cache`` (a fixed path, because the path
is part of the cache key).
"""

import os

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    '.jax_cache',
)


def enable():
    """Turn on JAX's persistent compilation cache and return its directory."""
    import jax

    cache_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if not cache_dir:
        cache_dir = _DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update('jax_compilation_cache_dir', cache_dir)
    # cache every program, however quick its compile
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    return cache_dir
