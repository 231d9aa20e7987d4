"""Persistent XLA compilation cache at a fixed place.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` before their first compile; importing the
package never touches the cache, so the tests write none.  JAX keys cache
entries by program, not by directory, but a directory that moves between
runs is never found again -- hence one fixed path per checkout.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=os.environ) -> str:
    """Where the cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when set
    (JAX reads the variable itself), else ``<checkout>/.jax_cache``."""
    return environ.get(ENV_VAR) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on for this process; returns its
    directory.  Every compiled program is kept, however fast it compiled:
    a cold run of the overlapper compiles hundreds of small programs."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return compile_cache_dir()
