"""Where JAX keeps its persistent compilation cache: one rule for every
entry point (CLIs, bench.py, chip_smoke.py, tools).

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache lives in ``<checkout>/.jax_cache`` (listed in
``.gitignore``), a fixed path, so later runs from the same checkout hit.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str:
    """The directory the rule picks (nothing is created or configured)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def configure() -> str:
    """Apply the rule to this process's JAX config; returns the directory."""
    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
