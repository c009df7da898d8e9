"""Where the package meets the machine it runs on.

Every solver path is plain JAX/XLA, the same on every backend, and no
default depends on the backend: complex systems run as native
``complex64`` unless a caller asks for float32 planes (``planes=True``,
``HelmholtzConfig.use_planes``), and ``fgmres`` takes one Arnoldi step
per device program (``HelmholtzConfig.fgmres_chunk=1``).  Both defaults
were measured on an H100 against the alternatives (``PERF.md``).

:func:`use_compile_cache` is the one place that sets JAX's persistent
compilation cache.
"""
from __future__ import annotations

import os

import jax


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache lives in ``.jax_cache``
    at the root of the checkout this package was imported from.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
