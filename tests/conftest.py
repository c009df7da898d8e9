"""Test configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
can be exercised without GPUs (the stand-in for the reference's
``mpirun --oversubscribe -n 5`` single-machine multi-process testing,
``p_helmholtz.py:7``).  x64 is enabled so the NumPy float64 oracles can be
matched tightly; library code is dtype-explicit and unaffected.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Pin the CPU in-process too, before any backend is initialised, so an
# accelerator plugin that registers itself cannot take over.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
