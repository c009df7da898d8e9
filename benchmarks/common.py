"""Shared pieces of the GPU benchmark scripts in this directory.

Every script runs on the GPU only (``require_gpu``), times device-resident
solves through the public solver API (``tpcg.block_cg`` on a container
from ``tpcg.to_device_matrix`` / ``tpcg.problems``, or the planes twin),
and prints one JSON line per measurement with the device it ran on.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def require_gpu():
    """Fail unless JAX's first device is a GPU; turn on the compile cache.
    Returns the device description printed with every result."""
    import jax
    from tpcg.backend import use_compile_cache
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"this benchmark measures the GPU; JAX found "
                         f"{dev.platform!r}")
    use_compile_cache()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_line()}


def card_line() -> str:
    """``nvidia-smi`` name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def emit(record: dict, path=None):
    line = json.dumps(record)
    print(line, flush=True)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")


def time_call(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` fenced by ``block_until_ready``,
    after one warm-up call (which compiles)."""
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def cg_program(A, B, iters: int, planes: bool = False):
    """A jitted fixed-iteration block CG over container ``A`` and host RHS
    ``B`` (n,) or (n, nrhs), with its device operands: returns
    ``(fn, args)`` so that ``fn(*args)`` is ``(x, residual history)`` --
    the solution is an output, so the timed program computes it.
    ``planes`` runs a complex system as float32 planes."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpcg import block_cg
    from tpcg.ops import block_cg_planes_chunked, make_pair_operator

    if planes:
        op = make_pair_operator(A, dtype=jnp.float32)
        B = np.asarray(B)
        rhs = jnp.asarray(np.stack([B.real, B.imag]).astype(np.float32))
        solve = block_cg_planes_chunked
    else:
        op = jax.device_put(A)
        rhs = jnp.asarray(B)
        solve = block_cg

    def run(op, b):
        res = solve(op, b, n_iterations=iters)
        return res.x, res.residual_history
    return jax.jit(run), (op, rhs)


def cg_gflops(n: int, nnz: int, iters: int, seconds: float,
              is_complex: bool, nrhs: int = 1) -> float:
    """Report Table II accounting: real 2*nnz + 10*n per iteration,
    complex 8*nnz + 40*n."""
    per = (8 * nnz + 40 * n) if is_complex else (2 * nnz + 10 * n)
    return per * nrhs * iters / seconds / 1e9
