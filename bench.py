"""Headline benchmark: single-precision complex CG on the Helmholtz FE
matrix -- the reference's ``helm_fem`` configuration (report Table I:
n = 16384 = 128^2, nnz = 113,666; report Fig. 5 baseline: 2.390 GFLOPS on
an RTX 2080S at 5000 iterations, 1 RHS).

The timed program is ``jax.jit`` of ``tpcg.block_cg`` on the
device-resident ``Stencil2D`` in native complex64 -- the program that
``plan_stencil_cg`` compiles for one right-hand side -- and it returns
the solution together with the residual history, so the whole
5000-iteration recurrence, ``x`` update included, is what is timed.  FLOP
accounting follows report Table II (complex: SpMV 8*nnz, dot 8*n x2,
axpy-class 8*n x3 per iteration).

Parity gate, on the output of the timed program itself: its residual
history over the first 100 iterations within 1e-2 relative of the float64
oracle (float32 arithmetic summed in another order), and the float64
true residual ||b - A x|| / ||b|| of its solution at most the largest of
2 x the oracle's, 1e-5 and sqrt(k) eps32 || |A| |x| || / ||b|| (the
float32 floor, as in ``chip_smoke.py``).  No GFLOPS are printed unless
both hold.

Timing: the program is compiled and run once, then timed over ``reps``
calls, each fenced by ``block_until_ready`` (which waits for the device
on a GPU); the median is reported.  One call is one whole solve, so the
host's per-call overhead (tens of microseconds) is far below the solve.

Run on the GPU: ``python bench.py``.  It exits non-zero when JAX finds no
GPU.  Prints the card's name and power limit, then one JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "path"}.
"""
import json
import statistics
import subprocess
import time

import numpy as np

GATE_ITERS = 100
GATE_HISTORY_TOL = 1e-2
EPS32 = 2.0 ** -24


def card_line() -> str:
    """`nvidia-smi` name and power limit of the card, as it prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def parity_gate(A64, b, x, hist, iters):
    """Check the timed program's output against the float64 oracle;
    returns (history gap, true residual, its bound)."""
    from tpcg import reference
    b64 = b[:, 0].astype(np.complex128)
    x_ref, h_ref = reference.cg(A64, b64, n_iterations=iters,
                                record_history=True)
    h = np.asarray(hist)[:GATE_ITERS + 1, 0]
    h_ref = h_ref[:GATE_ITERS + 1]
    gap = float((np.abs(h - h_ref) / (np.abs(h_ref) + 1e-30)).max())
    x = np.asarray(x)[:, 0].astype(np.complex128)
    nb = np.linalg.norm(b64)
    res = np.linalg.norm(b64 - A64 @ x) / nb
    res_ref = np.linalg.norm(b64 - A64 @ x_ref) / nb
    floor = (np.sqrt(iters) * EPS32
             * np.linalg.norm(abs(A64) @ abs(x)) / nb)
    bound = max(2 * res_ref, 1e-5, floor)
    if not (np.all(np.isfinite(h)) and gap <= GATE_HISTORY_TOL
            and res <= bound):
        raise SystemExit(
            f"PARITY FAIL: history gap {gap:.3e} (limit "
            f"{GATE_HISTORY_TOL}) over {GATE_ITERS} iterations, true "
            f"residual {res:.3e} (limit {bound:.3e}); refusing to report "
            "GFLOPS")
    return gap, float(res), float(bound)


def main():
    import jax
    from tpcg.backend import use_compile_cache
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")
    use_compile_cache()
    import jax.numpy as jnp
    from tpcg.cg import block_cg
    from tpcg.problems import helm_fe, plane_wave_rhs

    N, k = 128, 12.0
    iters = 5000
    A = helm_fe(N, k, eps=k, dtype=np.complex64)
    nnz = int(np.count_nonzero(np.asarray(A.coef)))
    n = N * N
    b = plane_wave_rhs(N, k).reshape(n, 1).astype(np.complex64)
    op, rhs = jax.device_put(A), jnp.asarray(b)

    def solve(op, rhs):
        res = block_cg(op, rhs, n_iterations=iters)
        return res.x, res.residual_history
    run = jax.jit(solve)

    x, hist = jax.block_until_ready(run(op, rhs))    # compile + warm up
    gap, res, bound = parity_gate(A.to_scipy().astype(np.complex128), b,
                                  x, hist, iters)
    reps = 10
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(op, rhs))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    flops_per_iter = 8 * nnz + 2 * 8 * n + 3 * 8 * n
    gflops = iters * flops_per_iter / dt / 1e9
    baseline = 2.390  # RTX 2080S, report Fig. 5 (helm_fem)
    dev = jax.devices()[0]
    print(card_line())
    print(json.dumps({
        "metric": "cg_gflops_helm_fem_c64_5000it",
        "value": gflops,
        "unit": "GFLOPS",
        "vs_baseline": gflops / baseline,
        "solve_s": dt,
        "parity_history_gap": gap,
        "true_residual": res,
        "true_residual_bound": bound,
        "path": "xla",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
