"""Stencil problems through ``plan_stencil_cg`` against the float64 oracle.

Each case is one problem that a removed hand-written kernel tier (whole-solve
fused kernels, streaming v2/v3 kernels, the real streaming kernel) or the
old tier planner used to serve, named after the test that pinned it.  The
XLA path that serves it now -- native complex / real, or float planes --
must reproduce the oracle's residual history (``tests/solver_oracle.py``).

Fields: (kind, N, RHS batch, x0, iterations, representation).
"""
import pytest

from solver_oracle import run_stencil_case

CASES = {
    # whole-solve resident kernels (coefficient planes / constant taps)
    "fused-planes-complex": ("const", 32, 4, False, 20, "planes"),
    "fused-real-oracle": ("poisson", 32, 2, False, 20, "f64"),
    "fused-x0-single-rhs": ("const", 32, 1, True, 15, "planes"),
    "fused-const-vs-general": ("const", 48, 1, False, 20, "c64"),
    "fused-const-poisson": ("poisson", 48, 1, False, 30, "f32"),
    "fused-split-rejects-variable": ("var", 32, 1, False, 20, "c128"),
    "fused-split-exact": ("const", 40, 1, False, 20, "c128"),
    "fused-mxu-vs-general": ("const", 64, 2, False, 12, "planes"),
    "fused-chunked-33": ("const", 32, 33, False, 10, "planes"),
    "fused-mxu-rejects-row-variable": ("island", 32, 1, False, 20, "planes"),
    "fused-packed-32": ("const", 32, 32, False, 10, "c64"),
    # streaming v2/v3 kernels
    "stream-N64": ("const", 64, 1, False, 30, "planes"),
    "stream-N128": ("const", 128, 1, False, 20, "planes"),
    "stream-x0-blockrows": ("const", 64, 1, True, 20, "c64"),
    "stream-coef": ("var", 64, 1, False, 20, "planes"),
    "stream-odd-height": ("const", 72, 1, False, 20, "c64"),
    "stream-coef-batched": ("var", 48, 3, False, 12, "planes"),
    "stream-coef-batched-fat-16": ("var", 48, 16, True, 12, "c64"),
    "stream-const-batched-17": ("const", 48, 17, False, 12, "planes"),
    "stream-v3-const-keep-r": ("const", 64, 1, False, 20, "c128"),
    "stream-v3-const-no-keep-r": ("const", 64, 2, False, 20, "c64"),
    "stream-v3-coef-keep-r": ("var", 64, 1, False, 20, "c128"),
    "stream-v3-coef-no-keep-r": ("var", 64, 2, True, 20, "planes"),
    "stream-rejects-nonconst-edges": ("island", 48, 1, False, 20, "c64"),
    "stream-pick-block-rows-prime": ("const", 37, 1, False, 20, "planes"),
    # real streaming kernel
    "real-stream-const": ("poisson", 64, 1, False, 30, "f32"),
    "real-stream-coef": ("realvar", 64, 1, False, 30, "f32"),
    "real-stream-x0-blockrows": ("poisson", 64, 1, True, 30, "f64"),
    "real-stream-var-fallback": ("realvar", 48, 2, False, 20, "f64"),
    "real-stream-rejects-complex": ("const", 32, 1, False, 20, "c128"),
    # the tier planner (ops/auto.py)
    "planner-v3-config": ("const", 64, 2, False, 12, "c64"),
    "planner-v4-config": ("var", 64, 1, False, 12, "c64"),
    "planner-v5-config": ("const", 96, 1, False, 12, "c64"),
    "planner-v5-real-config": ("poisson", 96, 1, False, 12, "f32"),
    "planner-v4-sym-config": ("var", 96, 1, False, 12, "planes"),
    "planner-v4-real-config": ("poisson", 96, 2, False, 12, "f32"),
    "planner-solve-planes-surface": ("const", 64, 1, False, 12, "planes"),
    "planner-stream-real-route": ("poisson", 48, 1, False, 20, "f32"),
    "planner-stream-coef": ("var", 32, 1, False, 20, "planes"),
    "planner-vmem-const": ("const", 32, 1, False, 20, "c64"),
    "planner-vmem-coef": ("const", 32, 1, False, 20, "planes"),
    "planner-stream": ("const", 32, 1, False, 20, "c128"),
    "planner-stream-multi-rhs": ("const", 32, 2, False, 12, "planes"),
    "planner-batched-x0": ("const", 32, 2, True, 15, "c64"),
    "planner-prime-grid-pad": ("const", 67, 2, True, 20, "planes"),
    "planner-forced-xla": ("const", 67, 1, False, 5, "c128"),
    "planner-pad-real-planes": ("poisson", 67, 1, False, 15, "f32"),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_stencil_problem_matches_oracle(case):
    run_stencil_case(*case)
