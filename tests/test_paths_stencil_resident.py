"""Large-grid stencil problems through ``plan_stencil_cg`` against the
float64 oracle.

Each case is one problem that a removed resident or panel-round-trip
kernel (the v4 and v5 tiers) used to serve, named after the test
that pinned it: constant, variable (symmetric half-plane) and real
coefficients, single iterations, odd and prime grid heights, widths that
are not lane multiples (the old column padding), batches and x0.  Sizes
are cut to CPU scale; the shapes of the cases are the ones those tests
used.  Fields: (kind, N, RHS batch, x0, iterations, representation).
"""
import pytest

from solver_oracle import run_stencil_case

CASES = {
    # resident v4, constant and coefficient planes
    "v4-const-keep-q": ("const", 64, 1, False, 20, "planes"),
    "v4-const-recompute-q": ("const", 64, 1, False, 20, "c64"),
    "v4-const-keep-q-chunked": ("const", 64, 1, True, 20, "planes"),
    "v4-const-recompute-q-chunked": ("const", 64, 2, False, 20, "c64"),
    "v4-coef": ("var", 64, 1, False, 20, "planes"),
    "v4-coef-chunked": ("var", 64, 1, False, 7, "c64"),
    "v4-single-iteration": ("const", 64, 1, False, 1, "planes"),
    "v4-two-iterations": ("const", 64, 1, False, 2, "c64"),
    "v4-odd-height": ("const", 67, 1, False, 20, "planes"),
    "v4-q-hbm": ("const", 96, 1, False, 20, "c64"),
    "v4-q-hbm-oracle": ("const", 96, 1, True, 20, "planes"),
    "v4-budget-guards": ("const", 128, 1, False, 12, "c128"),
    # resident real v4
    "v4-real-keep-q": ("poisson", 64, 1, False, 20, "f32"),
    "v4-real-recompute-q": ("poisson", 64, 1, True, 20, "f32"),
    "v4-real-chunked": ("poisson", 64, 2, False, 6, "f64"),
    "v4-real-coef": ("realvar", 64, 1, False, 20, "f32"),
    "v4-real-coef-chunked": ("realvar", 64, 1, False, 7, "f64"),
    "v4-real-q-hbm-oracle": ("poisson", 96, 1, False, 20, "f32"),
    "v4-real-oracle": ("poisson", 128, 1, False, 30, "f64"),
    # resident v4, symmetric half-plane coefficients
    "v4-sym-reconstruction": ("var", 32, 1, False, 20, "c128"),
    "v4-sym-rejects-nonsymmetric": ("island", 32, 1, False, 20, "c128"),
    "v4-sym-keep-q": ("var", 64, 1, False, 20, "planes"),
    "v4-sym-recompute-q": ("var", 64, 1, False, 20, "c64"),
    "v4-sym-tiers-chunks": ("var", 64, 2, False, 12, "planes"),
    "v4-sym-q-hbm-oracle": ("var", 96, 1, True, 20, "c64"),
    "v4-sym-const-problem": ("const", 64, 1, False, 20, "c128"),
    # panel round-trip v5, constant taps
    "v5-d-resident": ("const", 64, 1, False, 20, "planes"),
    "v5-d-streamed": ("const", 64, 1, False, 20, "c64"),
    "v5-d-resident-chunked": ("const", 64, 1, True, 20, "planes"),
    "v5-d-streamed-chunked": ("const", 64, 1, False, 20, "c128"),
    "v5-qx-d-resident": ("const", 80, 1, False, 20, "c64"),
    "v5-qx-d-streamed-16": ("const", 80, 16, False, 12, "planes"),
    "v5-qx-chunked": ("const", 80, 1, True, 20, "c128"),
    "v5-single-iteration-resident": ("const", 64, 1, False, 1, "c64"),
    "v5-two-iterations-resident": ("const", 64, 1, False, 2, "planes"),
    "v5-single-iteration-streamed": ("const", 64, 1, True, 1, "planes"),
    "v5-two-iterations-streamed": ("const", 64, 1, True, 2, "c64"),
    "v5-odd-height-resident": ("const", 67, 1, False, 20, "c64"),
    "v5-odd-height-streamed": ("const", 71, 1, False, 20, "planes"),
    "v5-oracle": ("const", 128, 1, False, 30, "c128"),
    "v5-apply-const": ("const", 32, 1, False, 1, "c128"),
    "v5-apply-const-column-padded": ("const", 45, 1, False, 20, "c64"),
    "v5-cpos-resident": ("const", 45, 1, False, 20, "planes"),
    "v5-cpos-resident-qx": ("const", 45, 1, True, 20, "c64"),
    "v5-cpos-streamed": ("const", 53, 1, False, 20, "planes"),
    "v5-cpos-streamed-qx": ("const", 53, 2, False, 20, "c128"),
    "v5-planner-column-pad": ("const", 45, 2, False, 20, "planes"),
    "v5-alignment-guard": ("const", 41, 1, False, 20, "c64"),
    # panel round-trip v5, real
    "v5-real-d-resident": ("poisson", 64, 1, False, 20, "f32"),
    "v5-real-d-streamed": ("poisson", 64, 1, True, 20, "f32"),
    "v5-real-d-resident-chunked": ("poisson", 80, 1, False, 20, "f64"),
    "v5-real-d-streamed-chunked": ("poisson", 80, 2, False, 20, "f32"),
    "v5-real-single-iteration": ("poisson", 64, 1, False, 1, "f32"),
    "v5-real-single-iteration-x0": ("poisson", 64, 1, True, 1, "f64"),
    "v5-real-qx": ("poisson", 80, 1, False, 12, "f32"),
    "v5-real-qx-chunked": ("poisson", 80, 2, True, 12, "f32"),
    "v5-real-apply-cpos": ("poisson", 45, 1, False, 20, "f64"),
    "v5-real-cpos": ("poisson", 45, 1, False, 20, "f32"),
    "v5-real-cpos-qx": ("poisson", 53, 1, True, 20, "f32"),
    "v5-real-planner-column-pad": ("poisson", 45, 2, False, 20, "f32"),
    "v5-real-odd-height": ("poisson", 67, 1, False, 20, "f32"),
    # panel round-trip v5, symmetric coefficients
    "v5-sym-d-resident": ("var", 64, 1, False, 20, "planes"),
    "v5-sym-d-streamed": ("var", 64, 1, False, 20, "c64"),
    "v5-sym-d-resident-chunked": ("var", 64, 1, True, 20, "planes"),
    "v5-sym-d-streamed-chunked": ("var", 64, 2, False, 20, "c128"),
    "v5-sym-qx-resident": ("var", 80, 1, False, 20, "c64"),
    "v5-sym-qx-streamed": ("var", 80, 1, True, 12, "planes"),
    "v5-sym-qx-chunked": ("var", 80, 2, False, 12, "c64"),
    "v5-sym-single-iteration": ("var", 64, 1, False, 1, "planes"),
    "v5-sym-two-iterations": ("var", 64, 1, False, 2, "c64"),
    "v5-sym-single-iteration-island": ("island", 64, 1, True, 1, "c64"),
    "v5-sym-two-iterations-island": ("island", 64, 1, True, 2, "planes"),
    "v5-sym-oracle": ("var", 128, 1, False, 30, "c128"),
    "v5-sym-alignment-guard": ("var", 45, 1, False, 20, "c64"),
    "v5-sym-planner-route": ("island", 96, 1, False, 20, "planes"),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_large_grid_problem_matches_oracle(case):
    run_stencil_case(*case)
