"""Banded and unstructured matrices through ``tpcg.cg`` / ``cg_matrix``
against the float64 oracle.

Each case is one problem that a removed hand-written path used to serve,
named after the test that pinned it: the fused and streaming banded (DIA)
kernels, and the Benes routing network with its native builder and
``route`` CLI.  Banded matrices now run the ``DiaMatrix`` shift-multiply,
unstructured ones the ``EllMatrix`` gather (``tests/solver_oracle.py``
holds the checks).  "planes" runs a complex system as float32 planes
(``planes=True``); "gpu" fakes a GPU backend, under which the defaults
must stay the same.
"""
import jax
import pytest
import scipy.sparse as sp

from tpcg.sparse import DiaMatrix, EllMatrix, to_device_matrix
from solver_oracle import banded, run_sparse_case, unstructured


def _offsets(hb, step):
    return tuple(j * step for j in range(hb))


# (n, half-band diagonals, diagonal step, representation, RHS, x0,
#  iterations, options)
BANDED = {
    # whole-solve resident banded complex kernel
    "fused-dia-1280": (1280, 9, 1, "c64", 1, False, 30, {}),
    "fused-dia-777": (777, 4, 13, "c64", 1, False, 30, {}),
    "fused-dia-300": (300, 3, 75, "c128", 1, False, 30, {}),
    "fused-dia-vs-streaming": (1280, 9, 1, "planes", 1, False, 30, {}),
    "fused-dia-block-columns": (1280, 5, 1, "c64", 3, False, 20, {}),
    "fused-dia-fit-rule": (2000, 9, 1, "c64", 1, False, 20, {}),
    "fused-dia-denormal-freeze": (300, 3, 1, "c64", 1, False, 400, {}),
    "fused-dia-converged-freeze": (300, 2, 1, "planes", 1, False, 400, {}),
    # streaming real banded kernel
    "dia-grid-roundtrip": (4000, 9, 7, "f32", 1, False, 20, {}),
    "dia-taps-hb9": (4000, 9, 7, "f64", 1, False, 20, {}),
    "dia-taps-hb3": (4000, 3, 1500, "f32", 1, False, 20, {}),
    "dia-stream-hb9": (4000, 9, 7, "f32", 2, False, 20, {}),
    "dia-stream-3037": (3037, 4, 1, "f32", 1, False, 20, {}),
    "dia-stream-step25": (4000, 3, 25, "f64", 1, False, 20, {}),
    "dia-stream-x0": (2500, 5, 3, "f32", 1, True, 20, {}),
    "dia-block-step1": (4000, 5, 1, "f32", 4, False, 20, {}),
    "dia-block-step30": (4000, 5, 30, "f32", 4, True, 20, {}),
    "dia-ragged-zero-column": (4000, 5, 1, "f32", 3, False, 20,
                               {"zero_col": True}),
    "dia-api-dispatch-shuffled": (4000, 4, 1, "f32", 1, False, 30,
                                  {"shuffle": True, "entry": "cg"}),
    "dia-fit-rule": (5000, 2, 1, "f64", 1, False, 20, {}),
    "dia-x0-freeze": (3000, 3, 1, "f32", 1, True, 200, {}),
    # streaming complex banded kernel
    "dia-cplx-apply-hb6": (2000, 6, 1, "c64", 1, False, 20, {}),
    "dia-cplx-apply-step9": (2000, 3, 9, "c128", 1, False, 20, {}),
    "dia-cplx-1280-planes": (1280, 8, 1, "planes", 1, False, 30, {}),
    "dia-cplx-1280-x0": (1280, 8, 1, "c64", 1, True, 30, {}),
    "dia-cplx-1999": (1999, 4, 1, "planes", 1, False, 30, {}),
    "dia-cplx-x0": (1280, 4, 1, "c64", 1, True, 20, {}),
    "dia-cplx-zero-freeze": (1280, 4, 1, "planes", 2, False, 20,
                             {"zero_col": True}),
    "dia-cplx-block": (1280, 8, 1, "c64", 4, False, 20, {}),
    "dia-cplx-api-dispatch-shuffled": (1280, 4, 1, "c64", 1, False, 20,
                                       {"shuffle": True, "entry": "cg"}),
    "dia-cplx-fit-rule": (3000, 4, 2, "c128", 1, False, 20, {}),
}

# (n, entries per row, representation, RHS, iterations, options)
UNSTRUCTURED = {
    # Benes routing network
    "route-benes-permutations": (64, 2, "f32", 1, 30, {}),
    "route-layer-decomposition": (120, 3, "f64", 1, 30, {}),
    "route-matvec": (200, 4, "f32", 1, 30, {}),
    "route-multi-rhs": (200, 4, "f32", 4, 30, {}),
    "route-block-cg-oracle": (150, 3, "f64", 2, 30, {}),
    "route-fallback": (96, 4, "f32", 1, 40, {"entry": "cg"}),
    "route-pair-complex": (96, 4, "c64", 1, 30, {}),
    "route-small-matrix": (30, 3, "f32", 1, 20, {}),
    "route-pack-save": (120, 3, "c128", 1, 30, {}),
    # native routing builder (routing_native)
    "native-50": (50, 3, "f32", 1, 30, {}),
    "native-300": (300, 5, "f32", 1, 30, {}),
    "native-777-complex": (777, 4, "c64", 1, 30, {}),
    "native-1024": (1024, 8, "f32", 1, 30, {}),
    "native-permutations": (256, 2, "f64", 1, 30, {}),
    "native-vs-python": (500, 6, "planes", 1, 30, {}),
    # the clcg API on an accelerator (test_api routing cases)
    "api-unstructured-on-gpu": (96, 4, "c64", 1, 30, {"gpu": True}),
    "api-precomputed-tables-on-gpu": (96, 4, "f32", 1, 40,
                                      {"gpu": True, "entry": "cg"}),
    "api-real-matrix-complex-rhs": (80, 4, "f32", 1, 40,
                                    {"gpu": True, "complex_rhs": True}),
    # the route CLI: a Matrix Market file read back and solved
    "cli-matrix-market": (120, 3, "f32", 2, 30, {"mtx": True}),
}


def _setup(monkeypatch, rep, opts):
    opts = dict(opts)
    if opts.pop("gpu", False):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    return opts


@pytest.mark.parametrize("case", BANDED.values(), ids=BANDED.keys())
def test_banded_problem_matches_oracle(case, monkeypatch):
    n, hb, step, rep, nrhs, x0, iters, opts = case
    opts = _setup(monkeypatch, rep, opts)
    A = banded(n, _offsets(hb, step), rep in ("c64", "c128", "planes"))
    M, _ = to_device_matrix(A, reorder=True)
    assert isinstance(M, DiaMatrix)
    run_sparse_case(A, rep, nrhs, x0, iters, **opts)


@pytest.mark.parametrize("case", UNSTRUCTURED.values(),
                         ids=UNSTRUCTURED.keys())
def test_unstructured_problem_matches_oracle(case, monkeypatch, tmp_path):
    n, per_row, rep, nrhs, iters, opts = case
    opts = _setup(monkeypatch, rep, opts)
    A = unstructured(n, per_row, rep in ("c64", "c128", "planes"))
    if opts.pop("mtx", False):
        import scipy.io
        from tpcg.io import load_matrix_market
        path = tmp_path / "a.mtx"
        scipy.io.mmwrite(str(path), A)
        A = sp.csr_matrix(load_matrix_market(str(path)))
    M, perm = to_device_matrix(A, reorder=True)
    assert isinstance(M, EllMatrix) and perm is None
    run_sparse_case(A, rep, nrhs, False, iters, **opts)
