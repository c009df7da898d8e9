"""BASELINE.md target: residual histories matching the reference to
1e-10 relative on Matrix Market inputs.

The reference's numbers are produced by the C pipeline ``main.c:13-61``
(BeBOP Matrix Market load, symmetric expansion, CSR convert) feeding
``clcg::cg``; its behavioural oracle is the NumPy CG the reference itself
ships (``helmFE_var.py:507-544``, unconjugated dots).  Here the same
pipeline -- ``.mtx`` file -> ``tpcg.io.load_matrix_market`` ->
``tpcg.api.cg`` with ``record_history`` -- is pinned against
``tpcg.reference.cg`` at rtol <= 1e-10 over 100+ iterations, in float64
(x64 is enabled by conftest; the 1e-10 target is only meaningful in
double precision -- the f32 parity gates live in ``bench.py``,
``chip_smoke.py`` and ``tests/solver_oracle.py``).
"""
import numpy as np
import scipy.io
import scipy.sparse as sp

from tpcg import cg, reference
from tpcg.io import load_matrix_market
from tpcg.problems import helm_fe, poisson

RTOL = 1e-10
ITERS = 120


def _roundtrip(tmp_path, A_sci, name):
    path = tmp_path / name
    scipy.io.mmwrite(str(path), A_sci)
    return str(path) + ".mtx"


def test_mm_real_history_parity_1e10(tmp_path):
    """Real SPD (2-D Poisson FD, the reference's debug problem class):
    full fixed-iteration history vs the NumPy oracle at 1e-10."""
    S = poisson(40)
    A = sp.csr_matrix(S.to_scipy().astype(np.float64))
    path = _roundtrip(tmp_path, A, "poisson40")
    M = load_matrix_market(path, dtype=np.float64)
    assert (M != A).nnz == 0

    n = M.shape[0]
    b = np.cos(np.arange(n) * 0.37) + 1.5
    x, hist = cg(n, M.nnz, M.data, b, M.indptr, M.indices, n_rhs=1,
                 n_iterations=ITERS, record_history=True)
    x_ref, h_ref = reference.cg(A, b, n_iterations=ITERS,
                                record_history=True)
    h = hist[:, 0]
    assert h.shape[0] == ITERS + 1
    rel = np.abs(h - h_ref) / (np.abs(h_ref) + 1e-300)
    assert rel.max() <= RTOL, rel.max()
    np.testing.assert_allclose(x, x_ref, rtol=1e-9)


def test_mm_complex_history_parity_1e10(tmp_path):
    """Complex-symmetric Helmholtz FE (the helm_fem headline class):
    COCG history through the Matrix Market path vs the oracle at 1e-10."""
    S = helm_fe(N=48, k=12.0, eps=12.0)
    A = sp.csr_matrix(S.to_scipy().astype(np.complex128))
    path = _roundtrip(tmp_path, A, "helm48")
    M = load_matrix_market(path, dtype=np.complex128)
    assert abs(M - A).max() < 1e-15

    n = M.shape[0]
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x, hist = cg(n, M.nnz, M.data, b, M.indptr, M.indices, n_rhs=1,
                 n_iterations=ITERS, record_history=True)
    x_ref, h_ref = reference.cg(A, b, n_iterations=ITERS,
                                record_history=True)
    h = hist[:, 0]
    rel = np.abs(h - h_ref) / (np.abs(h_ref) + 1e-300)
    assert rel.max() <= RTOL, rel.max()
    np.testing.assert_allclose(x, x_ref, rtol=1e-8)


def test_mm_symmetric_storage_expansion_parity(tmp_path):
    """Lower-triangle symmetric .mtx storage (BeBOP's
    ``sparse_matrix_expand_symmetric_storage``, ``main.c:25``): the
    expanded operator's history must equal the dense-stored one exactly."""
    S = poisson(32)
    A = sp.csr_matrix(S.to_scipy().astype(np.float64))
    path = tmp_path / "poisson_sym"
    scipy.io.mmwrite(str(path), sp.tril(A), symmetry="symmetric")
    M = load_matrix_market(str(path) + ".mtx", dtype=np.float64)
    assert (M != A).nnz == 0

    n = M.shape[0]
    b = np.sin(np.arange(n) * 0.11) + 2.0
    _, hist = cg(n, M.nnz, M.data, b, M.indptr, M.indices, n_rhs=1,
                 n_iterations=100, record_history=True)
    _, h_ref = reference.cg(A, b, n_iterations=100, record_history=True)
    rel = np.abs(hist[:, 0] - h_ref) / (np.abs(h_ref) + 1e-300)
    assert rel.max() <= RTOL, rel.max()
