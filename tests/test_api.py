"""clcg-compatible API surface: column-major packing, CSR-arrays entry."""
import numpy as np
import scipy.sparse as sp

from tpcg import cg, cg_matrix, reference
from tpcg.problems import helm_fe


def spd(n=40, seed=0):
    Q = sp.random(n, n, density=0.1, random_state=seed, format="csr")
    return sp.csr_matrix(Q @ Q.T + sp.eye(n) * n)


def test_cg_csr_single_rhs():
    A = spd()
    b = np.random.default_rng(1).standard_normal(40)
    x = cg(40, A.nnz, A.data, b, A.indptr, A.indices, n_rhs=1,
           n_iterations=30)
    x_ref = reference.cg(A, b, n_iterations=30)
    np.testing.assert_allclose(x, x_ref, rtol=1e-9)


def test_cg_column_major_multi_rhs():
    """B packed v[i + r*size] like main.c:44-53; per-RHS b = (r+1)*5."""
    A = spd(36, seed=2)
    n, nrhs = 36, 3
    b = np.zeros(n * nrhs)
    for r in range(nrhs):
        b[r * n:(r + 1) * n] = (r + 1) * 5.0
    x = cg(n, A.nnz, A.data, b, A.indptr, A.indices, n_rhs=nrhs,
           n_iterations=25)
    for r in range(nrhs):
        x_ref = reference.cg(A, b[r * n:(r + 1) * n], n_iterations=25)
        np.testing.assert_allclose(x[r * n:(r + 1) * n], x_ref, rtol=1e-9)


def test_cg_complex():
    S = helm_fe(N=8, k=4.0, eps=4.0)
    A = S.to_scipy()
    n = 64
    b = (np.random.default_rng(3).standard_normal(n)
         + 1j * np.random.default_rng(4).standard_normal(n))
    x, hist = cg(n, A.nnz, A.data, b, A.indptr, A.indices, n_rhs=1,
                 n_iterations=20, record_history=True)
    x_ref, hist_ref = reference.cg(A, b, n_iterations=20, record_history=True)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8)
    np.testing.assert_allclose(hist[:, 0], hist_ref, rtol=1e-8)


def test_cg_float32_default_for_single_precision_inputs():
    A = spd(32, seed=5).astype(np.float32)
    b = np.ones(32, dtype=np.float32)
    x = cg(32, A.nnz, A.data, b, A.indptr, A.indices, n_rhs=1,
           n_iterations=10)
    assert x.dtype == np.float32


def test_cg_matrix_wrapper():
    A = spd(30, seed=6)
    b = np.random.default_rng(7).standard_normal(30)
    x = cg_matrix(A, b, n_iterations=20)
    x_ref = reference.cg(A, b, n_iterations=20)
    np.testing.assert_allclose(x, x_ref, rtol=1e-9)


def test_cg_matrix_rcm_reorder_matches_unshuffled():
    """A row/col-shuffled banded matrix must take the same RCM->DIA path
    through ``cg_matrix`` as through ``cg`` (regression: cg_matrix used to
    skip ``reorder=True`` and fall off onto the slow ELL path; results are
    permutation-invariant either way, so pin both correctness and layout)."""
    from tpcg.sparse import DiaMatrix, to_device_matrix

    A = sp.csr_matrix(sp.diags([-np.ones(99), 4 * np.ones(100),
                                -np.ones(99)], [-1, 0, 1]))
    rng = np.random.default_rng(8)
    p = rng.permutation(100)
    Ashuf = sp.csr_matrix(A[p][:, p])
    M, perm = to_device_matrix(Ashuf, reorder=True)
    assert isinstance(M, DiaMatrix) and perm is not None
    b = rng.standard_normal(100)
    x = cg_matrix(Ashuf, b, n_iterations=60)
    x_ref = reference.cg(Ashuf, b, n_iterations=60)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)
