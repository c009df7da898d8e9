"""Solver numerics: the JAX block CG must reproduce the NumPy oracle's
residual history (behavioural contract #2/#3: unconjugated dots, per-RHS
independent scalars)."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from tpcg import block_cg, cg_solve, reference, to_device_matrix
from tpcg.problems import helm_fe, poisson, rhs_all_boundaries_k2


def spd_matrix(n=64, seed=0):
    rng = np.random.default_rng(seed)
    Q = sp.random(n, n, density=0.08, random_state=seed, format="csr")
    A = Q @ Q.T + sp.eye(n) * n
    return sp.csr_matrix(A)


def test_block_cg_matches_numpy_oracle_real():
    A = spd_matrix(64)
    b = np.random.default_rng(1).standard_normal((64, 3))
    x_ref, hist_ref = reference.cg(A, b, n_iterations=25, record_history=True)
    M = to_device_matrix(A)
    res = block_cg(M, jnp.asarray(b), n_iterations=25)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(res.residual_history), hist_ref,
                               rtol=1e-9, atol=1e-12)


def test_block_cg_matches_numpy_oracle_complex_cocg():
    """Complex-symmetric Helmholtz system: COCG (unconjugated) semantics."""
    S = helm_fe(N=12, k=6.0, eps=6.0)
    A = S.to_scipy()
    b = rhs_all_boundaries_k2(12, 6.0).reshape(-1)
    x_ref, hist_ref = reference.cg(A, b, n_iterations=40, record_history=True)
    res = block_cg(S, jnp.asarray(b), n_iterations=40)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(res.residual_history), hist_ref,
                               rtol=1e-8, atol=1e-6 * hist_ref[0])


def test_block_cg_per_rhs_independence():
    """A block solve must equal per-column solves exactly (independent
    alpha/beta per RHS -- clcg.c:317-333)."""
    A = spd_matrix(48, seed=2)
    M = to_device_matrix(A)
    B = np.random.default_rng(3).standard_normal((48, 4))
    block = block_cg(M, jnp.asarray(B), n_iterations=15)
    for r in range(4):
        single = block_cg(M, jnp.asarray(B[:, r:r + 1]), n_iterations=15)
        np.testing.assert_allclose(np.asarray(block.x)[:, r],
                                   np.asarray(single.x)[:, 0], rtol=1e-10)


def test_block_cg_converges_poisson():
    """BASELINE config 1: 2-D Poisson, real CG to 1e-8."""
    S = poisson(32)
    n = 32 * 32
    b = np.ones(n)
    res = block_cg(S, jnp.asarray(b), n_iterations=2 * n)
    r = b - S.to_scipy() @ np.asarray(res.x)
    assert np.linalg.norm(r) < 1e-8 * np.linalg.norm(b)


def test_block_cg_initial_guess():
    A = spd_matrix(32, seed=5)
    M = to_device_matrix(A)
    b = np.random.default_rng(6).standard_normal(32)
    x0 = np.random.default_rng(7).standard_normal(32)
    x_ref = reference.cg(A, b, x=x0, n_iterations=20)
    res = block_cg(M, jnp.asarray(b), jnp.asarray(x0), n_iterations=20)
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=1e-9)


def test_cg_solve_early_exit():
    A = spd_matrix(64, seed=8)
    M = to_device_matrix(A)
    b = np.random.default_rng(9).standard_normal(64)
    x, its = cg_solve(M, jnp.asarray(b), tol=1e-10, maxit=500)
    assert int(its) < 500
    assert np.linalg.norm(A @ np.asarray(x) - b) < 1e-9


def test_cg_solve_matches_pcg_oracle_iterations():
    A = spd_matrix(64, seed=10)
    M = to_device_matrix(A)
    b = np.random.default_rng(11).standard_normal(64)
    x_ref, it_ref = reference.pcg(A, b, tol=1e-8, maxit=300)
    x, its = cg_solve(M, jnp.asarray(b), tol=1e-8, maxit=300)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-6, atol=1e-9)
    assert abs(int(its) - (it_ref + 1)) <= 1   # same count modulo convention


def test_cg_solve_jacobi_preconditioner():
    A = spd_matrix(64, seed=12)
    M = to_device_matrix(A)
    dinv = 1.0 / A.diagonal()
    b = np.random.default_rng(13).standard_normal(64)
    x, its_prec = cg_solve(M, jnp.asarray(b),
                           M=lambda r: jnp.asarray(dinv) * r,
                           tol=1e-8, maxit=400)
    assert np.linalg.norm(A @ np.asarray(x) - b) < 1e-6


def test_float32_path_close_to_oracle():
    """f32 should track the f64 oracle to single precision."""
    A = spd_matrix(48, seed=14)
    M = to_device_matrix(A.astype(np.float32))
    b = np.random.default_rng(15).standard_normal(48).astype(np.float32)
    x_ref = reference.cg(A, b.astype(np.float64), n_iterations=10)
    res = block_cg(M, jnp.asarray(b), n_iterations=10)
    assert np.asarray(res.x).dtype == np.float32
    np.testing.assert_allclose(np.asarray(res.x), x_ref, rtol=2e-3, atol=1e-4)


def test_cg_solve_zero_rhs_column_does_not_poison():
    """Breakdown guard: a zero RHS column must freeze at zero, not NaN
    every column (regression)."""
    A = spd_matrix(32, seed=20)
    M = to_device_matrix(A)
    b = np.zeros((32, 2))
    b[:, 1] = np.random.default_rng(21).standard_normal(32)
    x, its = cg_solve(M, jnp.asarray(b), tol=1e-10, maxit=200)
    x = np.asarray(x)
    assert np.all(np.isfinite(x))
    assert np.allclose(x[:, 0], 0.0)
    assert np.linalg.norm(A @ x[:, 1] - b[:, 1]) < 1e-8
