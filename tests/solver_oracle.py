"""Shared checks of a device solve against the float64 NumPy oracle
(``tpcg.reference.cg``), used by the parametrised ``test_paths_*`` files.

Tolerances:
  * float64 / complex128 solves: histories and solutions to 1e-8
    relative (the same recurrence in the same precision);
  * float32 / complex64 (native or planes): histories to 5e-3 relative
    over the first 20 iterations while the oracle's residual is at least
    1e-4 of its start (float32 arithmetic summed in another order), and
    the solution after those iterations to 5e-2 relative.
"""
import numpy as np

from tpcg import reference

F32_WINDOW = 20
F32_HIST_TOL = 5e-3
F32_X_TOL = 5e-2
F64_TOL = 1e-8


def oracle(A_sci, B, X0, iters):
    """float64 oracle on (n, nrhs) columns: (X, history (iters+1, nrhs))."""
    B = np.asarray(B)
    wide = np.complex128 if (np.iscomplexobj(B)
                             or np.iscomplexobj(A_sci.data)) else np.float64
    A64 = A_sci.astype(wide)
    x, h = reference.cg(A64, B.astype(wide),
                        None if X0 is None else np.asarray(X0).astype(wide),
                        n_iterations=iters, record_history=True)
    return x.reshape(B.shape), np.asarray(h).reshape(iters + 1, -1)


def check(X, hist, X_ref, h_ref, single):
    """Compare a solve (X (n, nrhs), history) with the oracle.  ``single``
    selects the float32 tolerances."""
    X = np.asarray(X).reshape(X_ref.shape)
    hist = np.asarray(hist).reshape(h_ref.shape)
    assert np.all(np.isfinite(hist)) and np.all(np.isfinite(X))
    if not single:
        np.testing.assert_allclose(hist, h_ref, rtol=F64_TOL,
                                   atol=F64_TOL * h_ref[0].max())
        np.testing.assert_allclose(X, X_ref, rtol=F64_TOL,
                                   atol=F64_TOL * np.abs(X_ref).max())
        return
    k = min(F32_WINDOW, len(h_ref) - 1) + 1
    hr, hd = h_ref[:k], hist[:k]
    mask = (hr >= 1e-4 * hr[0]) & (hr > 0)
    rel = np.abs(hd - hr)[mask] / hr[mask]
    assert rel.max(initial=0.0) < F32_HIST_TOL, rel.max()
    if len(h_ref) - 1 <= F32_WINDOW:
        err = np.linalg.norm(X - X_ref) / max(np.linalg.norm(X_ref), 1e-30)
        assert err < F32_X_TOL, err


# ---- stencil problems ------------------------------------------------------
SINGLE = ("c64", "f32", "planes")
DTYPES = {"c128": np.complex128, "c64": np.complex64, "planes": np.complex64,
          "f64": np.float64, "f32": np.float32}


def wavenumber(N):
    """About 20 grid points per wavelength on an N x N unit-square grid,
    the resolution Helmholtz users run."""
    return 2 * np.pi * (N - 1) / 20


def stencil_problem(kind, N, rep):
    """A Stencil2D of ``kind`` on an N x N grid in the precision of
    ``rep``: Helmholtz FE with constant, random or island wave speed, the
    Poisson stencil, or a diagonally dominant real stencil with a
    variable diagonal."""
    from tpcg.parallel import island_wave_speed
    from tpcg.problems import helm_fe, helm_fe_var
    from tpcg.problems.poisson import poisson
    from tpcg.sparse import Stencil2D
    k = wavenumber(N)
    rng = np.random.default_rng(N)
    if kind == "const":
        S = helm_fe(N, k, eps=k)
    elif kind == "var":
        S = helm_fe_var(N, k, 1.0 + 0.5 * rng.random((N - 1, N - 1)),
                        rho=0.1)
    elif kind == "island":
        S = helm_fe_var(N, k, island_wave_speed(N, 3, 2.0, 1.0), rho=0.1)
    elif kind == "poisson":
        S = poisson(N)
    elif kind == "realvar":
        P = poisson(N)
        coef = np.asarray(P.coef).copy()
        coef[0] = coef[0] * (1.0 + rng.random((N, N)))
        S = Stencil2D(P.offsets, coef, P.grid)
    else:
        raise ValueError(kind)
    return Stencil2D(S.offsets, np.asarray(S.coef).astype(DTYPES[rep]),
                     S.grid)


def run_stencil_case(kind, N, nb, x0, iters, rep):
    """Solve through ``plan_stencil_cg`` and check against the oracle."""
    from tpcg import plan_stencil_cg
    from tpcg.problems import plane_wave_rhs
    S = stencil_problem(kind, N, rep)
    n = N * N
    rng = np.random.default_rng(7 * N + nb)
    cplx = np.iscomplexobj(S.coef)
    if cplx:
        b = plane_wave_rhs(N, wavenumber(N))
        B = np.stack([b * (1.0 + 0.3j * i) for i in range(nb)])
    else:
        B = rng.standard_normal((nb, N, N))
    B = B.astype(DTYPES[rep])
    X0 = None
    if x0:
        X0 = 0.1 * rng.standard_normal(B.shape)
        if cplx:
            X0 = X0 + 0.1j * rng.standard_normal(B.shape)
        X0 = X0.astype(DTYPES[rep])
    plan = plan_stencil_cg(S, iters,
                           path="xla-planes" if rep == "planes" else "xla")
    x, h = plan.solve(B[0] if nb == 1 else B,
                      None if X0 is None else (X0[0] if nb == 1 else X0))
    assert x.shape == ((N, N) if nb == 1 else (nb, N, N))
    assert h.shape == ((iters + 1,) if nb == 1 else (iters + 1, nb))
    X_ref, h_ref = oracle(S.to_scipy(), B.reshape(nb, n).T,
                          None if X0 is None else X0.reshape(nb, n).T,
                          iters)
    check(np.asarray(x).reshape(nb, n).T, h, X_ref, h_ref, rep in SINGLE)


# ---- sparse (DIA / ELL) problems -------------------------------------------
def banded(n, offsets, cplx, seed=0):
    """Symmetric (complex-symmetric) diagonally dominant band matrix."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        v = 0.1 * rng.standard_normal(len(i))
        if cplx:
            v = v + 0.1j * rng.standard_normal(len(i))
        rows.append(i)
        cols.append(i + off)
        vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    diag = 2.0 * len(offsets) + (0.5j if cplx else 0.0)
    return sp.csr_matrix((A + A.T) * 0.5 + sp.eye(n) * diag)


def unstructured(n, per_row, cplx, seed=0):
    """Random symmetric (complex-symmetric) sparse matrix, diagonally
    dominant, with ~2 * per_row nonzeros per row: no band survives RCM."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, n * per_row)
    v = 0.1 * rng.standard_normal(n * per_row)
    if cplx:
        v = v + 0.1j * rng.standard_normal(n * per_row)
    A = sp.csr_matrix((v, (rows, cols)), shape=(n, n))
    diag = per_row + (0.5j if cplx else 0.0)
    return sp.csr_matrix((A + A.T) * 0.5 + sp.eye(n) * diag)


def run_sparse_case(A, rep, nrhs, x0, iters, entry="cg_matrix",
                    zero_col=False, shuffle=False, complex_rhs=False):
    """Solve ``A`` through ``tpcg.cg`` / ``tpcg.cg_matrix`` and check
    against the oracle.  ``rep`` "planes" runs the complex system as
    float planes (``planes=True``)."""
    import scipy.sparse as sp
    import tpcg
    n = A.shape[0]
    rng = np.random.default_rng(n + nrhs)
    if shuffle:
        p = rng.permutation(n)
        A = sp.csr_matrix(A[p][:, p])
    A = A.astype(DTYPES[rep])
    cplx = np.iscomplexobj(A.data) or complex_rhs
    bdt = (np.complex64 if rep in SINGLE else np.complex128) if cplx \
        else DTYPES[rep]
    B = rng.standard_normal((n, nrhs))
    if cplx:
        B = B + 1j * rng.standard_normal((n, nrhs))
    if zero_col:
        B[:, -1] = 0
    B = B.astype(bdt)
    X0 = None
    if x0:
        X0 = (0.1 * rng.standard_normal((n, nrhs))).astype(bdt)
    packed = B.T.reshape(-1)
    xp = None if X0 is None else X0.T.reshape(-1)
    planes = rep == "planes"
    if entry == "cg":
        x, h = tpcg.cg(n, A.nnz, A.data, packed, A.indptr, A.indices, x=xp,
                       n_rhs=nrhs, n_iterations=iters, record_history=True,
                       planes=planes)
    else:
        x, h = tpcg.cg_matrix(A, packed, x=xp, n_rhs=nrhs,
                              n_iterations=iters, record_history=True,
                              planes=planes)
    X = np.asarray(x).reshape(nrhs, n).T
    X_ref, h_ref = oracle(A, B, X0, iters)
    check(X, h, X_ref, h_ref, rep in SINGLE)
    return X, h
