"""End-to-end distributed ORAS/FGMRES solves.

The acceptance oracle is the reference's own (SURVEY §4): post-solve true
residual ``||A x - b||`` against the *global* operator, plus agreement of
the reconstructed global solution with a scipy direct solve.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from tpcg.parallel import (Decomposition, SchwarzPrec, fgmres, hsolver,
                           make_partition, weighted_gmres)
from tpcg.parallel.hsolver import Counter, island_wave_speed
from tpcg.problems import helm_fe, local_rect, plane_wave_rhs
from tpcg.utils.config import HelmholtzConfig

from test_halo import ol_oracle


def setup_problem(M=2, W=8, OL=2, k=6.0):
    part = make_partition(M, W, OL)
    decomp = Decomposition(part)
    N = part.N
    S = helm_fe(N, k=k, eps=k)
    b = plane_wave_rhs(N, k)
    return decomp, S, b


def test_schwarz_prec_matches_spsolve_oracle():
    """One application of the ORAS preconditioner (dense_lu) against a
    per-subdomain scipy spsolve + loop-oracle exchange (UseCG=0 path)."""
    decomp, S, _ = setup_problem()
    part = decomp.part
    Sd = part.sdsz
    P = local_rect(part.N, k=6.0, eps=6.0, eta=6.0, Nhoriz=Sd, Nvert=Sd)
    prec = SchwarzPrec(decomp, P, method="dense_lu")
    rng = np.random.default_rng(0)
    z = rng.standard_normal(decomp.grid_shape) \
        + 1j * rng.standard_normal(decomp.grid_shape)
    got = np.asarray(prec(jnp.asarray(z)))

    Pcsr = P.to_scipy().tocsc()
    r = np.empty_like(z)
    M = part.M
    for p in range(part.nsubd):
        si, sj = divmod(p, M)
        r[si, sj] = spla.spsolve(Pcsr, z[si, sj].ravel()).reshape(Sd, Sd)
    want = ol_oracle(r, part, restricted=True, averaging=True)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_schwarz_block_cg_converges_to_exact():
    """With enough CG iterations the batched block-CG subdomain solve
    approaches the exact solve (UseCG=2 vs UseCG=0 cross-check)."""
    decomp, S, _ = setup_problem(M=2, W=6, OL=1)
    Sd = decomp.part.sdsz
    P = local_rect(decomp.part.N, k=6.0, eps=6.0, eta=6.0,
                   Nhoriz=Sd, Nvert=Sd)
    exact = SchwarzPrec(decomp, P, method="dense_lu")
    iterative = SchwarzPrec(decomp, P, method="block_cg", cg_iterations=800)
    rng = np.random.default_rng(1)
    z = jnp.asarray(rng.standard_normal(decomp.grid_shape)
                    + 1j * rng.standard_normal(decomp.grid_shape))
    a = np.asarray(exact(z))
    b = np.asarray(iterative(z))
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-4)


def test_fgmres_oras_converges_and_matches_direct_solve():
    decomp, S, b_global = setup_problem(M=2, W=8, OL=2, k=6.0)
    part = decomp.part
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    b = jnp.asarray(decomp.crop_grid(b_global))
    P = local_rect(part.N, k=6.0, eps=6.0, eta=6.0,
                   Nhoriz=part.sdsz, Nvert=part.sdsz)
    prec = SchwarzPrec(decomp, P, method="dense_lu")
    res = fgmres(lambda x: decomp.ax_op(coef, S.offsets, x), b, M=prec,
                 tol=1e-8, krylsize=60, norm=decomp.norm, wdot=decomp.wdot)
    assert res.converged
    # true residual against the GLOBAL operator
    x_glob = decomp.to_global(np.asarray(res.x), check=True, tol=1e-5)
    A = S.to_scipy()
    r = A @ x_glob.ravel() - b_global.ravel()
    assert np.linalg.norm(r) < 1e-6 * np.linalg.norm(b_global)
    # and against the direct solve
    x_direct = spla.spsolve(A.tocsc(), b_global.ravel())
    err = np.abs(x_glob.ravel() - x_direct).max() / np.abs(x_direct).max()
    assert err < 1e-5


def test_fgmres_unpreconditioned():
    decomp, S, b_global = setup_problem(M=2, W=6, OL=1, k=3.0)
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    b = jnp.asarray(decomp.crop_grid(b_global))
    res = fgmres(lambda x: decomp.ax_op(coef, S.offsets, x), b,
                 tol=1e-8, krylsize=200, norm=decomp.norm,
                 wdot=decomp.wdot)
    assert res.converged
    x_glob = decomp.to_global(np.asarray(res.x), check=True, tol=1e-5)
    A = S.to_scipy()
    r = A @ x_glob.ravel() - b_global.ravel()
    assert np.linalg.norm(r) < 1e-5 * np.linalg.norm(b_global)


def test_wgmres_oras_converges():
    decomp, S, b_global = setup_problem(M=2, W=8, OL=2, k=6.0)
    part = decomp.part
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    b = jnp.asarray(decomp.crop_grid(b_global))
    P = local_rect(part.N, k=6.0, eps=6.0, eta=6.0,
                   Nhoriz=part.sdsz, Nvert=part.sdsz)
    prec = SchwarzPrec(decomp, P, method="dense_lu")
    res = weighted_gmres(lambda x: decomp.ax_op(coef, S.offsets, x), b,
                         M=prec, tol=1e-6, maxiter=100,
                         weights=decomp.unique_weights())
    assert res.converged
    x_glob = decomp.to_global(np.asarray(res.x), check=True, tol=1e-4)
    A = S.to_scipy()
    r = A @ x_glob.ravel() - b_global.ravel()
    # wgmres applies M on the left; the convergence test is on the
    # preconditioned residual, so allow slack on the true one
    assert np.linalg.norm(r) < 1e-3 * np.linalg.norm(b_global)


def test_hsolver_end_to_end():
    """The full HSolver pipeline (assembly, ORAS, FGMRES, verification)
    with reference-flavoured settings scaled down."""
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=0, tol=1e-6,
                          restart=80, dtype="complex128", verbose=0)
    counter = Counter(verbose=0)
    res = hsolver(cfg, callback=counter)
    assert res.converged
    assert res.true_residual < 5e-5
    assert res.iterations == counter.it
    assert len(counter.residuals) >= res.iterations

    # solution matches the direct solve of the global system
    from tpcg.problems import helm_fe as _hf
    part = res.decomp.part
    A = _hf(part.N, cfg.k, cfg.epsilon).to_scipy()
    b = plane_wave_rhs(part.N, cfg.k)
    x_direct = spla.spsolve(A.tocsc(), b.ravel())
    x_glob = res.decomp.to_global(np.asarray(res.x), check=True, tol=1e-4)
    err = np.abs(x_glob.ravel() - x_direct).max() / np.abs(x_direct).max()
    assert err < 1e-4


def test_hsolver_block_cg_subsolves():
    """UseCG=2-style batched CG subsolves: same convergence as exact."""
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=2,
                          cg_max_it=300, tol=1e-6, restart=80,
                          dtype="complex128", verbose=0)
    res = hsolver(cfg)
    assert res.converged
    assert res.true_residual < 5e-5


def test_hsolver_poisson():
    cfg = HelmholtzConfig(M_subd=2, W_subd=8, use_poisson=True, use_cg=0,
                          tol=1e-8, restart=100, dtype="complex128",
                          verbose=0)
    res = hsolver(cfg)
    assert res.converged


def test_hsolver_var_coeff():
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, var_coeff=True,
                          mar_mult_in=2.0, mar_mult_out=1.0, use_cg=2,
                          cg_max_it=300, tol=1e-6, restart=100,
                          dtype="complex128", verbose=0)
    res = hsolver(cfg)
    assert res.converged
    assert res.true_residual < 1e-4


def test_island_wave_speed():
    c = island_wave_speed(13, 3, mult_in=3.0, mult_out=1.0,
                          match_subdomains=True)
    assert c.shape == (12, 12)
    assert c.min() == 1.0 and c.max() == 3.0
    # middle-third square carries mult_in
    assert c[6, 6] == 3.0 and c[0, 0] == 1.0


def test_hsolver_poisson_robin0():
    """robin=0 must use the operator's own stencil offsets (regression:
    the 5-point Poisson crop was paired with 7 Helmholtz offsets and JAX's
    clamped indexing silently corrupted the preconditioner)."""
    cfg = HelmholtzConfig(M_subd=2, W_subd=8, use_poisson=True, robin=0,
                          use_cg=2, cg_max_it=200, tol=1e-8, restart=100,
                          dtype="complex128", verbose=0)
    res = hsolver(cfg)
    assert res.converged
    assert res.true_residual < 1e-5


def test_hsolver_numpy_subsolves():
    """UseCG=5 host NumPy-CG oracle mode."""
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=5,
                          cg_max_it=400, cg_tol=1e-8, tol=1e-6, restart=80,
                          dtype="complex128", use_planes=False, verbose=0)
    res = hsolver(cfg)
    assert res.converged
    assert res.true_residual < 1e-4


def test_random_guess_is_overlap_consistent():
    from tpcg.parallel.hsolver import generate_random_guess
    from tpcg.parallel import Decomposition, make_partition
    decomp = Decomposition(make_partition(3, 8, 2))
    x = generate_random_guess(decomp, np.complex128, seed=3)
    decomp.to_global(np.asarray(x), check=True, tol=1e-10)
    xp = generate_random_guess(decomp, np.complex64, seed=3, planes=True)
    xc = np.asarray(xp[0]) + 1j * np.asarray(xp[1])
    decomp.to_global(xc, check=True, tol=1e-5)


def test_schwarz_planes_dense_lu_tuple_rejected():
    import pytest as _pytest
    decomp, S, _ = setup_problem(M=2, W=6, OL=1)
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    with _pytest.raises(NotImplementedError):
        SchwarzPrec(decomp, (coef, S.offsets), method="dense_lu",
                    planes=True)


def test_hsolver_random_guess_and_wgmres():
    """guess=2 (consistent random x0) through the wgmres dispatcher."""
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=0, tol=1e-6,
                          restart=100, gmres_ver="wgmres", guess=2,
                          dtype="complex128", verbose=0)
    res = hsolver(cfg)
    assert res.converged
    assert res.true_residual < 1e-3


def test_island_variants():
    c = island_wave_speed(13, 3, 2.0, 0.5, match_subdomains=False)
    assert set(np.unique(c)) == {0.5, 2.0}
    c2 = island_wave_speed(13, 3, 2.0, 0.5, match_subdomains=True, shift=2)
    assert c2.shape == (12, 12)


def test_fgmres_happy_breakdown_identity():
    """Exact convergence inside an Arnoldi step gives h_sub == 0; the basis
    update must stay finite (regression -- the reference NaNs here,
    ``p_h-PY_C-CL-multi-GPU.py:2987``; deliberate fix)."""
    n = 16
    b = np.arange(1.0, n + 1.0) + 0j
    res = fgmres(lambda x: x, jnp.asarray(b), tol=1e-12, krylsize=5)
    assert res.converged and res.iterations == 1
    assert np.all(np.isfinite(np.asarray(res.x)))
    np.testing.assert_allclose(np.asarray(res.x), b, rtol=1e-12)


def test_schwarz_tuple_p_numpy_method_honored():
    """UseCG=5 with per-subdomain (var-coeff) blocks must run the host
    NumPy-CG oracle per subdomain, not silently fall through to device
    block-CG (regression).  Cross-check: a tight-tolerance NumPy subsolve
    approaches the per-subdomain exact solve."""
    import scipy.sparse.linalg as sl
    from tpcg.sparse import Stencil2D

    decomp, S, _ = setup_problem(M=2, W=6, OL=1)
    part = decomp.part
    Sd, M = part.sdsz, part.M
    # per-subdomain impedance blocks with slightly different damping so the
    # blocks genuinely differ
    coefs = []
    for p in range(part.nsubd):
        blk = local_rect(part.N, k=6.0, eps=6.0 + 0.2 * p, eta=6.0,
                         Nhoriz=Sd, Nvert=Sd)
        coefs.append(np.asarray(blk.coef))
    coef = np.stack(coefs, axis=1).reshape((-1, M, M, Sd, Sd))
    P = (jnp.asarray(coef), blk.offsets)

    rng = np.random.default_rng(5)
    z = rng.standard_normal(decomp.grid_shape) \
        + 1j * rng.standard_normal(decomp.grid_shape)
    prec = SchwarzPrec(decomp, P, method="numpy", cg_iterations=4000,
                       cg_tol=1e-12)
    got = np.asarray(prec(jnp.asarray(z)))

    r = np.empty_like(z)
    for p in range(part.nsubd):
        si, sj = divmod(p, M)
        A = Stencil2D(blk.offsets, coef[:, si, sj], (Sd, Sd)).to_scipy()
        r[si, sj] = sl.spsolve(A.tocsc(), z[si, sj].ravel()).reshape(Sd, Sd)
    want = ol_oracle(r, part, restricted=True, averaging=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_fgmres_triangular_self_check_runs(capsys):
    """``zsolupcont(check=True)`` parity: the self-check mode runs and stays
    silent on a healthy solve (``p_h-PY_C-CL-multi-GPU.py:2810-2827``)."""
    decomp, S, b = setup_problem(M=2, W=6, OL=1)
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    bg = jnp.asarray(decomp.crop_grid(b))
    res = fgmres(lambda x: decomp.ax_op(coef, S.offsets, x), bg,
                 tol=1e-6, krylsize=60, norm=decomp.norm, wdot=decomp.wdot,
                 check_triangular=True)
    assert res.converged
    assert "zsolup check" not in capsys.readouterr().out


def test_hsolver_oshape_inactive_nodes():
    """OshapeD masking: RHS and initial guess zeroed at inactive nodes
    (``p_h-PY_C-CL-multi-GPU.py:1429-1430, 3482-3484``), and the masked
    solve still converges."""
    from tpcg.problems import oshape_mask
    from tpcg.parallel.hsolver import build_operator
    from tpcg.parallel import make_partition

    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, OL=2, use_cg=0,
                          restart=200, verbose=0, oshape_d=True,
                          dtype="complex128", use_planes=False)
    res = hsolver(cfg)
    assert res.converged
    # the masked RHS is zero in the hole, so check the solve is against
    # the masked problem: rebuild the mask and compare residual there
    part = make_partition(cfg.M_subd, cfg.W_subd, cfg.overlap)
    decomp = Decomposition(part)
    mask = decomp.crop_grid(oshape_mask(part.N))
    _, coef_np, b_global = build_operator(cfg, decomp)
    bg = decomp.crop_grid(b_global) * mask
    coef = jnp.asarray(coef_np)
    S = helm_fe(part.N, cfg.k, cfg.epsilon)
    r = np.asarray(decomp.ax_op(coef, S.offsets, jnp.asarray(res.x))) - bg
    rn = float(np.asarray(decomp.norm(jnp.asarray(r))))
    b0 = float(np.asarray(decomp.norm(jnp.asarray(bg))))
    assert rn < 1e-5 * max(b0, 1.0)


def test_oshape_mask_shape():
    from tpcg.problems import oshape_mask
    m = oshape_mask(12)
    assert m.shape == (12, 12)
    assert m[6, 6] == 0.0 and m[0, 0] == 1.0 and m[1, 6] == 1.0
    # hole is the middle third
    assert m.sum() == 12 * 12 - 4 * 4


def test_fgmres_chunked_matches_per_iteration():
    """chunk>1 fuses whole Arnoldi steps per device call; the residual
    history and solution must match the chunk=1 (reference) behaviour."""
    decomp, S, b = setup_problem(M=2, W=6, OL=1)
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    bg = jnp.asarray(decomp.crop_grid(b))
    mv = lambda x: decomp.ax_op(coef, S.offsets, x)
    r1 = fgmres(mv, bg, tol=1e-8, krylsize=40, norm=decomp.norm,
                wdot=decomp.wdot)
    r4 = fgmres(mv, bg, tol=1e-8, krylsize=40, norm=decomp.norm,
                wdot=decomp.wdot, chunk=4)
    assert r4.converged == r1.converged
    assert r4.iterations == r1.iterations
    np.testing.assert_allclose(np.asarray(r4.x), np.asarray(r1.x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(r4.residual_norms, r1.residual_norms,
                               rtol=1e-8)


def test_hsolver_fgmres_chunk_config():
    cfg1 = HelmholtzConfig(k=6.0, M_subd=2, W_subd=6, OL=1, use_cg=0,
                           restart=100, verbose=0, dtype="complex128",
                           use_planes=False)
    cfg4 = dataclasses.replace(cfg1, fgmres_chunk=4)
    r1 = hsolver(cfg1)
    r4 = hsolver(cfg4)
    assert r1.iterations == r4.iterations
    np.testing.assert_allclose(np.asarray(r4.x), np.asarray(r1.x),
                               rtol=1e-9, atol=1e-11)
    # adaptive last-chunk split: no preconditioner work past convergence
    # on a converging solve (VERDICT r2 item 9)
    assert r1.wasted_prec_applies == 0
    assert r4.wasted_prec_applies == 0


def test_fgmres_chunked_adaptive_no_waste():
    """The chunked driver drops to single steps near convergence, so
    converging solves waste zero Arnoldi/preconditioner applications
    even when the iteration count is not a chunk multiple."""
    decomp, S, b = setup_problem(M=2, W=6, OL=1)
    coef = jnp.asarray(decomp.crop_stencil(np.asarray(S.coef)))
    bg = jnp.asarray(decomp.crop_grid(b))
    mv = lambda x: decomp.ax_op(coef, S.offsets, x)
    for chunk in (4, 8):
        for tol in (1e-2, 1e-3):
            r = fgmres(mv, bg, tol=tol, krylsize=40, norm=decomp.norm,
                       wdot=decomp.wdot, chunk=chunk)
            assert r.converged, (chunk, tol, r.residual_norms[-1])
            assert r.wasted_applies == 0, (chunk, tol, r.wasted_applies)
