"""Two-plane distributed path == native-complex distributed path.

The ORAS/FGMRES stack can run on float planes (``use_planes``); these
tests pin the plane implementations of the halo exchange, distributed
matvec, reductions, Schwarz preconditioner and full hsolver to the complex
ones on CPU (in float64 planes for tight comparison where possible).
"""
import numpy as np

import jax.numpy as jnp

from tpcg.parallel import Decomposition, SchwarzPrec, make_partition, hsolver
from tpcg.parallel.fgmres import planes_lincomb
from tpcg.problems import helm_fe, local_rect, plane_wave_rhs
from tpcg.utils.config import HelmholtzConfig


def planes64(x):
    x = np.asarray(x)
    return jnp.asarray(np.stack([x.real, x.imag]))


def unplanes(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1]


def setup(M=2, W=8, OL=2, k=6.0):
    part = make_partition(M, W, OL)
    decomp = Decomposition(part)
    S = helm_fe(part.N, k=k, eps=k)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(decomp.grid_shape)
         + 1j * rng.standard_normal(decomp.grid_shape))
    return decomp, S, x


def test_ol_update_planes():
    decomp, _, x = setup()
    want = np.asarray(decomp.ol_update(jnp.asarray(x)))
    got = unplanes(decomp.ol_update_planes(planes64(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_ax_op_planes():
    decomp, S, x = setup()
    coef = decomp.crop_stencil(np.asarray(S.coef))
    want = np.asarray(decomp.ax_op(jnp.asarray(coef), S.offsets,
                                   jnp.asarray(x)))
    coef3 = jnp.asarray(np.stack([coef.real, coef.imag,
                                  coef.real + coef.imag]))
    got = unplanes(decomp.ax_op_planes(coef3, S.offsets, planes64(x)))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


def test_reductions_planes():
    decomp, _, x = setup()
    y = x[::-1] if False else np.conj(x) + 0.5 * x
    assert np.isclose(float(decomp.norm_planes(planes64(x))),
                      float(decomp.norm(jnp.asarray(x))), rtol=1e-12)
    X = np.stack([x, y, np.zeros_like(x)])
    Xp = jnp.asarray(np.stack([X.real, X.imag], axis=1))
    got = np.asarray(decomp.wdot_planes(Xp, planes64(y)))
    got_c = got[0] + 1j * got[1]
    want = np.asarray(decomp.wdot(jnp.asarray(X), jnp.asarray(y)))
    np.testing.assert_allclose(got_c, want, rtol=1e-12)


def test_planes_lincomb():
    rng = np.random.default_rng(1)
    V = rng.standard_normal((4, 5)) + 1j * rng.standard_normal((4, 5))
    c = rng.standard_normal(4) + 1j * rng.standard_normal(4)
    Vp = jnp.asarray(np.stack([V.real, V.imag], axis=1))
    got = unplanes(planes_lincomb(c, Vp))
    np.testing.assert_allclose(got, c @ V, rtol=1e-12)


def test_schwarz_planes_matches_complex():
    decomp, _, x = setup()
    part = decomp.part
    P = local_rect(part.N, k=6.0, eps=6.0, eta=6.0,
                   Nhoriz=part.sdsz, Nvert=part.sdsz)
    for method in ("dense_lu", "block_cg"):
        pc = SchwarzPrec(decomp, P, method=method, cg_iterations=200)
        pp = SchwarzPrec(decomp, P, method=method, cg_iterations=200,
                         planes=True)
        want = np.asarray(pc(jnp.asarray(x)))
        got = unplanes(pp(planes64(x).astype(jnp.float32)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)


def test_hsolver_planes_matches_complex():
    cfg = dict(k=6.0, M_subd=2, W_subd=8, use_cg=0, tol=1e-6, restart=60,
               verbose=0)
    res_c = hsolver(HelmholtzConfig(dtype="complex128", use_planes=False,
                                    **cfg))
    res_p = hsolver(HelmholtzConfig(dtype="complex64", use_planes=True,
                                    **cfg))
    assert res_p.converged
    # f32 planes vs f64 complex: same iteration count, close solutions
    assert abs(res_p.iterations - res_c.iterations) <= 1
    xc = np.asarray(res_c.x)
    xp = np.asarray(res_p.x)
    assert np.abs(xp - xc).max() / np.abs(xc).max() < 1e-3
    assert res_p.true_residual < 10 * max(res_c.true_residual, 1e-5)


def test_hsolver_planes_block_cg():
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=2,
                          cg_max_it=300, tol=1e-6, restart=60,
                          dtype="complex64", use_planes=True, verbose=0)
    res = hsolver(cfg)
    assert res.converged


def test_wgmres_planes_matches_complex():
    """Component #29 on planes: ``weighted_gmres`` driven with two-plane
    vectors (as ``hsolver`` wires it with ``use_planes``) must track the
    native-complex run."""
    from tpcg.parallel.wgmres import weighted_gmres

    decomp, S, _ = setup()
    coef = decomp.crop_stencil(np.asarray(S.coef))
    b = decomp.crop_grid(plane_wave_rhs(decomp.part.N, 6.0))

    mv_c = lambda x: decomp.ax_op(jnp.asarray(coef), S.offsets, x)
    res_c = weighted_gmres(mv_c, jnp.asarray(b), tol=1e-6, maxiter=400,
                           weights=decomp.unique_weights())

    coef3 = jnp.asarray(np.stack([coef.real, coef.imag,
                                  coef.real + coef.imag])
                        .astype(np.float64))
    bp = planes64(b)
    mv_p = lambda x: decomp.ax_op_planes(coef3, S.offsets, x)
    res_p = weighted_gmres(mv_p, bp, tol=1e-6, maxiter=400,
                           weights=decomp.unique_weights(), planes=True)

    assert res_c.converged and res_p.converged
    assert res_p.iterations == res_c.iterations
    xc = np.asarray(res_c.x)
    xp = unplanes(res_p.x)
    np.testing.assert_allclose(xp, xc, rtol=0,
                               atol=1e-8 * np.abs(xc).max())


def test_hsolver_wgmres_planes_e2e():
    """Dispatcher parity (``p_h-PY_C-CL-multi-GPU.py:3294-3338``):
    ``gmres_ver='wgmres'`` + ``use_planes=True`` through the full hsolver
    stack (ORAS preconditioner included) vs the complex CPU run."""
    cfg = dict(k=6.0, M_subd=2, W_subd=8, use_cg=0, tol=1e-6,
               restart=100, gmres_ver="wgmres", verbose=0)
    res_c = hsolver(HelmholtzConfig(dtype="complex128", use_planes=False,
                                    **cfg))
    res_p = hsolver(HelmholtzConfig(dtype="complex64", use_planes=True,
                                    **cfg))
    assert res_c.converged and res_p.converged
    assert abs(res_p.iterations - res_c.iterations) <= 1
    xc = np.asarray(res_c.x)
    xp = np.asarray(res_p.x)
    assert np.abs(xp - xc).max() / np.abs(xc).max() < 1e-3


def test_hsolver_var_coeff_planes():
    """Variable-coefficient solve in two-plane mode:
    the per-subdomain (coef3, offsets) preconditioner pair must jit with
    the offsets STATIC (regression: passing the tuple through the jit
    argument pytree turned the int offsets into tracers and crashed
    every var_coeff planes solve)."""
    cfg = HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, var_coeff=True,
                          mar_mult_in=2.0, mar_mult_out=1.0, use_cg=2,
                          cg_max_it=300, tol=1e-6, restart=100,
                          dtype="complex64", use_planes=True, verbose=0)
    res = hsolver(cfg)
    assert res.converged
    assert res.true_residual < 5e-4
