"""Two-plane complex path == native complex path (the planes
representation must be numerically identical to the complex64 reference
computation)."""
import numpy as np

import jax.numpy as jnp

from tpcg import block_cg
from tpcg.ops import (block_cg_planes, cdiv, cmul, from_planes,
                      make_pair_operator, to_planes, udot_planes)
from tpcg.problems import helm_fe, poisson, plane_wave_rhs


def test_cmul_cdiv():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(10) + 1j * rng.standard_normal(10)
    b = rng.standard_normal(10) + 1j * rng.standard_normal(10)
    ap, bp = to_planes(a, jnp.float64), to_planes(b, jnp.float64)
    np.testing.assert_allclose(from_planes(cmul(ap, bp)), a * b, rtol=1e-12)
    np.testing.assert_allclose(from_planes(cdiv(ap, bp)), a / b, rtol=1e-12)
    got = from_planes(udot_planes(ap[:, :, None], bp[:, :, None], axis=0))
    np.testing.assert_allclose(got[0], np.sum(a * b), rtol=1e-12)


def test_pair_matvec_matches_complex():
    S = helm_fe(9, k=5.0, eps=5.0)
    P = make_pair_operator(S, dtype=jnp.float64)
    assert not P.real_only
    rng = np.random.default_rng(1)
    x = rng.standard_normal((81, 3)) + 1j * rng.standard_normal((81, 3))
    want = np.asarray(S.matvec(jnp.asarray(x)))
    got = from_planes(P.matvec(to_planes(x, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)


def test_pair_matvec_real_matrix():
    S = poisson(8)
    P = make_pair_operator(S, dtype=jnp.float64)
    assert P.real_only
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 2)) + 1j * rng.standard_normal((64, 2))
    want = np.asarray(S.to_scipy() @ x)
    got = from_planes(P.matvec(to_planes(x, jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_block_cg_planes_matches_native_complex():
    N, k = 12, 6.0
    S = helm_fe(N, k, eps=k)
    b = plane_wave_rhs(N, k).reshape(-1)
    B = np.stack([b, 2 * b], axis=1)
    native = block_cg(S, jnp.asarray(B), n_iterations=30)
    P = make_pair_operator(S, dtype=jnp.float64)
    planes = block_cg_planes(P, to_planes(B, jnp.float64), n_iterations=30)
    np.testing.assert_allclose(from_planes(planes.x), np.asarray(native.x),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(planes.residual_history),
                               np.asarray(native.residual_history),
                               rtol=1e-9, atol=1e-9)


def test_block_cg_planes_single_rhs_and_guess():
    S = poisson(10)
    n = 100
    b = np.random.default_rng(3).standard_normal(n) + 0j
    x0 = np.random.default_rng(4).standard_normal(n) + 0j
    native = block_cg(S, jnp.asarray(b.real), jnp.asarray(x0.real),
                      n_iterations=40)
    P = make_pair_operator(S, dtype=jnp.float64)
    planes = block_cg_planes(P, to_planes(b, jnp.float64),
                             to_planes(x0, jnp.float64), n_iterations=40)
    np.testing.assert_allclose(from_planes(planes.x).real,
                               np.asarray(native.x), rtol=1e-9, atol=1e-10)


def test_block_cg_planes_f32():
    S = helm_fe(10, k=4.0, eps=4.0)
    b = plane_wave_rhs(10, 4.0).reshape(-1)
    P = make_pair_operator(S, dtype=jnp.float32)
    res = block_cg_planes(P, to_planes(b, jnp.float32), n_iterations=20)
    assert res.x.dtype == jnp.float32
    native = block_cg(S, jnp.asarray(b), n_iterations=20)
    np.testing.assert_allclose(from_planes(res.x), np.asarray(native.x),
                               rtol=5e-3, atol=5e-3)


def test_block_cg_planes_chunked_matches_monolithic():
    """RHS-chunked planes CG (balanced chunks of at most 32) must reproduce
    the single-program solve per RHS, including a padded last chunk."""
    import jax.numpy as jnp
    from tpcg.ops.cplx import (block_cg_planes, block_cg_planes_chunked,
                               make_pair_operator)
    from tpcg.problems import helm_fe, plane_wave_rhs

    N, k, iters, nb = 12, 4.0, 15, 5
    S = helm_fe(N, k, eps=k)
    b = plane_wave_rhs(N, k).reshape(-1)
    B = np.stack([(r + 1) * b for r in range(nb)], axis=1)   # (n, nb)
    bp = jnp.asarray(np.stack([B.real, B.imag]).astype(np.float32))
    P = make_pair_operator(S, dtype=jnp.float32)
    r1 = block_cg_planes(P, bp, n_iterations=iters)
    r2 = block_cg_planes_chunked(P, bp, n_iterations=iters, chunk=2)
    # per-RHS recurrences are independent, but XLA vectorizes the
    # length-n reductions differently per batch width -- f32 histories
    # drift at rounding level, not bit level
    scale = float(np.abs(np.asarray(r1.x)).max())
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=0, atol=2e-3 * scale)
    np.testing.assert_allclose(np.asarray(r2.residual_history),
                               np.asarray(r1.residual_history),
                               rtol=5e-3)
    assert r2.delta.shape == r1.delta.shape


def test_block_cg_planes_chunked_balanced_split(monkeypatch):
    """b=48 at chunk=32 must run as 24+24, not 32+(16 padded to 32):
    the greedy split cost a full extra-16-RHS of device work (the
    BLOCK_RHS.md b=48 dip).  The pad never exceeds nc-1 RHS."""
    import jax.numpy as jnp
    import tpcg.ops.cplx as cplx
    from tpcg.problems import helm_fe, plane_wave_rhs

    N, k, iters = 12, 4.0, 6
    S = helm_fe(N, k, eps=k)
    b = plane_wave_rhs(N, k).reshape(-1)
    P = cplx.make_pair_operator(S, dtype=jnp.float32)
    widths = []
    orig = cplx.block_cg_planes

    def spy(A, bc, x0=None, n_iterations=10):
        widths.append(int(bc.shape[-1]))
        return orig(A, bc, x0, n_iterations)

    monkeypatch.setattr(cplx, "block_cg_planes", spy)
    for nb, expect in ((48, 24), (40, 20), (33, 17), (64, 32)):
        widths.clear()
        B = np.stack([(r % 7 + 1) * b for r in range(nb)], axis=1)
        bp = jnp.asarray(np.stack([B.real, B.imag]).astype(np.float32))
        r = cplx.block_cg_planes_chunked(P, bp, n_iterations=iters,
                                         chunk=32)
        assert widths == [expect], (nb, widths)
        assert r.x.shape[-1] == nb and r.residual_history.shape[-1] == nb
        r0 = orig(P, bp[..., :1], n_iterations=iters)
        np.testing.assert_allclose(
            np.asarray(r.residual_history[:, 0]),
            np.asarray(r0.residual_history[:, 0]), rtol=5e-3)
