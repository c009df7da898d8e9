"""Stencil CG planning (``tpcg.ops.auto``).

The planner fixes the complex representation (native complex unless
``path`` asks for planes) and the batch contract of
``StencilCGPlan.solve``.  Numerical parity of every problem class
against the float64 oracle lives in the ``tests/test_paths_*.py`` files.
"""
import jax
import numpy as np
import pytest

from tpcg.ops.auto import plan_stencil_cg, stencil_cg
from tpcg.problems import helm_fe, helm_fe_var, plane_wave_rhs


@pytest.fixture
def prob():
    N, k = 32, 9.0
    return helm_fe(N, k, eps=k), plane_wave_rhs(N, k), N


def test_path_selection(prob, monkeypatch):
    A, b, N = prob
    # CPU backend: native complex
    assert plan_stencil_cg(A, 5).path == "xla"
    # a GPU backend takes the same default (native complex64 was faster
    # than float32 planes on an H100)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    want = "xla"
    assert plan_stencil_cg(A, 5).path == want
    rng = np.random.default_rng(0)
    C = 1.0 + 0.5 * rng.random((N - 1, N - 1))
    Av = helm_fe_var(N, 9.0, C, rho=0.1)
    assert plan_stencil_cg(Av, 5).path == want
    # real stencils never take planes
    from tpcg.problems.poisson import poisson
    assert plan_stencil_cg(poisson(16), 5).path == "xla"
    # explicit representation, and the removed tiers are refused
    assert plan_stencil_cg(A, 5, path="xla-planes").path == "xla-planes"
    assert plan_stencil_cg(A, 5, path="xla").path == "xla"
    for gone in ("vmem-coef", "stream", "stream-real"):
        with pytest.raises(ValueError, match="unknown path"):
            plan_stencil_cg(A, 5, path=gone)
    with pytest.raises(ValueError, match="complex stencil"):
        plan_stencil_cg(poisson(16), 5, path="xla-planes")


def test_explicit_batch_axis_preserved(prob):
    """A (1, Nv, Nh) input keeps its batch axis in the outputs."""
    A, b, N = prob
    x, h = stencil_cg(A, b[None], n_iterations=5, path="xla")
    assert x.shape == (1, N, N) and h.shape == (6, 1)
    x2, h2 = stencil_cg(A, b, n_iterations=5, path="xla")
    assert x2.shape == (N, N) and h2.shape == (6,)
    np.testing.assert_allclose(x[0], x2, rtol=1e-6)


def test_flat_batched_rhs_not_squeezed(prob):
    """Flat (B*Nv*Nh,) and column-stacked (B, Nv*Nh) multi-RHS inputs
    must solve every RHS (regression: the old squeeze heuristic silently
    returned only the first)."""
    A, b, N = prob
    B = np.stack([b, b * (1 + 0.3j), b * 0.5])
    x_ref, _ = stencil_cg(A, B, n_iterations=8, path="xla")
    for form in (B.reshape(-1), B.reshape(3, N * N)):
        x, h = stencil_cg(A, form, n_iterations=8, path="xla")
        assert x.shape == (3, N, N) and h.shape == (9, 3)
        np.testing.assert_allclose(x, x_ref, rtol=1e-6)
