"""The backend gate (``tpcg.backend``): no hand-written kernels, and no
default that depends on the backend.

* On a (faked) GPU backend every entry point -- ``cg``, ``cg_matrix``,
  ``plan_stencil_cg``, ``hsolver`` -- runs plain XLA (no ``pallas_call``
  is ever bound) with the defaults measured on the H100: native complex64
  and ``fgmres_chunk=1`` (PERF.md, bring-up sweep).
* The compile cache follows ``JAX_COMPILATION_CACHE_DIR`` or sits at
  ``<checkout>/.jax_cache``.
* ``chip_smoke.py`` refuses to run without a GPU.
* The Krylov basis contractions ask for full float32 precision (a GPU may
  otherwise run them in TF32).
"""
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as sp
from jax import lax

import tpcg
from tpcg import backend
from tpcg.parallel import hsolver
from tpcg.problems import helm_fe, plane_wave_rhs
from tpcg.utils.config import HelmholtzConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_gate_defaults(platform, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    # measured on the H100: native complex64 beat float32 planes at
    # helm_fem and hsolver M=2, and fgmres_chunk=1 beat 4 and 8
    cfg = HelmholtzConfig()
    assert cfg.use_planes is False and cfg.fgmres_chunk == 1
    for fn in (tpcg.cg, tpcg.cg_matrix):
        assert inspect.signature(fn).parameters["planes"].default is False
    S = helm_fe(8, 3.0, eps=3.0, dtype=np.complex64)
    assert tpcg.plan_stencil_cg(S, 2).path == "xla"


@pytest.fixture
def fake_gpu(monkeypatch):
    """A GPU backend as the gate sees it, with pallas_call forbidden."""
    from jax._src.pallas import pallas_call as pc

    def no_pallas(*a, **k):
        raise AssertionError("a pallas_call was traced")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(pc.pallas_call_p, "bind", no_pallas)


def test_gpu_entry_points_run_xla_with_measured_defaults(fake_gpu,
                                                         monkeypatch):
    import tpcg.api as api
    hs = sys.modules["tpcg.parallel.hsolver"]   # the module, not the function

    def planes_called(*a, **k):
        raise AssertionError("planes path taken on the GPU")
    monkeypatch.setattr(api, "_solve_planes", planes_called)

    S = helm_fe(16, 6.0, eps=6.0, dtype=np.complex64)
    A = S.to_scipy()
    b = plane_wave_rhs(16, 6.0).reshape(-1).astype(np.complex64)
    x = tpcg.cg(A.shape[0], A.nnz, A.data, b, A.indptr, A.indices,
                n_iterations=10)
    assert np.all(np.isfinite(x))
    assert np.all(np.isfinite(tpcg.cg_matrix(A, b, n_iterations=10)))
    Q = sp.random(40, 40, density=0.1, random_state=0, format="csr")
    R = sp.csr_matrix(Q @ Q.T + 40 * sp.eye(40), dtype=np.float32)
    assert np.all(np.isfinite(tpcg.cg_matrix(R, np.ones(40, np.float32),
                                             n_iterations=10)))
    plan = tpcg.plan_stencil_cg(S, 10)
    assert plan.path == "xla"
    assert np.all(np.isfinite(plan.solve(b.reshape(16, 16))[0]))

    chunks = []
    real_fgmres = hs.fgmres

    def recording_fgmres(*a, **k):
        chunks.append(k["chunk"])
        return real_fgmres(*a, **k)
    monkeypatch.setattr(hs, "fgmres", recording_fgmres)
    res = hsolver(HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=2,
                                  cg_max_it=60, restart=40, verbose=0))
    assert res.converged
    assert chunks == [1]
    # native complex: the solution stays a complex device array
    assert isinstance(res.x, jax.Array) and res.x.dtype == np.complex64


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_rule(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert backend.use_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = backend.use_compile_cache()
            assert path == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _dot_generals(jaxpr):
    """Every dot_general equation in a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dot_generals(inner)


@pytest.mark.parametrize("planes,chunk", [(False, 1), (True, 1),
                                          (False, 4)])
def test_fgmres_contractions_highest(planes, chunk, monkeypatch):
    """Trace every jitted program of one small hsolver run and read the
    precision of each dot_general from its jaxpr."""
    real_jit = jax.jit
    found = []

    def recording_jit(fun, *a, **k):
        compiled = real_jit(fun, *a, **k)

        def call(*args):
            found.extend(_dot_generals(jax.make_jaxpr(fun)(*args).jaxpr))
            return compiled(*args)
        return call
    monkeypatch.setattr(jax, "jit", recording_jit)
    res = hsolver(HelmholtzConfig(k=6.0, M_subd=2, W_subd=8, use_cg=2,
                                  cg_max_it=40, restart=30, verbose=0,
                                  use_planes=planes, fgmres_chunk=chunk,
                                  dtype="complex64"))
    assert res.iterations > 0
    assert found, "no contraction traced"
    for eqn in found:
        assert eqn.params["precision"] == (lax.Precision.HIGHEST,) * 2, eqn


def test_package_has_one_backend_gate_and_no_kernels():
    for path in sorted((ROOT / "tpcg").rglob("*.py")):
        text = path.read_text()
        assert "pallas" not in text and "interpret=" not in text, path
        # no path or default is chosen by the backend
        assert "default_backend" not in text, path
        assert ".platform" not in text, path
