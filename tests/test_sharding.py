"""Multi-device sharding: the distributed operators must produce identical
results when the subdomain grid is sharded over a device mesh (the stand-in
for multi-device runs; 8 virtual CPU devices from conftest)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpcg.parallel import Decomposition, make_partition, hsolver
from tpcg.problems import helm_fe, plane_wave_rhs
from tpcg.utils.config import HelmholtzConfig

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def make_mesh():
    return Mesh(np.array(jax.devices()[:8]), ("sd",))


def test_sharded_halo_and_matvec_match_single_device():
    part = make_partition(8, 4, 1)
    decomp = Decomposition(part)
    S = helm_fe(part.N, k=5.0, eps=5.0)
    coef_np = decomp.crop_stencil(np.asarray(S.coef))
    rng = np.random.default_rng(0)
    x_np = (rng.standard_normal(decomp.grid_shape)
            + 1j * rng.standard_normal(decomp.grid_shape))

    ref_ol = np.asarray(decomp.ol_update(jnp.asarray(x_np)))
    ref_ax = np.asarray(decomp.ax_op(jnp.asarray(coef_np), S.offsets,
                                     jnp.asarray(x_np)))
    ref_nrm = float(decomp.norm(jnp.asarray(x_np)))

    mesh = make_mesh()
    sh = NamedSharding(mesh, P("sd"))
    x = jax.device_put(jnp.asarray(x_np), sh)
    coef = jax.device_put(jnp.asarray(coef_np),
                          NamedSharding(mesh, P(None, "sd")))

    ol = jax.jit(decomp.ol_update)
    ax = jax.jit(lambda c, v: decomp.ax_op(c, S.offsets, v))
    nrm = jax.jit(decomp.norm)

    got_ol = np.asarray(ol(x))
    got_ax = np.asarray(ax(coef, x))
    got_nrm = float(nrm(x))
    np.testing.assert_allclose(got_ol, ref_ol, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_ax, ref_ax, rtol=1e-11, atol=1e-11)
    assert np.isclose(got_nrm, ref_nrm, rtol=1e-12)
    # outputs keep the sharding (no implicit gather)
    assert not ol(x).is_fully_replicated


def _collective_payloads(txt):
    """Parse compiled HLO text -> {op_kind: [total elements per def]}.

    Counts only op *definitions* (``%all-gather.3 = ...``); tuple-shaped
    defs sum their element counts.  Scalar/bookkeeping collectives are
    expected; what must never appear is a collective that moves
    state-sized payloads (that would mean GSPMD fell back to gathering
    the (M, M, S, S) grid instead of neighbour exchange).
    """
    import re
    out = {"all-gather": [], "all-to-all": [], "collective-permute": []}
    for line in txt.splitlines():
        m = re.match(r"\s*(?:ROOT )?%(all-gather|all-to-all|"
                     r"collective-permute)[.\d]*\s*=\s*(.*)", line)
        if not m:
            continue
        kind, rest = m.group(1), m.group(2)
        # shapes before the op name, e.g. "(c128[1,1,6,6]{...}, ...) all-..."
        shapes = re.findall(r"[a-z0-9]+\[([\d,]*)\]", rest.split(kind)[0])
        total = 0
        for s in shapes:
            n = 1
            for d in s.split(","):
                if d:
                    n *= int(d)
            total += n
        out[kind].append(total)
    return out


def test_sharded_comm_lowers_to_collective_permute():
    """The docstring claim of ``tpcg/parallel/halo.py`` -- subdomain-grid
    shifts lower to neighbour ``collective-permute`` (the device twin of
    ``OL_update``'s 8-direction Isend/Irecv,
    ``p_h-PY_C-CL-multi-GPU.py:2183-2497``), never to an all-gather of the
    (M, M, S, S) state -- checked against the compiled HLO on the 8-device
    mesh (the only evidence obtainable without real multi-chip hardware).
    """
    from tpcg.parallel.dist_cg import distributed_cg

    part = make_partition(8, 4, 1)
    decomp = Decomposition(part)
    S = helm_fe(part.N, k=5.0, eps=5.0)
    coef_np = decomp.crop_stencil(np.asarray(S.coef))
    rng = np.random.default_rng(0)
    x_np = (rng.standard_normal(decomp.grid_shape)
            + 1j * rng.standard_normal(decomp.grid_shape))

    mesh = make_mesh()
    sh = NamedSharding(mesh, P("sd"))
    x = jax.device_put(jnp.asarray(x_np), sh)
    coef = jax.device_put(jnp.asarray(coef_np),
                          NamedSharding(mesh, P(None, "sd")))
    b = jax.device_put(jnp.asarray(x_np), sh)

    state_elems = int(np.prod(decomp.grid_shape))        # full grid
    shard_elems = state_elems // 8                       # one device's rows

    cases = {
        "ol_update": (jax.jit(decomp.ol_update), (x,)),
        "ax_op": (jax.jit(lambda c, v: decomp.ax_op(c, S.offsets, v)),
                  (coef, x)),
        "cg_step": (jax.jit(lambda c, bb: distributed_cg(
            decomp, c, S.offsets, bb, n_iterations=3).x), (coef, b)),
    }
    for name, (fn, args) in cases.items():
        txt = fn.lower(*args).compile().as_text()
        got = _collective_payloads(txt)
        assert got["collective-permute"], \
            f"{name}: no collective-permute in compiled HLO"
        # all-gathers may exist only for scalar reduction plumbing
        big_ag = [n for n in got["all-gather"] if n >= shard_elems]
        assert not big_ag, \
            f"{name}: state-sized all-gather payloads {big_ag}"
        # all-to-alls may exist only for O(boundary) strip exchange
        big_a2a = [n for n in got["all-to-all"] if n >= state_elems]
        assert not big_a2a, \
            f"{name}: state-sized all-to-all payloads {big_a2a}"


def test_batch_sharded_subdomain_cg_has_no_collectives():
    """The UseCG=6 analog (reference multi-GPU thread fan-out,
    ``p_h-PY_C-CL-multi-GPU.py:2123-2181``): a batched subdomain CG
    with the RHS/batch axis sharded over the mesh is pure data
    parallelism -- the compiled HLO must contain NO data collectives at
    all (per-RHS alpha/beta reduce over the LOCAL length axis only,
    exactly as the reference's threads never communicate mid-solve)."""
    from tpcg.cg import block_cg

    mesh = make_mesh()
    N, B = 16, 8
    A = helm_fe(N, 5.0, eps=5.0)
    coef = jnp.asarray(np.asarray(A.coef).astype(np.complex64))
    import dataclasses
    A = dataclasses.replace(A, coef=coef)
    rng = np.random.default_rng(0)
    bm = (rng.standard_normal((N * N, B))
          + 1j * rng.standard_normal((N * N, B))).astype(np.complex64)
    bsh = jax.device_put(jnp.asarray(bm),
                         NamedSharding(mesh, P(None, "sd")))
    fn = jax.jit(lambda bb: block_cg(A, bb, n_iterations=3).x,
                 out_shardings=NamedSharding(mesh, P(None, "sd")))
    txt = fn.lower(bsh).compile().as_text()
    got = _collective_payloads(txt)
    moved = {k: v for k, v in got.items() if v}
    assert not moved, f"batch-sharded CG has collectives: {moved}"
    assert "all-reduce" not in txt, "unexpected all-reduce"


def test_hsolver_sharded_matches_unsharded():
    cfg = HelmholtzConfig(k=5.0, M_subd=8, W_subd=4, OL=1, use_cg=2,
                          cg_max_it=150, tol=1e-6, restart=60,
                          dtype="complex128", verbose=0)
    res_single = hsolver(cfg)
    res_sharded = hsolver(cfg, mesh=make_mesh())
    assert res_sharded.converged
    assert res_sharded.iterations == res_single.iterations
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_single.x),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("planes", [False, True], ids=["native", "planes"])
def test_hsolver_sharded_wgmres_matches_unsharded(planes):
    """wGMRES lifts its recurrence to the host; on a single-process mesh
    its device vectors go back with the mesh's sharding."""
    cfg = HelmholtzConfig(k=5.0, M_subd=8, W_subd=4, OL=1, use_cg=0,
                          tol=1e-6, restart=100, gmres_ver="wgmres",
                          dtype="complex128", use_planes=planes, verbose=0)
    res_single = hsolver(cfg)
    mesh = make_mesh()
    res_sharded = hsolver(cfg, mesh=mesh)
    assert res_sharded.converged
    assert res_sharded.iterations == res_single.iterations
    if not planes:       # planes solutions come back as host complex
        assert res_sharded.x.sharding.device_set == set(mesh.devices.flat)
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_single.x),
                               rtol=1e-8, atol=1e-8)


def test_hsolver_wgmres_refuses_multi_process_mesh():
    from types import SimpleNamespace
    mesh = SimpleNamespace(devices=np.array(
        [SimpleNamespace(process_index=i) for i in range(2)]))
    cfg = HelmholtzConfig(k=5.0, M_subd=2, W_subd=4, OL=1,
                          gmres_ver="wgmres", verbose=0)
    with pytest.raises(ValueError, match="multiple processes"):
        hsolver(cfg, mesh=mesh)


def test_hsolver_sharded_planes_matches_unsharded():
    """The two-plane f32 configuration sharded over 8 devices."""
    cfg = HelmholtzConfig(k=5.0, M_subd=8, W_subd=4, OL=1, use_cg=2,
                          cg_max_it=150, tol=1e-6, restart=60,
                          dtype="complex64", use_planes=True, verbose=0)
    res_single = hsolver(cfg)
    res_sharded = hsolver(cfg, mesh=make_mesh())
    assert res_sharded.converged
    assert res_sharded.iterations == res_single.iterations
    np.testing.assert_allclose(np.asarray(res_sharded.x),
                               np.asarray(res_single.x),
                               rtol=1e-5, atol=1e-5)
