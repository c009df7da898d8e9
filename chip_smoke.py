"""Smoke run of the solver stack on the GPU, checked against the oracles.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only, on four cards

Runs the main path once per entry point, at the sizes users call, in one
process, and checks every result against the float64 NumPy/scipy oracles
(``tpcg.reference``, scipy).  Any failed check raises; nothing is caught.

1. ``tpcg.cg``, real banded: the m_t1-class stand-in (n = 97,578,
   101 diagonals, ~9.85M nnz), 4 RHS, 500 iterations.
2. ``tpcg.cg_matrix``, real unstructured: n = 97,578, ~100 nnz/row; RCM
   finds no band, so the ``EllMatrix`` gather path runs.  200 iterations.
3. ``tpcg.cg_matrix``, complex: helm_fem (n = 16,384, 5,000 iterations,
   the reference's Fig. 5 protocol) and the mhd1280b-class band
   (n = 1,280, 5,000 iterations).
4. ``plan_stencil_cg`` on a 2048 x 2048 Helmholtz grid (4.2M complex
   nodes) at k = 640, about 20 grid points per wavelength, 500
   iterations: constant coefficients, and the reference's variable wave
   speed (the "1/3 island" of ``island_wave_speed``, speed 2 inside).
5. ``python -m tpcg.cli helmholtz 2 34 0,2 256`` and ``4 34 2 256``: the
   reference's distributed protocol (``p_h-PY_C-CL-multi-GPU.py:3607,
   3639-3675``) through the CLI entry point, plus the dense-LU subdomain
   solve checked against scipy.
6. (``--four-cards``) ``helmholtz 4 34 6 256`` sharded over a 4-card mesh
   against the same configuration unsharded on one card, with the time
   per FGMRES iteration of a second solve on each.

Tolerances, each printed beside its observed value:

* residual histories (phases 1-4) vs the float64 oracle over the first
  100 iterations: at most 1e-2 relative (float32 arithmetic summed in
  another order).  Compared while the oracle's residual is at least 1e-4
  of its start (``HISTORY_FLOOR``): below that, float32 rounding of the
  recurrence (about 6e-8 of the starting residual, amplified by the
  iteration) is a visible share of what is compared.  The fast-converging
  CSR problems of phases 1-3 (mhd1280b-class: 2 points, unstructured: 3,
  banded: 8) leave few points above the floor; their solutions are held
  by the true-residual bound below;
* phase 4's solution after those 100 iterations vs the oracle's: at most
  1e-2 relative (the history's reason; on the CPU backend the solution
  gap runs at about half the history gap).  Over the full 500 iterations
  the float64 COCG residual on these grids grows, so the final-residual
  bound below is printed but does not constrain x in phase 4;
* final true residual ||b - A x|| / ||b|| in float64 on the host, per
  RHS: at most the largest of 2 x the oracle's at the same iteration,
  1e-5, and sqrt(k) eps32 || |A| |x| || / ||b|| for k iterations -- the
  float32 floor: rounding x alone leaves eps32 || |A| |x| ||, and the
  rounding of k iterations accumulates like a random walk.  On helm_fem
  (|A| |x| is 316 ||b||) that floor is 1.3e-3; the float32 solve's
  residual there is about 1.5e-4 on the CPU backend;
* distributed solves (phase 5): FGMRES converges, its iteration count is
  within +-2 of a CPU run of the same configuration (float32 sums in
  another order move the step at which the residual estimate crosses the
  tolerance), and the float64 host residual of the solution is at most
  tol x ||r0|| + 2 eps32 || |A| |x| ||: the second term is twice what
  rounding the solution to float32 alone can leave.

Exits non-zero, printing no result, when JAX finds no GPU.  The last line
is ``{"ok": true, "device": {...}}``.
"""
import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np

# FGMRES iterations of the phase-5/6 configurations on the CPU backend
# (native complex64, fgmres_chunk=1), from one CPU run of
# ``tpcg.cli.run_helmholtz``.
CPU_ITERATIONS = {(2, 34, 0): 8, (2, 34, 2): 8, (4, 34, 2): 18,
                  (4, 34, 6): 18}
ITERATION_BAND = 2
HISTORY_TOL = 1e-2
HISTORY_WINDOW = 100
HISTORY_FLOOR = 1e-4
X_WINDOW_TOL = 1e-2
RESIDUAL_FLOOR = 1e-5
EPS32 = 2.0 ** -24            # float32 unit roundoff
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def report(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def timed_twice(fn):
    """Run ``fn`` twice (the first call compiles); return the second
    call's result and wall time.  ``fn`` returns host arrays, so the
    device work has finished when it returns."""
    fn()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_history(phase, h, h_ref):
    """Residual histories (iters+1[, nrhs]) against the float64 oracle."""
    h = np.asarray(h, np.float64).reshape(len(h), -1)
    h_ref = np.asarray(h_ref, np.float64).reshape(len(h_ref), -1)
    k = min(HISTORY_WINDOW, len(h_ref) - 1) + 1
    hd, hr = h[:k], h_ref[:k]
    if not np.all(np.isfinite(hd)):
        raise AssertionError(f"{phase}: non-finite residual history")
    mask = hr >= HISTORY_FLOOR * hr[0]
    rel = np.abs(hd - hr)[mask] / hr[mask]
    gap = float(rel.max())
    if gap > HISTORY_TOL:
        raise AssertionError(f"{phase}: history gap {gap:.3e} > "
                             f"{HISTORY_TOL}")
    return gap, int(mask.sum())


def true_residual(A64, B, X):
    """Per-RHS ||b - A x|| / ||b|| in float64."""
    B = np.asarray(B, np.complex128).reshape(A64.shape[0], -1)
    X = np.asarray(X, np.complex128).reshape(A64.shape[0], -1)
    return (np.linalg.norm(B - A64 @ X, axis=0)
            / np.linalg.norm(B, axis=0))


def oracle(A64, B64, iters):
    """float64 COCG oracle: per-RHS (true residual at ``iters``,
    float32 floor), and the residual history."""
    from tpcg import reference
    x, hist = reference.cg(A64, B64, n_iterations=iters,
                           record_history=True)
    if not np.all(np.isfinite(hist)):
        raise AssertionError("oracle history is not finite")
    X = x.reshape(A64.shape[0], -1)
    B = B64.reshape(A64.shape[0], -1)
    scale = (np.linalg.norm(abs(A64) @ abs(X), axis=0)
             / np.linalg.norm(B, axis=0))
    floor = np.sqrt(iters) * EPS32 * scale
    return true_residual(A64, B64, x), floor, hist


def check_solve(phase, A64, B, X, hist, oracle_future, iters, dt):
    res_ref, floor, h_ref = oracle_future.result()
    gap, compared = check_history(phase, hist, h_ref)
    res = true_residual(A64, B, X)
    bound = np.maximum(np.maximum(2.0 * res_ref, RESIDUAL_FLOOR), floor)
    if not np.all(res <= bound):
        raise AssertionError(f"{phase}: true residual {res} > {bound}")
    report(phase, iterations=iters, second_call_s=dt,
           history_gap=gap, history_tol=HISTORY_TOL,
           history_points=compared, true_residual=res.tolist(),
           oracle_true_residual=res_ref.tolist(),
           residual_bound=bound.tolist())


def points_per_wavelength_k(N, ppw=20):
    """Wavenumber at which an N x N grid on the unit square resolves a
    wavelength with ``ppw`` grid points (640 at N = 2048).  Far
    over-resolved grids are not what Helmholtz users run, and there the
    unconjugated COCG residual passes close to zero early on, where a
    relative history comparison is meaningless."""
    return float(round(2 * np.pi * (N - 1) / ppw / 10) * 10)


def problems(pool):
    """Build every phase 1-4 problem on the host and start its oracle."""
    from benchmarks.bench_fig5 import banded_complex, banded_real
    from benchmarks.bench_general_sparse import random_spd
    from tpcg import reference
    from tpcg.parallel import island_wave_speed
    from tpcg.problems import helm_fe, helm_fe_var, plane_wave_rhs

    rng = np.random.default_rng(SEED)
    out = {}

    def add(name, A_host, B, iters, **kw):
        A64 = A_host.astype(np.complex128 if np.iscomplexobj(B)
                            or np.iscomplexobj(A_host.data)
                            else np.float64).tocsr()
        B64 = np.asarray(B).astype(A64.dtype)
        out[name] = dict(B=B, iters=iters, A64=A64,
                         oracle=pool.submit(oracle, A64, B64, iters), **kw)
        if "stencil" in kw:
            out[name]["window_oracle"] = pool.submit(
                reference.cg, A64, B64, n_iterations=HISTORY_WINDOW)

    n = 97578
    A = banded_real(n, tuple(range(0, 51)), seed=SEED)
    add("1-cg-real-banded", A, rng.standard_normal((n, 4))
        .astype(np.float32), 500, A=A)
    A = random_spd(n, 50, seed=SEED + 1).astype(np.float32)
    add("2-cg_matrix-real-unstructured", A, rng.standard_normal(n)
        .astype(np.float32), 200, A=A)
    N, k = 128, 12.0
    A = helm_fe(N, k, eps=k, dtype=np.complex64).to_scipy()
    add("3-cg_matrix-helm_fem", A, plane_wave_rhs(N, k).reshape(-1)
        .astype(np.complex64), 5000, A=A)
    A = banded_complex(1280, tuple(range(0, 9)), seed=SEED + 2) \
        .astype(np.complex64)
    add("3-cg_matrix-mhd1280b", A, np.ones(1280, np.complex64), 5000, A=A)
    N = 2048
    k = points_per_wavelength_k(N)
    b = plane_wave_rhs(N, k).astype(np.complex64)
    S = helm_fe(N, k, eps=k, dtype=np.complex64)
    add("4-plan_stencil_cg-const", S.to_scipy(), b.reshape(-1), 500,
        stencil=S, grid_b=b)
    C = island_wave_speed(N, 3, 2.0, 1.0)
    S = helm_fe_var(N, k, C, rho=0.05, dtype=np.complex64)
    add("4-plan_stencil_cg-var", S.to_scipy(), b.reshape(-1), 500,
        stencil=S, grid_b=b)
    return out


def phase_csr(name, p):
    import tpcg
    A, B, iters = p["A"], p["B"], p["iters"]
    n = A.shape[0]
    nrhs = B.shape[1] if B.ndim == 2 else 1
    if name.startswith("1-"):
        packed = B.T.reshape(-1)                   # column-major RHS
        (x, hist), dt = timed_twice(lambda: tpcg.cg(
            n, A.nnz, A.data, packed, A.indptr, A.indices, n_rhs=nrhs,
            n_iterations=iters, record_history=True))
    else:
        (x, hist), dt = timed_twice(lambda: tpcg.cg_matrix(
            A, B, n_iterations=iters, record_history=True))
    X = np.asarray(x).reshape(nrhs, n).T
    check_solve(name, p["A64"], B, X, hist, p["oracle"], iters, dt)


def phase_stencil(name, p):
    """The planner's solve as in ``check_solve``, and its solution after
    ``HISTORY_WINDOW`` iterations against the oracle's: over 500
    iterations the float64 COCG residual on these grids grows rather
    than falls, so the final-residual bound does not constrain x there."""
    from tpcg import plan_stencil_cg
    plan = plan_stencil_cg(p["stencil"], p["iters"])
    (x, hist), dt = timed_twice(lambda: plan.solve(p["grid_b"]))
    phase = f"{name}[{plan.path}]"
    check_solve(phase, p["A64"], p["B"], x.reshape(-1), hist, p["oracle"],
                p["iters"], dt)
    xw, _ = plan_stencil_cg(p["stencil"], HISTORY_WINDOW).solve(p["grid_b"])
    xw_ref = p["window_oracle"].result()
    gap = float(np.linalg.norm(xw.reshape(-1) - xw_ref)
                / np.linalg.norm(xw_ref))
    if not gap <= X_WINDOW_TOL:
        raise AssertionError(f"{phase}: solution after {HISTORY_WINDOW} "
                             f"iterations {gap:.3e} from the oracle's > "
                             f"{X_WINDOW_TOL}")
    report(f"{phase}-x@{HISTORY_WINDOW}", x_gap=gap, x_tol=X_WINDOW_TOL)


def helmholtz_checks(argv, results):
    """FGMRES convergence, iteration count and float64 true residual of
    every ``run_helmholtz`` result."""
    from tpcg.problems import helm_fe, plane_wave_rhs
    m_s, w_s = int(argv[0]), int(argv[1])
    out = {}
    for mode, res in results:
        if isinstance(res, Exception):
            raise res
        if not res.converged:
            raise AssertionError(f"helmholtz {argv} UseCG={mode} did not "
                                 "converge")
        want = CPU_ITERATIONS[(m_s, w_s, mode)]
        if abs(res.iterations - want) > ITERATION_BAND:
            raise AssertionError(
                f"helmholtz {argv} UseCG={mode}: {res.iterations} "
                f"iterations, CPU run {want} (band {ITERATION_BAND})")
        N = res.decomp.part.N
        xg = res.decomp.to_global(np.asarray(res.x).astype(np.complex128),
                                  check=False).reshape(-1)
        A = helm_fe(N, 20.0, eps=20.0).to_scipy()
        b = plane_wave_rhs(N, 20.0).reshape(-1)
        r0 = np.linalg.norm(b - A @ np.ones_like(xg))
        res64 = np.linalg.norm(b - A @ xg)
        bound = 1e-6 * r0 + 2 * EPS32 * np.linalg.norm(abs(A) @ abs(xg))
        if not res64 <= bound:
            raise AssertionError(f"helmholtz {argv} UseCG={mode}: true "
                                 f"residual {res64:.3e} > {bound:.3e}")
        report(f"5-helmholtz {' '.join(argv)} UseCG={mode}",
               iterations=res.iterations, cpu_iterations=want,
               iteration_band=ITERATION_BAND, wall_s=res.wall_time,
               time_per_it_s=res.time_per_it, true_residual=float(res64),
               residual_bound=float(bound), r0=float(r0))
        out[mode] = res
    return out


def check_dense_lu():
    """The UseCG=0 subdomain solve (a device LU) against scipy."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg
    from tpcg.parallel import Decomposition, SchwarzPrec, make_partition
    from tpcg.parallel.hsolver import build_preconditioner
    from tpcg.utils.config import HelmholtzConfig

    cfg = HelmholtzConfig(k=20.0, M_subd=2, W_subd=34, OL=16, use_cg=0)
    decomp = Decomposition(make_partition(cfg.M_subd, cfg.W_subd,
                                          cfg.overlap))
    P = build_preconditioner(cfg, decomp)
    planes = cfg.use_planes
    sp = SchwarzPrec(decomp, P, method="dense_lu", planes=planes)
    M, S = decomp.part.M, decomp.part.sdsz
    rng = np.random.default_rng(SEED)
    z = (rng.standard_normal((M, M, S, S))
         + 1j * rng.standard_normal((M, M, S, S))).astype(np.complex64)
    zin = (jnp.asarray(np.stack([z.real, z.imag])) if planes
           else jnp.asarray(z))
    got = np.asarray(jax.jit(sp.subdomain_solve)(zin))
    if planes:
        got = got[0] + 1j * got[1]
    dense = P.to_scipy().toarray().astype(np.complex128)
    want = scipy.linalg.solve(dense, z.reshape(M * M, S * S).T
                              .astype(np.complex128)).T.reshape(z.shape)
    gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    cond = float(np.linalg.cond(dense))
    # float32 LU is backward stable: the forward error is at most a
    # modest multiple of eps32 x cond(P)
    tol = max(1e-5, 10 * EPS32 * cond)
    if gap > tol:
        raise AssertionError(f"dense LU vs scipy: {gap:.3e} > {tol:.3e}")
    report("5-dense-lu-vs-scipy", rel_gap=gap, tol=tol, cond=cond,
           planes=planes)


def one_card():
    from tpcg.cli import run_helmholtz
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        probs = problems(pool)
        for name, p in probs.items():
            if "stencil" in p:
                phase_stencil(name, p)
            else:
                phase_csr(name, p)
    for argv in (["2", "34", "0,2", "256"], ["4", "34", "2", "256"]):
        rc, results = run_helmholtz(argv)
        if rc != 0:
            raise AssertionError(f"helmholtz {argv} exited {rc}")
        helmholtz_checks(argv, results)
    check_dense_lu()


def four_cards():
    import jax
    from tpcg.cli import run_helmholtz
    from tpcg.parallel import hsolver
    from tpcg.parallel.multihost import global_mesh
    from tpcg.utils.config import HelmholtzConfig
    if len(jax.devices()) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX found "
                         f"{len(jax.devices())}")
    argv = ["4", "34", "6", "256"]
    rc, results = run_helmholtz(argv)
    if rc != 0:
        raise AssertionError(f"helmholtz {argv} exited {rc}")
    sharded = helmholtz_checks(argv, results)[6]
    cfg = HelmholtzConfig(k=20.0, M_subd=4, W_subd=34, OL=16, use_cg=6,
                          cg_max_it=256, verbose=0)
    # second solves, compiled programs reused: the steady-state time per
    # FGMRES iteration on the mesh and on one card
    mesh_again = hsolver(cfg, mesh=global_mesh(m_subd=4))
    hsolver(cfg)
    single = hsolver(cfg)
    xs, x1 = np.asarray(sharded.x), np.asarray(single.x)
    gap = float(np.abs(xs - x1).max() / np.abs(x1).max())
    if single.iterations != sharded.iterations or gap > 1e-4:
        raise AssertionError(
            f"4-card mesh vs one card: {sharded.iterations} vs "
            f"{single.iterations} iterations, solution gap {gap:.3e}")
    report("6-four-cards-vs-one", iterations=sharded.iterations,
           one_card_iterations=single.iterations, solution_gap=gap,
           solution_tol=1e-4, mesh_wall_s=mesh_again.wall_time,
           mesh_time_per_it_s=mesh_again.time_per_it,
           one_card_wall_s=single.wall_time,
           one_card_time_per_it_s=single.time_per_it)


def main(argv):
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev.platform!r}")
    from tpcg.backend import use_compile_cache
    use_compile_cache()
    if "--four-cards" in argv:
        four_cards()
    else:
        one_card()
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
