"""Bring-up measurements on the GPU.

What the solvers' defaults (native complex64, ``fgmres_chunk=1``) and
PERF.md rest on:

* ``repr-*``   : native complex64 against float32 planes -- helm_fem
  through ``cg_matrix`` (n = 16,384, 5,000 iterations; the second call,
  and the device-resident solve alone) and ``hsolver`` at M=2, W=34,
  UseCG=2, CGMaxIT=256;
* ``chunk-*``  : the ``fgmres_chunk`` sweep {1, 4, 8} at M=2, W=34;
* ``wgmres-*`` : ``gmres_ver='wgmres'`` (host complex128 recurrence) at
  M=2, W=34, UseCG=0, against ``fgmres`` in the same process;
* ``class-*``  : the XLA path on each problem class that a removed
  hand-written kernel tier used to serve, at that class's size;
* ``trace-*``  : one profiler trace of a helm_fem solve and of one M=2
  preconditioner application, reduced to kernels, idle share and top
  operations (``tpcg.utils.profiling.device_trace_summary``).

    python benchmarks/bring_up.py [--only PREFIX,...] [--out FILE]

Each measurement prints one JSON line (also appended to ``--out``); a
measurement that raises prints its error and the others still run.
"""
import os
import sys
import tempfile
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import (cg_gflops, cg_program, emit, require_gpu,  # noqa: E402
                    time_call)


def repr_helm_fem():
    import tpcg
    from tpcg.problems import helm_fe, plane_wave_rhs
    N, k, iters = 128, 12.0, 5000
    S = helm_fe(N, k, eps=k, dtype=np.complex64)
    A = S.to_scipy()
    b = plane_wave_rhs(N, k).reshape(-1).astype(np.complex64)
    nnz = int(np.count_nonzero(S.coef))
    for planes in (False, True):
        tpcg.cg_matrix(A, b, n_iterations=iters, planes=planes)
        t0 = time.perf_counter()
        tpcg.cg_matrix(A, b, n_iterations=iters, planes=planes)
        e2e = time.perf_counter() - t0
        M = tpcg.to_device_matrix(A)
        fn, args = cg_program(M, b[:, None], iters, planes)
        dev = time_call(fn, *args)
        yield {"name": "repr-helm_fem-cg_matrix", "planes": planes,
               "iterations": iters, "second_call_s": e2e,
               "device_solve_s": dev, "us_per_iter": dev / iters * 1e6,
               "gflops": cg_gflops(N * N, nnz, iters, dev, True)}


def hsolver_run(planes, chunk, M=2, W=34, use_cg=2, gmres_ver="fgmres"):
    from tpcg.parallel import hsolver
    from tpcg.utils.config import HelmholtzConfig
    cfg = HelmholtzConfig(k=20.0, M_subd=M, W_subd=W, OL=(W - 2) // 2,
                          use_cg=use_cg, cg_max_it=256, verbose=0,
                          use_planes=planes, fgmres_chunk=chunk,
                          gmres_ver=gmres_ver)
    hsolver(cfg)                                    # compile
    res = hsolver(cfg)
    return {"planes": planes, "fgmres_chunk": chunk, "M": M, "W": W,
            "use_cg": use_cg, "gmres_ver": gmres_ver,
            "iterations": res.iterations,
            "converged": bool(res.converged), "wall_s": res.wall_time,
            "s_per_iter": res.wall_time / max(res.iterations, 1),
            "true_residual": res.true_residual,
            "wasted_prec_applies": res.wasted_prec_applies}


def repr_hsolver():
    for planes in (False, True):
        yield {"name": "repr-hsolver", **hsolver_run(planes, 1)}


def chunk_sweep():
    for planes in (False, True):
        for chunk in (1, 4, 8):
            yield {"name": "chunk-hsolver", **hsolver_run(planes, chunk)}


def wgmres_vs_fgmres():
    """UseCG=0: wGMRES updates its preconditioned residual as if the
    preconditioner were linear, which the dense-LU solve is and the
    fixed-iteration subdomain COCG of UseCG=2 is not to float32 accuracy
    (in float32 planes it diverges at this size, a CPU run shows)."""
    for planes in (False, True):
        for ver in ("fgmres", "wgmres"):
            yield {"name": "wgmres-hsolver",
                   **hsolver_run(planes, 1, use_cg=0, gmres_ver=ver)}


def helm_k(N):
    """About 20 grid points per wavelength (chip_smoke.py's rule)."""
    return float(round(2 * np.pi * (N - 1) / 20 / 10) * 10)


def _grid_case(name, S, iters, tier):
    from tpcg.problems import plane_wave_rhs
    cplx = np.iscomplexobj(S.coef)
    N = S.grid[0]
    b = (plane_wave_rhs(N, helm_k(N)).reshape(-1, 1).astype(np.complex64)
         if cplx else np.ones((N * N, 1), np.float32))
    nnz = int(np.count_nonzero(S.coef))
    for planes in ((False, True) if cplx else (False,)):
        fn, args = cg_program(S, b, iters, planes)
        dt = time_call(fn, *args, reps=3)
        yield {"name": name, "removed_tier": tier, "n": N * N, "nnz": nnz,
               "planes": planes, "iterations": iters, "solve_s": dt,
               "us_per_iter": dt / iters * 1e6,
               "gflops": cg_gflops(N * N, nnz, iters, dt, cplx)}


def classes_grids():
    from tpcg.problems import helm_fe, helm_fe_var
    from tpcg.problems.poisson import poisson
    rng = np.random.default_rng(0)
    yield from _grid_case("class-grid-c64-const-512",
                          helm_fe(512, helm_k(512), eps=helm_k(512),
                                  dtype=np.complex64), 2000,
                          "whole-solve resident kernels (vmem-coef / vmem-const)")
    for N, tier in ((1024, "stream v4 const"), (2048, "stream v4 const"),
                    (4096, "stream v5 const")):
        yield from _grid_case(f"class-grid-c64-const-{N}",
                              helm_fe(N, helm_k(N), eps=helm_k(N),
                                      dtype=np.complex64), 200, tier)
    for N, tier in ((1024, "stream-coef v4-sym"),
                    (2048, "stream-coef v4-sym"),
                    (4096, "stream-coef v5-sym")):
        C = 1.0 + 0.5 * rng.random((N - 1, N - 1))
        yield from _grid_case(f"class-grid-c64-var-{N}",
                              helm_fe_var(N, helm_k(N), C, rho=0.05,
                                          dtype=np.complex64), 200, tier)
    for N, tier in ((2048, "stream-real v4-real"),
                    (4096, "stream-real v5-real")):
        yield from _grid_case(f"class-grid-f32-{N}",
                              poisson(N, dtype=np.float32), 200, tier)


def classes_sparse():
    from bench_fig5 import banded_complex, banded_real, irregular_spd
    from bench_general_sparse import random_spd
    from tpcg import to_device_matrix
    cases = (
        ("class-mhd1280b-dia", banded_complex(1280, tuple(range(0, 9)),
                                              seed=2).astype(np.complex64),
         5000, "whole-solve resident banded complex kernel"),
        ("class-m_t1-dia", banded_real(97578, tuple(range(0, 51))),
         200, "banded streaming kernel"),
        ("class-1138_bus-ell", irregular_spd(1138, 3.56), 5000,
         "Benes routing-network SpMV"),
        ("class-random-ell", random_spd(97578, 50).astype(np.float32),
         200, "Benes routing-network SpMV"),
    )
    for name, A, iters, tier in cases:
        M, _ = to_device_matrix(A, reorder=True)
        cplx = np.iscomplexobj(A.data)
        b = np.ones((A.shape[0], 1), A.dtype)
        for planes in ((False, True) if cplx else (False,)):
            fn, args = cg_program(M, b, iters, planes)
            dt = time_call(fn, *args, reps=3)
            yield {"name": name, "removed_tier": tier, "n": A.shape[0],
                   "nnz": int(A.nnz), "container": type(M).__name__,
                   "planes": planes, "iterations": iters, "solve_s": dt,
                   "us_per_iter": dt / iters * 1e6,
                   "gflops": cg_gflops(A.shape[0], A.nnz, iters, dt, cplx)}


def _prec(M, planes):
    """One ORAS preconditioner application at W=34, CGMaxIT=256 (UseCG=2):
    returns (jitted apply, its operands)."""
    import jax
    import jax.numpy as jnp
    from tpcg.parallel import Decomposition, SchwarzPrec, make_partition
    from tpcg.parallel.hsolver import build_preconditioner
    from tpcg.utils.config import HelmholtzConfig
    cfg = HelmholtzConfig(k=20.0, M_subd=M, W_subd=34, OL=16, use_cg=2)
    decomp = Decomposition(make_partition(M, 34, 16))
    sp = SchwarzPrec(decomp, build_preconditioner(cfg, decomp),
                     cg_iterations=256, planes=planes)
    shape = ((2,) if planes else ()) + decomp.grid_shape
    rng = np.random.default_rng(0)
    z = rng.standard_normal(shape).astype(np.float32)
    if not planes:
        z = (z + 1j * rng.standard_normal(shape)).astype(np.complex64)
    fn = jax.jit(lambda pair, z: sp.apply_with(pair, sp._lu, z))
    return fn, (sp._pair, jnp.asarray(z))


def classes_prec():
    for M in (2, 4):
        for planes in (False, True):
            fn, args = _prec(M, planes)
            dt = time_call(fn, *args)
            yield {"name": f"class-prec-M{M}", "planes": planes,
                   "removed_tier": "whole-solve subdomain CG kernel (prec_kernel 'fused')",
                   "cg_iterations": 256, "apply_s": dt}


def traces():
    import jax
    from tpcg.problems import helm_fe, plane_wave_rhs
    from tpcg.utils.profiling import device_trace_summary
    N, k, iters = 128, 12.0, 5000
    S = helm_fe(N, k, eps=k, dtype=np.complex64)
    b = plane_wave_rhs(N, k).reshape(-1, 1).astype(np.complex64)
    for planes in (False, True):
        jobs = (("trace-helm_fem", cg_program(S, b, iters, planes), iters),
                ("trace-prec-M2", _prec(2, planes), 256))
        for name, (fn, args), its in jobs:
            jax.block_until_ready(fn(*args))
            d = tempfile.mkdtemp()
            jax.profiler.start_trace(d)
            jax.block_until_ready(fn(*args))
            jax.profiler.stop_trace()
            s = device_trace_summary(d)
            s["kernels_per_cg_iteration"] = s["device_events"] / its
            yield {"name": name, "planes": planes, "iterations": its, **s}


MEASUREMENTS = (("repr-helm_fem", repr_helm_fem), ("repr-hsolver", repr_hsolver),
                ("chunk", chunk_sweep), ("wgmres", wgmres_vs_fgmres),
                ("class-grid", classes_grids),
                ("class-sparse", classes_sparse), ("class-prec", classes_prec),
                ("trace", traces))


def main(argv):
    device = require_gpu()
    only = None
    if "--only" in argv:
        only = argv[argv.index("--only") + 1].split(",")
    out = argv[argv.index("--out") + 1] if "--out" in argv else None
    emit({"name": "device", **device}, out)
    for prefix, gen in MEASUREMENTS:
        if only and not any(prefix.startswith(o) for o in only):
            continue
        try:
            for rec in gen():
                emit(rec, out)
        except Exception:              # keep measuring the other rows
            emit({"name": prefix, "error": traceback.format_exc()}, out)


if __name__ == "__main__":
    main(sys.argv[1:])
