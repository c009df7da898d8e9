"""Command-line drivers.

``python -m tpcg.cli cg <matrix.mtx> <nRHS> <isComplex> <nIterations>``
    ==  the C CLI (``main.c:13-61``): load a Matrix Market file (symmetric
    expansion included), build B with per-RHS constant ``(r+1)*5.0`` and
    X0 = 0, run the fixed-iteration block CG, report timing and the final
    residual per RHS.

``python -m tpcg.cli helmholtz <M_s> <W_s> <UseCG> [CGMaxIT]``
    ==  the big scripts' ``__main__`` tails
    (``p_h-PY_C-CL-multi-GPU.py:3637-3731``): k=20, epsilon=k, impedance
    subdomain blocks, OL=(W_s-2)/2, sweep the requested sub-solver
    variants through ``HSolver``, print total and per-iteration times, and
    persist ``output_{M_s}_{W_s}_{CGMaxIT}.txt``.  Pass a comma list as
    UseCG (e.g. ``0,2,5``) to sweep several variants like
    ``p_h-PY_C-CL.py``'s ``cgs=[0,1,2,5]`` (:3622); failures are recorded
    as 0 like the reference (:3715-3718), and the exit code is 1 when any
    requested variant raised.  ``--multihost`` joins a
    jax.distributed job (COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID env) and runs mesh-sharded over every host's devices --
    the analogue of the reference's ``mpirun`` launch
    (``p_helmholtz.py:7``; see ``tpcg/parallel/multihost.py``).
"""
from __future__ import annotations

import sys
import time

import numpy as np

USECG_BANNERS = {
    0: "=== Using EXACT SubSolves!",
    1: "=== Using {it} iterations of device block-CG (single-RHS "
       "semantics)!",
    2: "=== Using {it} iterations of device block-CG with Multiple RHS "
       "SubSolves!",
    5: "=== Using {it} iterations of NumPy-CG SubSolves!",
    6: "=== Using {it} iterations of device block-CG sharded over the "
       "device mesh!",
}


def run_cg_cli(argv):
    if len(argv) != 4:
        print("Usage: tpcg cg <input matrix file> <number of RHS> "
              "<is complex> <number of iterations>", file=sys.stderr)
        return 1
    path, n_rhs, is_complex, n_iter = (argv[0], int(argv[1]),
                                       int(argv[2]), int(argv[3]))
    from .io import load_matrix_market
    from .api import cg

    try:
        A = load_matrix_market(
            path, dtype=np.complex64 if is_complex else np.float32)
    except FileNotFoundError:
        print(f"Could not read matrix: {path}", file=sys.stderr)
        return 1
    n = A.shape[0]
    print(f"loaded {path}: n={n} nnz={A.nnz} dtype={A.dtype}")
    b = np.zeros(n * n_rhs, dtype=A.dtype)
    for r in range(n_rhs):
        b[r * n:(r + 1) * n] = (r + 1) * 5.0
    t0 = time.time()
    x, hist = cg(n, A.nnz, A.data, b, A.indptr, A.indices, n_rhs=n_rhs,
                 n_iterations=n_iter, record_history=True)
    dt = time.time() - t0
    for r in range(n_rhs):
        print(f"rhs {r}: final residual {hist[-1, r]:.6e}")
    print(f"solve time (incl. compile): {dt:.3f}s")
    return 0


def run_helmholtz(argv):
    """The ``helmholtz`` subcommand.  Returns ``(exit code, results)``
    with one ``(UseCG, HSolverResult or the exception it raised)`` per
    requested variant."""
    multihost = "--multihost" in argv
    argv = [a for a in argv if a != "--multihost"]
    if len(argv) not in (3, 4):
        print("====> please supply arguments: M_s W_s UseCG [CGMaxIT] "
              "[--multihost]", file=sys.stderr)
        return 1, []
    if multihost:
        # The reference launches SPMD via mpirun (p_helmholtz.py:7);
        # here one process per host joins the jax.distributed job and
        # every UseCG mode below runs mesh-sharded over all hosts.
        from .parallel.multihost import initialize_from_env
        initialize_from_env()
    m_s, w_s = int(argv[0]), int(argv[1])
    cgs = [int(v) for v in argv[2].split(",")]
    cg_max_it = int(argv[3]) if len(argv) == 4 else 256

    from .parallel.hsolver import hsolver, Counter
    from .utils.config import HelmholtzConfig
    from .utils.timing import save_sweep_output

    kkk = 20.0
    ol = (w_s - 2) // 2
    print(f"N= {(w_s - 1) * m_s + 1} k= {kkk} M_s= {m_s} W_s= {w_s} "
          f"OL= {ol}")
    print("One-level AS preconditioner")
    print("----> setting epsilon=k^beta: ", kkk)

    times, times_pi, results = [], [], []
    for cg_mode in cgs:
        banner = USECG_BANNERS.get(cg_mode, "=== -- unknown SubSolver!")
        print(banner.format(it=cg_max_it))
        try:
            cfg = HelmholtzConfig(k=kkk, M_subd=m_s, W_subd=w_s, OL=ol,
                                  use_cg=cg_mode, cg_max_it=cg_max_it,
                                  verbose=10)
            counter = Counter(verbose=10)
            # UseCG=6 == the reference's multi-GPU thread fan-out
            # (``p_h-PY_C-CL-multi-GPU.py:2123-2181``): shard the
            # leading subdomain axis over the device mesh (a 1-device
            # mesh is still a mesh, matching the reference's
            # single-GPU degenerate case).  --multihost puts every
            # mode on the global mesh -- except a degenerate 1-device
            # job, which keeps the single-device path.
            if multihost or cg_mode == 6:
                from .parallel.multihost import global_mesh
                mesh = global_mesh(m_subd=m_s)
                if multihost and cg_mode != 6 and mesh.devices.size == 1:
                    mesh = None
            else:
                mesh = None
            t1 = time.time()
            res = hsolver(cfg, mesh=mesh, callback=counter)
            t2 = time.time()
            print("  residual norm:", res.true_residual,
                  " ####it:", res.iterations)
            print("Total time:", t2 - t1, "(", (t2 - t1) / 60, "minutes )")
            tpi = res.time_per_it
            print("Aver. time per iter:", tpi)
            times.append(t2 - t1)
            times_pi.append(tpi)
            results.append((cg_mode, res))
        except Exception as ex:       # sweep keeps going, like :3715-3718
            print(ex)
            times.append(0)
            times_pi.append(0)
            results.append((cg_mode, ex))
    print(times)
    save_sweep_output(m_s, w_s, cg_max_it, times)
    failed = any(isinstance(r, Exception) for _, r in results)
    return (1 if failed else 0), results


def run_helmholtz_cli(argv):
    return run_helmholtz(argv)[0]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "cg":
        return run_cg_cli(rest)
    if cmd == "helmholtz":
        return run_helmholtz_cli(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    print(__doc__)
    return 1


if __name__ == "__main__":
    from .backend import use_compile_cache
    use_compile_cache()
    sys.exit(main())
