"""Distributed ORAS/FGMRES Helmholtz solve over a device mesh.

The multi-chip configuration of the solver: M x M subdomains sharded over
a 1-D mesh (the reference's MPI ranks + per-rank GPUs,
``p_h-PY_C-CL-multi-GPU.py`` ``__main__``).  Run on any number of devices:

  # 8 virtual CPU devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python examples/distributed_helmholtz.py --cpu

  # every GPU of the machine:
  python examples/distributed_helmholtz.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import jax
    if "--cpu" in argv:
        jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh
    from tpcg.parallel import hsolver, Counter
    from tpcg.utils.config import HelmholtzConfig

    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].platform}")

    m_subd = n_dev if n_dev > 1 else 2
    cfg = HelmholtzConfig(k=10.0, M_subd=m_subd, W_subd=8,
                          use_cg=2, cg_max_it=128, tol=1e-6, restart=100,
                          verbose=0)
    mesh = Mesh(np.array(jax.devices()), ("sd",)) if n_dev > 1 else None

    counter = Counter(verbose=10)
    res = hsolver(cfg, mesh=mesh, callback=counter)
    print(f"converged={res.converged} iterations={res.iterations} "
          f"true residual={res.true_residual:.3e} "
          f"wall={res.wall_time:.2f}s per-it={res.time_per_it:.4f}s")
    # reassemble + verify overlap consistency (check_nd_* invariant)
    x_glob = res.decomp.to_global(np.asarray(res.x), check=True, tol=1e-4)
    print("global solution grid:", x_glob.shape,
          "max |x| =", float(np.abs(x_glob).max()))


if __name__ == "__main__":
    main()
