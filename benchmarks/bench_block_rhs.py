"""Block (multi-RHS) scaling benchmark on the GPU -- report Fig. 6 parity
on the complex helm_fem problem.

The reference shows block CG GFLOPS rising with the number of simultaneous
RHS (m_t1: ~40 GFLOPS at b=20, capped at b=47 by GPU local memory,
report SV).  This sweeps b on helm_fem (n = 128^2, complex) through the
stencil container in native complex64.

    python benchmarks/bench_block_rhs.py [--iters 1000]     # on the GPU
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import (cg_gflops, cg_program, emit, require_gpu,  # noqa: E402
                    time_call)

BS = (1, 2, 4, 8, 16, 32, 48, 64)


def main():
    from tpcg.problems import helm_fe, plane_wave_rhs
    device = require_gpu()
    iters = 1000
    if "--iters" in sys.argv:
        iters = int(sys.argv[sys.argv.index("--iters") + 1])
    N, k = 128, 12.0
    A = helm_fe(N, k, eps=k, dtype=np.complex64)
    nnz = int(np.count_nonzero(np.asarray(A.coef)))
    n = N * N
    b0 = plane_wave_rhs(N, k).reshape(n, 1)
    for b in BS:
        B = (b0 * (1.0 + 0.1 * np.arange(b))[None]).astype(np.complex64)
        fn, args = cg_program(A, B, iters)
        dt = time_call(fn, *args)
        agg = cg_gflops(n, nnz, iters, dt, True, nrhs=b)
        emit({"case": "helm_fem-block", "b": b, "iterations": iters,
              "solve_s": dt, "gflops_aggregate": agg,
              "gflops_per_rhs": agg / b, "device": device})


if __name__ == "__main__":
    main()
