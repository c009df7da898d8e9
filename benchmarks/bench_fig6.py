"""Reference Fig. 6 analogue on the GPU: RHS-block scaling on the m_t1
class.

The reference's block-CG experiment (report Fig. 6 / SV) scales the RHS
block on m_t1 from b=1 to b=20 (rising to ~40 GFLOPS aggregate) and
documents a resource cliff at b=47 (register/occupancy exhaustion on the
RTX 2080S).  This sweep runs the same block sizes through ``block_cg`` on
the DIA container ``tpcg.to_device_matrix`` builds for the m_t1
stand-in: one SpMV per iteration for all b columns.

200 iterations, per-RHS and aggregate GFLOPS per report Table II (real:
2*nnz + 10*n).

    python benchmarks/bench_fig6.py     # on the GPU
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_general_sparse import banded_spd  # noqa: E402
from common import (cg_gflops, cg_program, emit, require_gpu,  # noqa: E402
                    time_call)

ITERS = 200
BS = (1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 47)
REF_B1 = 7.899     # report Fig. 5 m_t1 single-RHS GFLOPS
REF_PEAK = 40.0    # report Fig. 6 peak aggregate GFLOPS (b~20)


def main():
    from tpcg import to_device_matrix
    device = require_gpu()
    n = 97578
    A = banded_spd(n, 50).astype(np.float32)
    M = to_device_matrix(A)
    rng = np.random.default_rng(0)
    for b in BS:
        B = (1.0 + 0.01 * rng.standard_normal((n, b))).astype(np.float32)
        fn, args = cg_program(M, B, ITERS, False)
        dt = time_call(fn, *args)
        agg = cg_gflops(n, A.nnz, ITERS, dt, False, nrhs=b)
        emit({"case": "m_t1-block", "b": b, "iterations": ITERS,
              "solve_s": dt, "gflops_aggregate": agg,
              "gflops_per_rhs": agg / b, "ref_b1": REF_B1,
              "ref_peak": REF_PEAK, "device": device})


if __name__ == "__main__":
    main()
