"""General-sparse CG benchmark on the GPU -- the Matrix Market ingestion
class.

The reference's best case is m_t1 (n=97,578, nnz=9.75M, ~100 nnz/row,
structural-mechanics FE): 7.899 GFLOPS on the RTX 2080S (report Fig. 5).
Synthetic stand-ins of the same size class, through
``tpcg.to_device_matrix(reorder=True)`` as ``tpcg.cg`` converts them:

  * banded          : 101-diagonal SPD band -> DiaMatrix (shift-multiply)
  * shuffled-rcm    : the same band with its nodes shuffled; RCM recovers
                      the band -> DiaMatrix
  * random          : unstructured SPD, ~100 nnz/row -> EllMatrix (gather)

Real f32, 200 CG iterations, reference FLOP accounting (2*nnz + 10*n).

    python benchmarks/bench_general_sparse.py     # on the GPU
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import (cg_gflops, cg_program, emit, require_gpu,  # noqa: E402
                    time_call)


def banded_spd(n, half_band_diags, seed=0):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    offs = [0] + [d for k in range(1, half_band_diags + 1)
                  for d in (k * 37, -k * 37)]
    rows, cols, vals = [], [], []
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        v = (rng.standard_normal(len(i)) * 0.1 if off else
             np.full(len(i), float(2 * half_band_diags + 2)))
        rows.append(i); cols.append(i + off); vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return (A + A.T) * 0.5 + sp.eye(n) * (2 * half_band_diags + 2)


def random_spd(n, per_row, seed=1):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, size=n * per_row)
    vals = rng.standard_normal(n * per_row) * 0.05
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T) * 0.5
    return A + sp.eye(n) * (per_row * 0.5)


def main():
    import scipy.sparse as sp
    from tpcg import to_device_matrix
    device = require_gpu()
    n, iters = 97578, 200
    Ab = banded_spd(n, 50).astype(np.float32)
    rng = np.random.default_rng(3)
    p = rng.permutation(n)
    Pm = sp.csr_matrix((np.ones(n, np.float32), (np.arange(n), p)),
                       shape=(n, n))
    cases = (("banded", Ab),
             ("shuffled-rcm", sp.csr_matrix(Pm @ Ab @ Pm.T)),
             ("random", random_spd(n, 50).astype(np.float32)))
    for tag, A in cases:
        M, _ = to_device_matrix(A, reorder=True)
        fn, args = cg_program(M, np.ones(n, np.float32), iters, False)
        dt = time_call(fn, *args)
        emit({"case": tag, "n": n, "nnz": int(A.nnz), "iterations": iters,
              "container": type(M).__name__, "solve_s": dt,
              "gflops": cg_gflops(n, A.nnz, iters, dt, False),
              "device": device})


if __name__ == "__main__":
    main()
