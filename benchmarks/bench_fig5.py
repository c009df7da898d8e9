"""Reference Fig. 5 suite on the GPU: CG GFLOPS on synthetic analogues of
all five report matrices (report Table I / Fig. 5, RTX 2080S numbers).

SuiteSparse files are not shipped with the repository, so each case is a
synthetic matrix of the same size class, nnz/row profile and structure
family:

  1138_bus      real SPD n=1,138 nnz~4k, irregular graph  -> ELL gather
  m_t1          real SPD n=97,578 nnz~9.8M, ~100/row band -> DIA
  parabolic_fem real SPD n=525,625 nnz~3.7M, 7/row FE     -> 2-D stencil
  mhd1280b      complex n=1,280 nnz~23k, ~18/row band     -> DIA
  helm_fem      complex n=16,384 = 128^2 Helmholtz FE     -> 2-D stencil

Protocol follows the report: 5000 CG iterations (200 for the big ones),
single RHS, f32/c64, FLOP accounting per report Table II.  Containers come
from ``tpcg.to_device_matrix`` (RCM included) or ``tpcg.problems``; complex
cases run in native complex64.

    python benchmarks/bench_fig5.py     # on the GPU
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import (cg_gflops, cg_program, emit, require_gpu,  # noqa: E402
                    time_call)

REF = {  # report Fig. 5, RTX 2080S, this-impl series
    "1138_bus": 0.033,
    "m_t1": 7.899,
    "parabolic_fem": 4.884,
    "mhd1280b": 0.381,
    "helm_fem": 2.390,
}


def irregular_spd(n, per_row, seed=0):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    nnz = int(n * per_row)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) * 0.1
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = (A + A.T) * 0.5
    return (A + sp.eye(n) * (per_row + 2.0)).astype(np.float32)


def banded_real(n, offsets, seed=0):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        v = (np.full(len(i), float(2 * len(offsets))) if off == 0
             else rng.standard_normal(len(i)) * 0.1)
        rows.append(i); cols.append(i + off); vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return ((A + A.T) * 0.5 + sp.eye(n) * len(offsets)).astype(np.float32)


def banded_complex(n, offsets, seed=0):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        v = ((rng.standard_normal(len(i))
              + 1j * rng.standard_normal(len(i))) * 0.1
             if off else np.full(len(i), 2.0 * len(offsets) + 0.5j))
        rows.append(i); cols.append(i + off); vals.append(v)
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return (A + A.T) * 0.5  # complex-symmetric (COCG territory)


def parabolic_stencil(Ng=725):
    """7-point FE stencil on an Ng x Ng grid (parabolic_fem class: min 3
    / avg 6.99 / max 7 nnz per row, report Table I)."""
    from tpcg.sparse import Stencil2D
    offs = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-1, -1))
    coef = np.empty((7, Ng, Ng), np.float32)
    coef[0] = 8.0
    coef[1:] = -1.0
    # zero the taps that leave the grid (the assembly convention)
    coef[1][:, -1] = 0
    coef[2][:, 0] = 0
    coef[3][-1, :] = 0
    coef[4][0, :] = 0
    coef[5][-1, :] = 0
    coef[5][:, -1] = 0
    coef[6][0, :] = 0
    coef[6][:, 0] = 0
    return Stencil2D(offs, coef, (Ng, Ng))


def cases():
    """(tag, container, rhs, nnz, iterations, is_complex) per class."""
    from tpcg import to_device_matrix
    from tpcg.problems import helm_fe, plane_wave_rhs
    A = irregular_spd(1138, 3.56, seed=0)
    yield "1138_bus", to_device_matrix(A, reorder=True)[0], \
        np.ones(1138, np.float32), A.nnz, 5000, False
    A = banded_real(97578, tuple(range(0, 51)), seed=0)
    yield "m_t1", to_device_matrix(A), np.ones(97578, np.float32), \
        A.nnz, 200, False
    S = parabolic_stencil()
    yield "parabolic_fem", S, np.ones(S.n, np.float32), \
        int(np.count_nonzero(S.coef)), 200, False
    A = banded_complex(1280, tuple(range(0, 9)), seed=2) \
        .astype(np.complex64)
    yield "mhd1280b", to_device_matrix(A), np.ones(1280, np.complex64), \
        A.nnz, 5000, True
    S = helm_fe(128, 12.0, eps=12.0, dtype=np.complex64)
    yield "helm_fem", S, plane_wave_rhs(128, 12.0).reshape(-1) \
        .astype(np.complex64), int(np.count_nonzero(S.coef)), 5000, True


def main():
    device = require_gpu()
    for tag, A, b, nnz, iters, cplx in cases():
        fn, args = cg_program(A, b, iters)
        dt = time_call(fn, *args)
        gf = cg_gflops(A.shape[0], nnz, iters, dt, cplx)
        emit({"case": tag, "n": A.shape[0], "nnz": int(nnz),
              "iterations": iters, "solve_s": dt, "gflops": gf,
              "ref_gflops": REF[tag], "container": type(A).__name__,
              "device": device})


if __name__ == "__main__":
    main()
