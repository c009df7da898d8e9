"""Sparse-matrix containers for the device compute path.

The reference stores everything as CSR and runs a
"vector-CSR" SpMV kernel (one 32-lane wave per row, ``kernel/real/spmv.cl:5-50``).
Here CSR is only the *host interchange* format (scipy); it is converted
once, at setup time, into one of three device formats whose matvec is a
short chain of ``jax.numpy`` operations that XLA fuses:

``DiaMatrix``
    Padded-diagonal storage for banded matrices (every FE/FD problem in the
    reference's suite is <=9-diagonal).  SpMV = sum of statically-shifted
    elementwise multiplies -- zero gathers, one fused pass.

``EllMatrix``
    Padded-row (ELLPACK) storage for general sparse matrices (Matrix Market
    ingestion path, ``main.c:20-33``).  SpMV = L gathers of x + multiply-add,
    where L = max row degree.  Used when the matrix is not (nearly) banded.

``Stencil2D``
    The 2-D grid-stencil operator: coefficient fields over an (Nv, Nh) node
    grid with static (dm, dj) neighbour offsets.  This is the native form our
    Helmholtz/Poisson assembly produces (see ``tpcg/problems``): pure 2-D
    shifts.  Equivalent to DiaMatrix after flattening but keeps the
    geometry for the domain-decomposition layer.

All containers are JAX pytrees (static metadata, array leaves), so they pass
through ``jit``/``vmap``/``shard_map`` transparently.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _shift_rows(x: jnp.ndarray, off: int) -> jnp.ndarray:
    """out[i] = x[i + off] with zero fill outside [0, n).  Static ``off``."""
    if off == 0:
        return x
    n = x.shape[0]
    pad = jnp.zeros((abs(off),) + x.shape[1:], dtype=x.dtype)
    if off > 0:
        return jnp.concatenate([x[off:], pad], axis=0)
    return jnp.concatenate([pad, x[:off]], axis=0)


def _shift2d(x: jnp.ndarray, dm: int, dj: int) -> jnp.ndarray:
    """out[..., m, j] = x[..., m+dm, j+dj] with zero fill (static offsets)."""
    if dm != 0:
        n = x.shape[-2]
        pad = jnp.zeros(x.shape[:-2] + (abs(dm), x.shape[-1]), dtype=x.dtype)
        if dm > 0:
            x = jnp.concatenate([x[..., dm:, :], pad], axis=-2)
        else:
            x = jnp.concatenate([pad, x[..., :dm, :]], axis=-2)
    if dj != 0:
        pad = jnp.zeros(x.shape[:-1] + (abs(dj),), dtype=x.dtype)
        if dj > 0:
            x = jnp.concatenate([x[..., dj:], pad], axis=-1)
        else:
            x = jnp.concatenate([pad, x[..., :dj]], axis=-1)
    return x


@partial(jax.tree_util.register_dataclass,
         data_fields=["data"], meta_fields=["offsets", "n"])
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Row-oriented padded-diagonal matrix.

    ``data[d, i] = A[i, i + offsets[d]]`` (zero where the column falls
    outside ``[0, n)``).  Note this differs from scipy's ``dia_matrix``
    convention (which indexes diagonals by column); ours makes the matvec a
    row-aligned fused multiply-add.
    """
    offsets: Tuple[int, ...]
    data: jnp.ndarray        # (ndiag, n)
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x.  ``x``: (n,) or (n, nrhs)."""
        data = self.data
        if x.ndim > 1:
            data = data.reshape(data.shape + (1,) * (x.ndim - 1))
        y = data[0] * _shift_rows(x, self.offsets[0])
        for d in range(1, len(self.offsets)):
            y = y + data[d] * _shift_rows(x, self.offsets[d])
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def to_scipy(self):
        import scipy.sparse as sp
        rows, cols, vals = [], [], []
        data = np.asarray(self.data)
        for d, off in enumerate(self.offsets):
            i = np.arange(max(0, -off), min(self.n, self.n - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(data[d, i])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=self.shape)

    @staticmethod
    def from_scipy(A, dtype=None) -> "DiaMatrix":
        """Convert any scipy sparse matrix whose nonzeros lie on a small set
        of diagonals (vectorized scatter -- this is the default Matrix
        Market ingestion path, so it must handle 10M+ nnz quickly)."""
        import scipy.sparse as sp
        A = sp.coo_matrix(A)
        n = A.shape[0]
        d = A.col - A.row
        offs = np.unique(d)
        data = np.zeros((len(offs), n), dtype=dtype or A.dtype)
        d_idx = np.searchsorted(offs, d)
        np.add.at(data, (d_idx, A.row), A.data)
        # data stays host-side (numpy): device upload happens on first use,
        # and the complex-planes path splits planes *before* upload
        return DiaMatrix(tuple(int(o) for o in offs), data, n)


@partial(jax.tree_util.register_dataclass,
         data_fields=["cols", "vals"], meta_fields=["n"])
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK: rows padded to the max row degree L.

    ``vals[i, l]`` with column ``cols[i, l]``; padding slots have
    ``vals == 0`` and ``cols`` pointing at row ``i`` itself (in-range, so the
    gather stays well defined -- unlike the reference's unguarded
    ``aPointers[waveId+1]`` read, ``kernel/real/spmv.cl:18``).
    """
    cols: jnp.ndarray        # (n, L) int32
    vals: jnp.ndarray        # (n, L)
    n: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.vals.dtype

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x.  ``x``: (n,) or (n, nrhs)."""
        gathered = jnp.take(x, self.cols, axis=0)   # (n, L[, nrhs])
        vals = self.vals
        if x.ndim > 1:
            vals = vals.reshape(vals.shape + (1,) * (x.ndim - 1))
        return jnp.sum(vals * gathered, axis=1)

    def __matmul__(self, x):
        return self.matvec(x)

    @staticmethod
    def from_scipy(A, dtype=None) -> "EllMatrix":
        import scipy.sparse as sp
        A = sp.csr_matrix(A)
        return EllMatrix.from_csr_arrays(A.shape[0], A.data, A.indptr,
                                         A.indices, dtype=dtype)

    @staticmethod
    def from_csr_arrays(n, a_values, a_pointers, a_cols, dtype=None) -> "EllMatrix":
        """Build from raw CSR arrays -- the ``clcg::cg`` input surface
        (reference ``clcg.h:3-5``).  Vectorized scatter into the padded
        (n, L) layout."""
        a_pointers = np.asarray(a_pointers)
        a_cols = np.asarray(a_cols)
        a_values = np.asarray(a_values)
        deg = np.diff(a_pointers)
        L = max(int(deg.max()), 1)
        nnz = len(a_values)
        rows = np.repeat(np.arange(n), deg)
        lane = np.arange(nnz) - np.repeat(a_pointers[:-1], deg)
        cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, L))
        vals = np.zeros((n, L), dtype=dtype or a_values.dtype)
        cols[rows, lane] = a_cols
        vals[rows, lane] = a_values
        # host-side arrays; see DiaMatrix.from_scipy
        return EllMatrix(cols, vals, n)


@partial(jax.tree_util.register_dataclass,
         data_fields=["coef"], meta_fields=["offsets", "grid"])
@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """2-D grid-stencil operator on an (Nv, Nh) node grid.

    ``coef[s, m, j]`` multiplies ``x[m + dm_s, j + dj_s]`` where
    ``offsets[s] = (dm_s, dj_s)``.  Rows are nodes in the reference's
    lexicographic order ``node = m * Nh + j`` (``helmFE_var.py:107``).
    Batch dims lead: ``x`` may be (Nv, Nh) or (B, Nv, Nh).
    """
    offsets: Tuple[Tuple[int, int], ...]
    coef: jnp.ndarray        # (noff, Nv, Nh)
    grid: Tuple[int, int]    # (Nv, Nh)

    @property
    def n(self):
        return self.grid[0] * self.grid[1]

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.coef.dtype

    def apply_grid(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x with grid-shaped x: (..., Nv, Nh)."""
        y = self.coef[0] * _shift2d(x, *self.offsets[0])
        for s in range(1, len(self.offsets)):
            y = y + self.coef[s] * _shift2d(x, *self.offsets[s])
        return y

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x with flat x: (n,) or (n, nrhs)."""
        nv, nh = self.grid
        if x.ndim == 1:
            return self.apply_grid(x.reshape(nv, nh)).reshape(-1)
        # (n, nrhs) -> (nrhs, Nv, Nh) -> apply -> back
        xg = x.T.reshape(x.shape[1], nv, nh)
        yg = self.apply_grid(xg)
        return yg.reshape(x.shape[1], nv * nh).T

    def __matmul__(self, x):
        return self.matvec(x)

    def to_dia(self) -> DiaMatrix:
        """Flatten to row-major DiaMatrix (offset = dm*Nh + dj), masking the
        horizontal wrap-around so the two forms are exactly equivalent."""
        nv, nh = self.grid
        n = nv * nh
        offs = []
        data = []
        for s, (dm, dj) in enumerate(self.offsets):
            c = np.asarray(self.coef[s]).copy()
            # entries whose horizontal neighbour leaves the grid must vanish;
            # assembly already guarantees this, but enforce for safety.
            if dj > 0:
                c[:, nh - dj:] = 0
            elif dj < 0:
                c[:, : -dj] = 0
            offs.append(dm * nh + dj)
            data.append(c.reshape(-1))
        order = np.argsort(offs)
        return DiaMatrix(tuple(int(offs[i]) for i in order),
                         jnp.asarray(np.stack([data[i] for i in order])), n)

    def to_scipy(self):
        return self.to_dia().to_scipy()


def _dia_worthwhile(A, prefer_dia_band: int) -> bool:
    import scipy.sparse as sp
    coo = sp.coo_matrix(A)
    offs = np.unique(coo.col - coo.row)
    n = A.shape[0]
    return (len(offs) * n <= max(4 * A.nnz, 16 * n)
            and len(offs) <= prefer_dia_band)


def to_device_matrix(A, prefer_dia_band: int = 4096, reorder: bool = False):
    """Pick the device container for a scipy sparse matrix.

    Banded matrices with a modest number of distinct diagonals become
    ``DiaMatrix`` (dense-diagonal storage is worth it when
    ``ndiag * n`` is within ~4x of ``nnz``): shift-and-multiply SpMV, no
    gathers.  Everything else becomes ``EllMatrix`` (gather SpMV).

    ``reorder=True`` additionally tries symmetric reverse-Cuthill-McKee
    reordering to *make* the matrix banded (FE/mesh matrices almost
    always are after RCM) and returns ``(container, perm)`` where perm is
    the row/column permutation applied (``None`` if unpermuted):
    the container represents ``A[perm][:, perm]``, so solve with
    ``b[perm]`` and un-permute the solution.  Dot products and hence CG
    residual histories are permutation-invariant.
    """
    import scipy.sparse as sp
    A = sp.csr_matrix(A)
    if _dia_worthwhile(A, prefer_dia_band):
        M = DiaMatrix.from_scipy(A)
        return (M, None) if reorder else M
    if reorder:
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm]
        if _dia_worthwhile(Ap, prefer_dia_band):
            return DiaMatrix.from_scipy(Ap), perm
        return EllMatrix.from_scipy(A), None
    return EllMatrix.from_scipy(A)
