"""Overlap (halo) exchange and the distributed matvec.

This is the replacement for the reference's MPI layer:

* ``ol_update``  ==  ``OL_update`` (``p_h-PY_C-CL-multi-GPU.py:2183-2497``):
  partition-of-unity overlap-add across up to 8 neighbours, with optional
  Restricted-AS zeroing of the outer ``OL`` ring and contact-line averaging.
* ``ax_op``      ==  ``Ax_op`` (``p_h-PY_C-CL-multi-GPU.py:2500-2746``):
  per-subdomain stencil matvec followed by an overwrite of the outermost
  ring (width 1) with the neighbour's fully-assembled values.
* ``norm`` / ``wdot``  ==  the unique-dof global reductions
  (``p_h-PY_C-CL-multi-GPU.py:2108-2121, 2845-2892``).

Where the reference hand-rolls nonblocking ``Isend/Irecv`` with manual tag
windows and per-direction strt/endt index arithmetic, here every exchange
is a *static shift of the subdomain grid*: state lives in an
``(M, M, S, S)`` array (subdomain row, subdomain col, local row, local
col), neighbour access is a zero-padded shift along the first two axes, and
direction/boundary bookkeeping is precomputed numpy masks.  Under ``jit``
with the leading axis sharded over a mesh, XLA lowers the shifts to
``collective-permute`` between devices and the reductions to ``psum`` -- and
schedules them to overlap with the local stencil compute, which is the
reference's hand-coded comm/compute overlap (``Ax_op`` computing ``A_own``
while messages fly) for free.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np
import jax.numpy as jnp

from .partition import Partition


def _sshift(x: jnp.ndarray, di: int, dj: int) -> jnp.ndarray:
    """out[si, sj] = x[si + di, sj + dj] over the first two (subdomain-grid)
    axes, zero-filled outside."""
    if di != 0:
        pad = jnp.zeros((abs(di),) + x.shape[1:], x.dtype)
        x = (jnp.concatenate([x[di:], pad], 0) if di > 0
             else jnp.concatenate([pad, x[:di]], 0))
    if dj != 0:
        pad = jnp.zeros(x.shape[:1] + (abs(dj),) + x.shape[2:], x.dtype)
        x = (jnp.concatenate([x[:, dj:], pad], 1) if dj > 0
             else jnp.concatenate([pad, x[:, :dj]], 1))
    return x


@dataclasses.dataclass(frozen=True)
class Decomposition:
    """Partition + the precomputed static masks the jitted operators use.

    All masks are host numpy; they become compile-time constants (or
    replicated buffers) inside jitted callers.
    """
    part: Partition

    def __post_init__(self):
        M, S, OL = self.part.M, self.part.sdsz, self.part.OL
        has = {
            "W": np.arange(M) > 0,          # by sj
            "E": np.arange(M) < M - 1,      # by sj
            "S": np.arange(M) > 0,          # by si
            "N": np.arange(M) < M - 1,      # by si
        }
        # strt/endt restriction masks: rows of a W/E strip exclude the OL
        # corner rows when the corresponding corner neighbour exists.
        def restrict(idx_exists_low, idx_exists_high, width):
            # (M, S): per subdomain-grid position, which local indices of a
            # perpendicular strip participate.
            m = np.ones((M, S))
            for s in range(M):
                if idx_exists_low[s]:
                    m[s, :width] = 0.0
                if idx_exists_high[s]:
                    m[s, S - width:] = 0.0
            return m

        row_ol = restrict(has["S"], has["N"], OL)   # (M_si, S) for W/E strips
        col_ol = restrict(has["W"], has["E"], OL)   # (M_sj, S) for N/S strips
        row_1 = restrict(has["S"], has["N"], 1)
        col_1 = restrict(has["W"], has["E"], 1)

        # RAS keep-mask: zero the outer OL ring on sides with neighbours
        # (p_h-PY_C-CL-multi-GPU.py:2336-2392).  Corner blocks are zeroed
        # whenever the corresponding diagonal neighbour exists.
        keep = np.ones((M, M, S, S))
        for si in range(M):
            for sj in range(M):
                r = row_ol[si][:, None]          # (S, 1)
                c = col_ol[sj][None, :]          # (1, S)
                if has["W"][sj]:
                    keep[si, sj, :, :OL] = np.where(r > 0, 0.0,
                                                    keep[si, sj, :, :OL])
                if has["E"][sj]:
                    keep[si, sj, :, S - OL:] = np.where(
                        r > 0, 0.0, keep[si, sj, :, S - OL:])
                if has["S"][si]:
                    keep[si, sj, :OL, :] = np.where(c > 0, 0.0,
                                                    keep[si, sj, :OL, :])
                if has["N"][si]:
                    keep[si, sj, S - OL:, :] = np.where(
                        c > 0, 0.0, keep[si, sj, S - OL:, :])
                if has["S"][si] and has["W"][sj]:
                    keep[si, sj, :OL, :OL] = 0.0
                if has["N"][si] and has["E"][sj]:
                    keep[si, sj, S - OL:, S - OL:] = 0.0
                if has["N"][si] and has["W"][sj]:
                    keep[si, sj, S - OL:, :OL] = 0.0
                if has["S"][si] and has["E"][sj]:
                    keep[si, sj, :OL, S - OL:] = 0.0

        # contact-line averaging factors (2486-2495): col OL / col S-OL-1 /
        # row OL / row S-OL-1 halved where the respective neighbour exists;
        # factors multiply, so corner crossings get 1/4.
        rowf = np.ones((M, S))
        colf = np.ones((M, S))
        for s in range(M):
            if s > 0:
                rowf[s, OL] *= 0.5
                colf[s, OL] *= 0.5
            if s < M - 1:
                rowf[s, S - OL - 1] *= 0.5
                colf[s, S - OL - 1] *= 0.5
        avg = rowf[:, None, :, None] * colf[None, :, None, :]  # (M,M,S,S)

        object.__setattr__(self, "_has", has)
        object.__setattr__(self, "_row_ol", row_ol)
        object.__setattr__(self, "_col_ol", col_ol)
        object.__setattr__(self, "_row_1", row_1)
        object.__setattr__(self, "_col_1", col_1)
        object.__setattr__(self, "_ras_keep", keep)
        object.__setattr__(self, "_avg", avg)
        # unique-dof mask reshaped to the (M, M, S, S) layout
        object.__setattr__(
            self, "_unique",
            self.part.unique_mask.reshape(M, M, S, S))

    # ------------------------------------------------------------------
    def unique_weights(self) -> np.ndarray:
        """Host (M, M, S, S) float64 unique-dof mask: each global dof
        counted once by the global reductions."""
        return np.asarray(self._unique, dtype=np.float64)

    @property
    def grid_shape(self) -> Tuple[int, int, int, int]:
        M, S = self.part.M, self.part.sdsz
        return (M, M, S, S)

    def zeros(self, dtype=jnp.complex64) -> jnp.ndarray:
        return jnp.zeros(self.grid_shape, dtype=dtype)

    # ------------------------------------------------------------------
    def ol_update(self, x: jnp.ndarray, restricted: bool = True,
                  averaging: bool = True) -> jnp.ndarray:
        """Overlap exchange: add each neighbour's inner (OL+1)-wide strip
        into the matching outer strip; optionally RAS-zero own outer OL ring
        first and average contact lines after.  Defaults match the
        reference's ``Restricted_AS=True`` / ``Averaging=1``.

        x: (M, M, S, S).
        """
        M, S, OL = self.part.M, self.part.sdsz, self.part.OL
        has = self._has
        dt = x.dtype
        rr = jnp.asarray(self._row_ol, x.real.dtype)  # (M, S)
        cc = jnp.asarray(self._col_ol, x.real.dtype)

        hW = jnp.asarray(has["W"], x.real.dtype)[None, :, None, None]
        hE = jnp.asarray(has["E"], x.real.dtype)[None, :, None, None]
        hS = jnp.asarray(has["S"], x.real.dtype)[:, None, None, None]
        hN = jnp.asarray(has["N"], x.real.dtype)[:, None, None, None]
        rr4 = rr[:, None, :, None]                    # (M,1,S,1)
        cc4 = cc[None, :, None, :]                    # (1,M,1,S)

        # capture send strips from the pre-zeroing state
        from_W = _sshift(x, 0, -1)[..., :, S - 2 * OL - 1:S - OL]
        from_E = _sshift(x, 0, +1)[..., :, OL:2 * OL + 1]
        from_S = _sshift(x, -1, 0)[..., S - 2 * OL - 1:S - OL, :]
        from_N = _sshift(x, +1, 0)[..., OL:2 * OL + 1, :]
        from_SW = _sshift(x, -1, -1)[..., S - 2 * OL - 1:S - OL,
                                     S - 2 * OL - 1:S - OL]
        from_NE = _sshift(x, +1, +1)[..., OL:2 * OL + 1, OL:2 * OL + 1]
        from_NW = _sshift(x, +1, -1)[..., OL:2 * OL + 1,
                                     S - 2 * OL - 1:S - OL]
        from_SE = _sshift(x, -1, +1)[..., S - 2 * OL - 1:S - OL,
                                     OL:2 * OL + 1]

        if restricted:
            x = x * jnp.asarray(self._ras_keep, x.real.dtype)

        x = x.at[..., :, :OL + 1].add(from_W * hW * rr4)
        x = x.at[..., :, S - OL - 1:].add(from_E * hE * rr4)
        x = x.at[..., :OL + 1, :].add(from_S * hS * cc4)
        x = x.at[..., S - OL - 1:, :].add(from_N * hN * cc4)
        x = x.at[..., :OL + 1, :OL + 1].add(from_SW * hS * hW)
        x = x.at[..., S - OL - 1:, S - OL - 1:].add(from_NE * hN * hE)
        x = x.at[..., S - OL - 1:, :OL + 1].add(from_NW * hN * hW)
        x = x.at[..., :OL + 1, S - OL - 1:].add(from_SE * hS * hE)

        if averaging:
            x = x * jnp.asarray(self._avg, x.real.dtype)
        return x

    # ------------------------------------------------------------------
    @staticmethod
    def apply_stencil_raw(coef: jnp.ndarray, offsets, x: jnp.ndarray
                          ) -> jnp.ndarray:
        """Batched per-subdomain stencil apply, *without* the boundary-ring
        fix-up (the outermost ring rows lack out-of-box neighbour terms)."""
        from ..sparse import _shift2d

        y = coef[0] * _shift2d(x, *offsets[0])
        for s in range(1, len(offsets)):
            y = y + coef[s] * _shift2d(x, *offsets[s])
        return y

    def ax_op(self, coef: jnp.ndarray, offsets, x: jnp.ndarray
              ) -> jnp.ndarray:
        """Distributed matvec of the row-sharded global operator.

        coef: (noff, M, M, S, S) per-subdomain stencil coefficients (the
        crop of the global assembly to each box -- equivalent to the
        reference's per-subdomain ``A[p][2]`` CSR).  The batched stencil
        apply computes every row from local data; only the outermost ring
        (width 1) lacks out-of-box neighbour terms, and is overwritten with
        the neighbour's fully-assembled values, exactly like ``Ax_op``'s
        boundary-row overwrite.
        """
        return self.ring_overwrite(self.apply_stencil_raw(coef, offsets, x))

    def ring_overwrite(self, y: jnp.ndarray) -> jnp.ndarray:
        """Overwrite each subdomain's outermost ring with the neighbours'
        fully-assembled values (``Ax_op``'s receive phase,
        ``p_h-PY_C-CL-multi-GPU.py:2663-2744``)."""
        M, S, OL = self.part.M, self.part.sdsz, self.part.OL
        has = self._has
        rdt = y.real.dtype
        hW = jnp.asarray(has["W"], rdt)[None, :, None]     # (1,M,1) by sj
        hE = jnp.asarray(has["E"], rdt)[None, :, None]
        hS = jnp.asarray(has["S"], rdt)[:, None, None]     # (M,1,1) by si
        hN = jnp.asarray(has["N"], rdt)[:, None, None]
        r1 = jnp.asarray(self._row_1, rdt)[:, None, :]     # (M,1,S) by si
        c1 = jnp.asarray(self._col_1, rdt)[None, :, :]     # (1,M,S) by sj

        inner = S - 2 * OL - 1      # the neighbour column/row we adopt
        wcol = _sshift(y, 0, -1)[..., :, inner]            # (M,M,S)
        ecol = _sshift(y, 0, +1)[..., :, 2 * OL]
        srow = _sshift(y, -1, 0)[..., inner, :]
        nrow = _sshift(y, +1, 0)[..., 2 * OL, :]
        m = hW * r1
        y = y.at[..., :, 0].set(y[..., :, 0] * (1 - m) + wcol * m)
        m = hE * r1
        y = y.at[..., :, S - 1].set(y[..., :, S - 1] * (1 - m) + ecol * m)
        m = hS * c1
        y = y.at[..., 0, :].set(y[..., 0, :] * (1 - m) + srow * m)
        m = hN * c1
        y = y.at[..., S - 1, :].set(y[..., S - 1, :] * (1 - m) + nrow * m)

        # corner points
        hW2 = jnp.asarray(has["W"], rdt)[None, :]
        hE2 = jnp.asarray(has["E"], rdt)[None, :]
        hS2 = jnp.asarray(has["S"], rdt)[:, None]
        hN2 = jnp.asarray(has["N"], rdt)[:, None]
        sw = _sshift(y, -1, -1)[..., inner, inner]
        ne = _sshift(y, +1, +1)[..., 2 * OL, 2 * OL]
        nw = _sshift(y, +1, -1)[..., 2 * OL, inner]
        se = _sshift(y, -1, +1)[..., inner, 2 * OL]
        m = hS2 * hW2
        y = y.at[..., 0, 0].set(y[..., 0, 0] * (1 - m) + sw * m)
        m = hN2 * hE2
        y = y.at[..., S - 1, S - 1].set(
            y[..., S - 1, S - 1] * (1 - m) + ne * m)
        m = hN2 * hW2
        y = y.at[..., S - 1, 0].set(y[..., S - 1, 0] * (1 - m) + nw * m)
        m = hS2 * hE2
        y = y.at[..., 0, S - 1].set(y[..., 0, S - 1] * (1 - m) + se * m)
        return y

    # ---- two-plane variants (complex as float planes, tpcg/ops/cplx.py)
    # (the exchange and overwrite are R-linear with real masks, so
    #  plane-wise application is exactly the complex op.)

    def ol_update_planes(self, xp: jnp.ndarray, restricted: bool = True,
                         averaging: bool = True) -> jnp.ndarray:
        """xp: (2, M, M, S, S) planes."""
        return jnp.stack([
            self.ol_update(xp[0], restricted, averaging),
            self.ol_update(xp[1], restricted, averaging)])

    def ax_op_planes(self, coef3: jnp.ndarray, offsets, xp: jnp.ndarray
                     ) -> jnp.ndarray:
        """Distributed complex matvec on planes.

        coef3: (3, noff, M, M, S, S) float planes [Ar, Ai, Ar+Ai]
        (Karatsuba, as in ``tpcg.ops.cplx.PairOperator``); the ring
        overwrite is applied to the combined planes, which equals the
        complex overwrite."""
        m1 = self.apply_stencil_raw(coef3[0], offsets, xp[0])
        m2 = self.apply_stencil_raw(coef3[1], offsets, xp[1])
        m3 = self.apply_stencil_raw(coef3[2], offsets, xp[0] + xp[1])
        return jnp.stack([self.ring_overwrite(m1 - m2),
                          self.ring_overwrite(m3 - m1 - m2)])

    def norm_planes(self, zp: jnp.ndarray) -> jnp.ndarray:
        u = jnp.asarray(self._unique, zp.dtype)
        return jnp.sqrt(jnp.sum((zp[0] * zp[0] + zp[1] * zp[1]) * u))

    def wdot_planes(self, Xp: jnp.ndarray, yp: jnp.ndarray) -> jnp.ndarray:
        """Hermitian dots on planes: Xp (K, 2, M, M, S, S) batched basis,
        yp (2, M, M, S, S) -> (2, K) [re, im] of conj(X).y."""
        u = jnp.asarray(self._unique, yp.dtype)
        ax = (-4, -3, -2, -1)
        re = jnp.sum((Xp[:, 0] * yp[0] + Xp[:, 1] * yp[1]) * u, axis=ax)
        im = jnp.sum((Xp[:, 0] * yp[1] - Xp[:, 1] * yp[0]) * u, axis=ax)
        return jnp.stack([re, im])

    # ------------------------------------------------------------------
    def norm(self, z: jnp.ndarray) -> jnp.ndarray:
        """Global 2-norm over unique dofs (conjugated), ==
        ``norm``/allreduce (``p_h-PY_C-CL-multi-GPU.py:2108-2121``)."""
        u = jnp.asarray(self._unique, z.real.dtype)
        return jnp.sqrt(jnp.sum((jnp.conj(z) * z).real * u))

    def wdot(self, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """Hermitian inner product over unique dofs (conj(x).y), ==
        ``wdot``/allreduce (``p_h-PY_C-CL-multi-GPU.py:2845-2892``).
        Batched over leading axes of x: x (..., M, M, S, S)."""
        u = jnp.asarray(self._unique, y.real.dtype)
        return jnp.sum(jnp.conj(x) * y * u, axis=(-4, -3, -2, -1))

    # ------------------------------------------------------------------
    def crop_stencil(self, coef_global: np.ndarray) -> np.ndarray:
        """Crop global stencil coefficients (noff, N, N) to per-subdomain
        boxes -> (noff, M, M, S, S)."""
        M, S = self.part.M, self.part.sdsz
        noff = coef_global.shape[0]
        out = np.empty((noff, M, M, S, S), dtype=coef_global.dtype)
        for p in range(self.part.nsubd):
            si, sj = divmod(p, M)
            r, c = self.part.row0[p], self.part.col0[p]
            out[:, si, sj] = coef_global[:, r:r + S, c:c + S]
        return out

    def crop_grid(self, g: np.ndarray) -> np.ndarray:
        """Global (N, N) field -> (M, M, S, S) stacked boxes."""
        M, S = self.part.M, self.part.sdsz
        out = np.empty((M, M, S, S), dtype=g.dtype)
        for p in range(self.part.nsubd):
            si, sj = divmod(p, M)
            r, c = self.part.row0[p], self.part.col0[p]
            out[si, sj] = g[r:r + S, c:c + S]
        return out

    def to_global(self, x, check=False, tol=1e-12) -> np.ndarray:
        M, S = self.part.M, self.part.sdsz
        flat = np.asarray(x).reshape(M * M, S, S)
        return self.part.to_global(flat, check=check, tol=tol)
