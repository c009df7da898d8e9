"""Variable-size domain decomposition -- the reference's legacy ``OL < 0``
path (``create_varsize_subdomain_indeces`` + the same ``OL_update`` /
``Ax_op`` machinery, which is size-agnostic in the reference because every
slice is taken relative to each subdomain's own shape).

Subdomains of different sizes cannot batch into one device tensor, so this
path is implemented host-side over per-subdomain arrays (like the
reference's per-rank numpy lists) and exposed as flat-vector callables so
the same ``fgmres`` driver runs on top.  It exists for behavioural parity
and as a cross-validation oracle; the equal-size path
(``tpcg/parallel/halo.py``) is the device production path.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .partition import make_varsize_partition


@dataclasses.dataclass
class VarsizeDecomposition:
    """Variable-size M x M decomposition of an (N, N) grid with overlap OL.

    Builds from ``make_varsize_partition``; subdomain p = (si*M + sj) has
    box rows [row0, row0+nv) x cols [col0, col0+nh) and unique local
    ranges urow/ucol.
    """
    M: int
    N: int
    OL: int
    subs: List[dict]

    @classmethod
    def build(cls, M: int, N: int, OL: int) -> "VarsizeDecomposition":
        return cls(M=M, N=N, OL=OL, subs=make_varsize_partition(M, N, OL))

    # ---- state helpers -------------------------------------------------
    @property
    def nsubd(self):
        return self.M * self.M

    def sizes(self):
        return [(s["nv"], s["nh"]) for s in self.subs]

    def split(self, flat: np.ndarray) -> List[np.ndarray]:
        out, k = [], 0
        for s in self.subs:
            n = s["nv"] * s["nh"]
            out.append(np.asarray(flat[k:k + n]).reshape(s["nv"], s["nh"]))
            k += n
        return out

    def concat(self, xs: List[np.ndarray]) -> np.ndarray:
        return np.concatenate([np.asarray(x).ravel() for x in xs])

    def crop_grid(self, g: np.ndarray) -> np.ndarray:
        return self.concat([
            g[s["row0"]:s["row0"] + s["nv"], s["col0"]:s["col0"] + s["nh"]]
            for s in self.subs])

    def to_global(self, flat, check=False, tol=1e-10) -> np.ndarray:
        xs = self.split(np.asarray(flat))
        g = np.zeros((self.N, self.N), dtype=xs[0].dtype)
        filled = np.zeros((self.N, self.N), dtype=bool)
        for s, x in zip(self.subs, xs):
            box = (slice(s["row0"], s["row0"] + s["nv"]),
                   slice(s["col0"], s["col0"] + s["nh"]))
            if check:
                bad = filled[box] & (np.abs(g[box] - x)
                                     > tol * np.maximum(1, np.abs(x)))
                if bad.any():
                    raise AssertionError(
                        f"overlap inconsistency: {int(bad.sum())} points")
            g[box] = np.where(filled[box], g[box], x)
            filled[box] = True
        return g

    def _nbr(self, p, dsi, dsj):
        si, sj = divmod(p, self.M)
        si, sj = si + dsi, sj + dsj
        if 0 <= si < self.M and 0 <= sj < self.M:
            return si * self.M + sj
        return None

    # ---- overlap exchange (OL_update semantics, per-subdomain shapes) --
    def ol_update(self, flat, restricted=True, averaging=True) -> np.ndarray:
        M, OL = self.M, self.OL
        xs = self.split(np.asarray(flat).copy())

        def span(p, axis, width):
            si, sj = divmod(p, M)
            s = si if axis == 0 else sj
            n = xs[p].shape[axis]
            return slice(width if s > 0 else 0,
                         n - width if s < M - 1 else n)

        snd = {}
        for p, v in enumerate(xs):
            rs, cs = span(p, 0, OL), span(p, 1, OL)
            snd[p] = {
                "W": v[rs, OL:2 * OL + 1].copy(),
                "E": v[rs, -2 * OL - 1:-OL].copy(),
                "S": v[OL:2 * OL + 1, cs].copy(),
                "N": v[-2 * OL - 1:-OL, cs].copy(),
                "SW": v[OL:2 * OL + 1, OL:2 * OL + 1].copy(),
                "NE": v[-2 * OL - 1:-OL, -2 * OL - 1:-OL].copy(),
                "NW": v[-2 * OL - 1:-OL, OL:2 * OL + 1].copy(),
                "SE": v[OL:2 * OL + 1, -2 * OL - 1:-OL].copy(),
            }
        if restricted:
            for p, v in enumerate(xs):
                si, sj = divmod(p, M)
                rs, cs = span(p, 0, OL), span(p, 1, OL)
                if sj > 0:
                    v[rs, :OL] = 0
                if sj < M - 1:
                    v[rs, -OL:] = 0
                if si > 0:
                    v[:OL, cs] = 0
                if si < M - 1:
                    v[-OL:, cs] = 0
                if si > 0 and sj > 0:
                    v[:OL, :OL] = 0
                if si < M - 1 and sj < M - 1:
                    v[-OL:, -OL:] = 0
                if si < M - 1 and sj > 0:
                    v[-OL:, :OL] = 0
                if si > 0 and sj < M - 1:
                    v[:OL, -OL:] = 0
        for p, v in enumerate(xs):
            si, sj = divmod(p, M)
            rs, cs = span(p, 0, OL), span(p, 1, OL)
            if sj > 0:
                v[rs, :OL + 1] += snd[self._nbr(p, 0, -1)]["E"]
            if sj < M - 1:
                v[rs, -OL - 1:] += snd[self._nbr(p, 0, 1)]["W"]
            if si > 0:
                v[:OL + 1, cs] += snd[self._nbr(p, -1, 0)]["N"]
            if si < M - 1:
                v[-OL - 1:, cs] += snd[self._nbr(p, 1, 0)]["S"]
            if si > 0 and sj > 0:
                v[:OL + 1, :OL + 1] += snd[self._nbr(p, -1, -1)]["NE"]
            if si < M - 1 and sj < M - 1:
                v[-OL - 1:, -OL - 1:] += snd[self._nbr(p, 1, 1)]["SW"]
            if si < M - 1 and sj > 0:
                v[-OL - 1:, :OL + 1] += snd[self._nbr(p, 1, -1)]["SE"]
            if si > 0 and sj < M - 1:
                v[:OL + 1, -OL - 1:] += snd[self._nbr(p, -1, 1)]["NW"]
        if averaging:
            for p, v in enumerate(xs):
                si, sj = divmod(p, M)
                if sj > 0:
                    v[:, OL] /= 2
                if sj < M - 1:
                    v[:, -OL - 1] /= 2
                if si > 0:
                    v[OL, :] /= 2
                if si < M - 1:
                    v[-OL - 1, :] /= 2
        return self.concat(xs)

    # ---- distributed matvec (Ax_op semantics) --------------------------
    def crop_operator(self, A_global):
        """Global scipy matrix -> per-subdomain box operators (CSR)."""
        import scipy.sparse as sp
        A = sp.csr_matrix(A_global)
        ops = []
        for s in self.subs:
            ridx = (np.repeat(np.arange(s["row0"], s["row0"] + s["nv"]),
                              s["nh"]) * self.N
                    + np.tile(np.arange(s["col0"], s["col0"] + s["nh"]),
                              s["nv"]))
            ops.append(sp.csr_matrix(A[ridx][:, ridx]))
        return ops

    def ax_op(self, ops, flat) -> np.ndarray:
        M, OL = self.M, self.OL
        xs = self.split(np.asarray(flat))
        ys = [(ops[p] @ xs[p].ravel()).reshape(xs[p].shape)
              for p in range(self.nsubd)]

        def span1(p, axis):
            si, sj = divmod(p, M)
            s = si if axis == 0 else sj
            n = ys[p].shape[axis]
            return slice(1 if s > 0 else 0, n - 1 if s < M - 1 else n)

        out = [y.copy() for y in ys]
        for p in range(self.nsubd):
            si, sj = divmod(p, M)
            rs, cs = span1(p, 0), span1(p, 1)
            if sj > 0:
                out[p][rs, 0] = ys[self._nbr(p, 0, -1)][rs, -2 * OL - 1]
            if sj < M - 1:
                out[p][rs, -1] = ys[self._nbr(p, 0, 1)][rs, 2 * OL]
            if si > 0:
                out[p][0, cs] = ys[self._nbr(p, -1, 0)][-2 * OL - 1, cs]
            if si < M - 1:
                out[p][-1, cs] = ys[self._nbr(p, 1, 0)][2 * OL, cs]
            if si > 0 and sj > 0:
                out[p][0, 0] = ys[self._nbr(p, -1, -1)][-2 * OL - 1,
                                                        -2 * OL - 1]
            if si < M - 1 and sj < M - 1:
                out[p][-1, -1] = ys[self._nbr(p, 1, 1)][2 * OL, 2 * OL]
            if si < M - 1 and sj > 0:
                out[p][-1, 0] = ys[self._nbr(p, 1, -1)][2 * OL, -2 * OL - 1]
            if si > 0 and sj < M - 1:
                out[p][0, -1] = ys[self._nbr(p, -1, 1)][-2 * OL - 1, 2 * OL]
        return self.concat(out)

    # ---- reductions over unique dofs -----------------------------------
    def _unique_slices(self, p):
        s = self.subs[p]
        return (slice(*s["urow"]), slice(*s["ucol"]))

    def norm(self, flat) -> float:
        xs = self.split(np.asarray(flat))
        acc = 0.0
        for p, x in enumerate(xs):
            u = x[self._unique_slices(p)]
            acc += np.vdot(u, u).real
        return float(np.sqrt(acc))

    def wdot(self, basis, flat) -> np.ndarray:
        """basis: (K, total) stacked flat vectors -> (K,) conj dots."""
        basis = np.asarray(basis)
        xs = self.split(np.asarray(flat))
        acc = np.zeros(basis.shape[0], dtype=np.complex128)
        k = 0
        for p, x in enumerate(xs):
            n = x.size
            ur, uc = self._unique_slices(p)
            mask = np.zeros(x.shape, dtype=bool)
            mask[ur, uc] = True
            seg = basis[:, k:k + n][:, mask.ravel()]
            acc += np.conj(seg) @ x.ravel()[mask.ravel()]
            k += n
        return acc


def varsize_hsolver(M: int, W: int, OL: int, k: float, eps: float = None,
                    tol: float = 1e-6, restart: int = 100,
                    cg_max_it: int = 0, cg_tol: float = 1e-5,
                    verbose: int = 0):
    """End-to-end Helmholtz solve on the variable-size partition:
    global assembly, ORAS preconditioner with per-subdomain impedance
    blocks (each subdomain's own shape), exact or NumPy-CG subsolves,
    FGMRES.  ``OL`` positive here (the reference flips the sign of its
    argv overlap to select this path, ``HSolver`` :3391-3395).
    Returns (x_flat, decomp, result)."""
    import scipy.sparse.linalg as spla

    from .. import reference
    from ..problems.helmholtz import helm_fe, local_rect
    from ..problems.rhs import plane_wave_rhs
    from .fgmres import fgmres

    eps = k if eps is None else eps
    N = (W - 1) * M + 1                     # varsize: grid NOT expanded
    decomp = VarsizeDecomposition.build(M, N, OL)
    A_glob = helm_fe(N, k, eps).to_scipy()
    ops = decomp.crop_operator(A_glob)
    b = decomp.crop_grid(plane_wave_rhs(N, k))

    blocks = []
    for s in decomp.subs:
        P = local_rect(N, k=k, eps=eps, eta=k, L=1.0,
                       Nhoriz=s["nh"], Nvert=s["nv"])
        blocks.append(spla.factorized(P.to_scipy().tocsc())
                      if cg_max_it == 0 else P.to_scipy())

    def prec(z):
        zs = decomp.split(np.asarray(z))
        rs = []
        for p, zp in enumerate(zs):
            if cg_max_it == 0:
                rs.append(blocks[p](zp.ravel()).reshape(zp.shape))
            else:
                # the reference's UseCG=5 mode uses the early-exit NumPy
                # CG (CG(P, z, tol=CGtol, maxit=CGMaxIT), as_prec :1915;
                # CGtol=1e-5 default, :3606)
                rs.append(reference.cg_early_exit(
                    blocks[p], zp.ravel(), tol=cg_tol,
                    maxit=cg_max_it).reshape(zp.shape))
        return decomp.ol_update(decomp.concat(rs))

    res = fgmres(lambda x: decomp.ax_op(ops, np.asarray(x)), b, M=prec,
                 tol=tol, krylsize=restart, jit_tail=False,
                 norm=lambda v: decomp.norm(np.asarray(v)),
                 wdot=lambda V, v: decomp.wdot(np.asarray(V),
                                               np.asarray(v)))
    return np.asarray(res.x), decomp, res
