"""Domain partitioning for the 2-D grid.

Replaces the reference's subdomain bookkeeping tables
(``SubDomain``/``DomainProc``/``GLOBALS``, built by
``create_eqsize_subdomain_indeces`` / ``create_varsize_subdomain_indeces``,
``p_h-PY_C-CL-multi-GPU.py:1680-1805``) with a static, device-friendly
description: every subdomain's box, unique ("owned") region and neighbour
structure, precomputed as numpy masks that the jitted distributed operators
consume as constants.

Equal-size mode (``OL >= 0``): the global grid is pre-expanded by ``2*OL``
(``HSolver``, ``p_h-PY_C-CL-multi-GPU.py:3397-3402``) so that all
``M x M`` subdomains are identical ``(short_w + 2*OL + 1)``-point squares --
the property that lets all subdomain solves share one matrix and batch into
a single multi-RHS CG (the reference's ``UseCG == 2`` trick, which maps
perfectly onto a device batch dimension).

The reference's unique-region tables have two quirks we reproduce exactly
(they shape every ``norm``/``wdot`` and hence residual histories):
row block ``[short_w, short_w + OL)`` between subdomains 0 and 1 belongs to
no one's unique region, and the last global row/column is owned by no one
(``create_eqsize_subdomain_indeces``: unique row end is ``Lis + short_w``
for ``i < M-1`` and ``Lis + short_w + OL`` for ``i == M-1``, which stops one
short of the box end).  ``strict_parity=False`` gives a gapless partition
instead.

Subdomain -> device placement differs deliberately: the reference
round-robins subdomains over MPI ranks (``p % nprocs``,
``p_h-PY_C-CL-multi-GPU.py:3371``); we shard the stacked subdomain axis in
contiguous blocks, which keeps W/E neighbours on-device and crosses devices for
N/S -- a placement detail with identical semantics.
"""
from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """Static description of an M x M equal-size decomposition."""
    M: int                 # subdomains per side
    N: int                 # expanded global grid points per side
    OL: int                # overlap parameter
    short_w: int           # subdomain width without overlap
    sdsz: int              # subdomain grid points per side (all equal)
    row0: np.ndarray       # (nsubd,) global row of each subdomain's box
    col0: np.ndarray       # (nsubd,) global col
    # local unique ("owned") index ranges [r0, r1) x [c0, c1):
    urow: np.ndarray       # (nsubd, 2)
    ucol: np.ndarray       # (nsubd, 2)
    unique_mask: np.ndarray  # (nsubd, sdsz, sdsz) float64 1/0

    @property
    def nsubd(self):
        return self.M * self.M

    @property
    def n_global(self):
        return self.N * self.N

    def subdomain_index(self, p):
        """p -> (si, sj): vertical/horizontal position in the subdomain
        grid (p = si * M + sj, like ``csd`` ordering)."""
        return divmod(p, self.M)

    # ---- global <-> stacked conversions (host/debug; the solvers never
    #      materialise the global grid) --------------------------------

    def to_stacked(self, g: np.ndarray) -> np.ndarray:
        """Global (N, N) grid -> stacked (nsubd, sdsz, sdsz)."""
        out = np.empty((self.nsubd, self.sdsz, self.sdsz), dtype=g.dtype)
        for p in range(self.nsubd):
            r, c = self.row0[p], self.col0[p]
            out[p] = g[r:r + self.sdsz, c:c + self.sdsz]
        return out

    def to_global(self, x: np.ndarray, check: bool = False,
                  tol: float = 1e-12) -> np.ndarray:
        """Stacked -> global grid; with ``check``, assert that overlapping
        copies agree (the ``check_nd_*_global_vec`` invariant,
        ``p_h-PY_C-CL-multi-GPU.py:2008-2086``)."""
        g = np.zeros((self.N, self.N), dtype=x.dtype)
        filled = np.zeros((self.N, self.N), dtype=bool)
        for p in range(self.nsubd):
            r, c = self.row0[p], self.col0[p]
            box = (slice(r, r + self.sdsz), slice(c, c + self.sdsz))
            if check:
                scale = np.maximum(1.0, np.abs(x[p]))
                bad = filled[box] & (np.abs(g[box] - x[p]) > tol * scale)
                if bad.any():
                    raise AssertionError(
                        f"overlap inconsistency in subdomain {p}: "
                        f"{int(bad.sum())} points, max "
                        f"{np.abs(g[box] - x[p])[bad].max():.3e}")
            g[box] = np.where(filled[box], g[box], x[p])
            filled[box] = True
        return g


def make_partition(M: int, W: int, OL: int,
                   strict_parity: bool = True) -> Partition:
    """Build the equal-size partition for subdomain width W, M x M
    subdomains, overlap OL.

    Mirrors ``HSolver``'s sizing (``p_h-PY_C-CL-multi-GPU.py:3396-3402``):
    ``N = (W-1)*M + 1`` expanded to ``N + 2*OL``.
    """
    N0 = (W - 1) * M + 1
    N = N0 + 2 * OL
    n = N - 2 * OL - 1
    short_w = n // M
    sdsz = short_w + 2 * OL + 1
    nsubd = M * M

    row0 = np.zeros(nsubd, dtype=np.int64)
    col0 = np.zeros(nsubd, dtype=np.int64)
    urow = np.zeros((nsubd, 2), dtype=np.int64)
    ucol = np.zeros((nsubd, 2), dtype=np.int64)
    for p in range(nsubd):
        si, sj = divmod(p, M)
        row0[p] = si * short_w
        col0[p] = sj * short_w
        for (s, tab) in ((si, urow), (sj, ucol)):
            if strict_parity:
                lo = OL if s > 0 else 0
                hi = lo + short_w + (OL if s == M - 1 else 0)
            else:
                # gapless ownership: unique regions tile the grid exactly
                # (subdomain 0 keeps the leading 2*OL expansion rows, the
                # last one keeps the trailing row).
                lo = 0 if s == 0 else 2 * OL
                hi = sdsz if s == M - 1 else 2 * OL + short_w
            tab[p] = (lo, hi)

    unique = np.zeros((nsubd, sdsz, sdsz), dtype=np.float64)
    for p in range(nsubd):
        unique[p, urow[p, 0]:urow[p, 1], ucol[p, 0]:ucol[p, 1]] = 1.0
    return Partition(M=M, N=N, OL=OL, short_w=short_w, sdsz=sdsz,
                     row0=row0, col0=col0, urow=urow, ucol=ucol,
                     unique_mask=unique)


def make_varsize_partition(M: int, N: int, OL: int):
    """Variable-size partition tables (the reference's legacy ``OL < 0``
    path, ``create_varsize_subdomain_indeces``,
    ``p_h-PY_C-CL-multi-GPU.py:1680-1743``): the grid is NOT expanded; the
    last subdomains absorb the remainder rows, so boxes differ in size.

    Returns a list of per-subdomain dicts (row0, col0, nv, nh, urow, ucol).
    Used by the (loop-based) variable-size solver path and for parity tests;
    the batched device path requires equal sizes.
    """
    n = N - 1
    sdw = np.full(M, n // M, dtype=np.int64)
    rest = n - (n // M) * M
    if rest:
        sdw[-rest:] += 1
    subs = []
    for si in range(M):
        for sj in range(M):
            lis = OL if si > 0 else 0
            lie = OL if si < M - 1 else 0
            ljs = OL if sj > 0 else 0
            lje = OL if sj < M - 1 else 0
            r0 = int(np.sum(sdw[:si])) - lis
            c0 = int(np.sum(sdw[:sj])) - ljs
            nv = lis + int(sdw[si]) + lie + 1
            nh = ljs + int(sdw[sj]) + lje + 1
            ur = (lis, lis + int(sdw[si]) + (1 if si == M - 1 else 0))
            uc = (ljs, ljs + int(sdw[sj]) + (1 if sj == M - 1 else 0))
            subs.append(dict(row0=r0, col0=c0, nv=nv, nh=nh,
                             urow=ur, ucol=uc))
    return subs
