"""2-D Helmholtz P1 finite-element assembly (impedance boundary conditions).

One vectorized assembler covers all three FE matrices of the reference:

* ``helmFE_var`` (``helmFE_var.py:9-331``): variable wave speed,
  ``-laplace(u) - (1+i rho) k^2 u = f`` with ``k = omega/c`` per grid square
  and impedance BC ``du/dn - i k u = 0``.
* ``local_rect`` (``p_h-PY_C-CL-multi-GPU.py:1434-1634``): constant
  coefficient subdomain block ``-laplace(u) - (k^2 + i eps) u`` with
  impedance parameter eta (the ORAS preconditioner block, built with
  ``eta = k``).
* ``helm_fe`` (``p_h-PY_C-CL-multi-GPU.py:91-613``): the constant-coefficient
  global matrix == ``local_rect`` on the full domain with ``eta = k`` (same
  per-entry coefficients; the reference's version additionally splits rows
  into shared/own blocks, which our distributed layer does by masking
  instead -- see ``tpcg/parallel``).

Derivation: on the uniform square mesh with SW-NE split triangles, every
reference coefficient decomposes into per-square contributions:

  stiffness  : #adjacent squares (diag), -1/2 per square adjacent to a mesh
               edge (horizontal/vertical links), 0 for diagonal links.
  domain mass: -(mass coefficient of the square) * h^2 * w where w is 1/12
               of the P1 mass weights {diag: (1,2,2,1)/12 over NW,SW,NE,SE;
               links: 1/24 per adjacent square; diagonal links: 1/12}.
  boundary   : -i*(bnd coefficient)*h*(2/3 diag per boundary side incidence,
               1/6 per boundary link), only on boundary sides.

with ``mass = (1+i rho) k^2`` / ``bnd = k`` for the variable form and
``mass = k^2 + i eps`` / ``bnd = eta`` for the constant form.  Every branch
of the reference's per-node case analysis (corners / edges / interior,
``helmFE_var.py:77-323``) is reproduced by zero-padding the per-square
fields -- verified entry-for-entry in ``tests/test_problems.py``.

The natural output is a ``Stencil2D`` (7-point: E,W,N,S,NE,SW,diag), which
is also the cheapest matvec (pure 2-D shifts); ``.to_dia()`` / ``.to_scipy()`` give the
flattened forms.
"""
from __future__ import annotations

import numpy as np

from ..sparse import Stencil2D

# neighbour offsets (dm, dj): node (m, j), flat index m*Nh + j.
OFFSETS = (
    (0, 0),    # diag
    (0, 1),    # E
    (0, -1),   # W
    (1, 0),    # N
    (-1, 0),   # S
    (1, 1),    # NE
    (-1, -1),  # SW
)


def _pad_square_fields(sq, nv, nh):
    """Per-square field (nv-1, nh-1) -> per-node neighbour-square fields
    (nv, nh), zero outside the mesh.

    Returns (nw, sw, ne, se): value of the square north-west / south-west /
    north-east / south-east of each node.
    """
    z = np.zeros((nv, nh), dtype=sq.dtype)
    nw = z.copy(); nw[:-1, 1:] = sq          # square (m, j-1)
    sw = z.copy(); sw[1:, 1:] = sq           # square (m-1, j-1)
    ne = z.copy(); ne[:-1, :-1] = sq         # square (m, j)
    se = z.copy(); se[1:, :-1] = sq          # square (m-1, j)
    return nw, sw, ne, se


def assemble_helmholtz_fe(h: float, mass_sq: np.ndarray, bnd_sq: np.ndarray,
                          dtype=np.complex128) -> Stencil2D:
    """Assemble S = K - M - i*B on an (nv, nh) node grid.

    h       : mesh width (``1/(N-1)`` for the unit square;
              ``L/(N-1)`` for ``local_rect``, using the *global* N).
    mass_sq : (nv-1, nh-1) complex "mass coefficient" per square
              (``(1+i rho) * (omega/c)^2`` or ``k^2 + i eps``).
    bnd_sq  : (nv-1, nh-1) boundary/impedance coefficient per square
              (``omega/c`` or ``eta``).
    """
    mass_sq = np.asarray(mass_sq, dtype=dtype)
    bnd_sq = np.asarray(bnd_sq, dtype=dtype)
    nv, nh = mass_sq.shape[0] + 1, mass_sq.shape[1] + 1
    h2 = h * h

    m_nw, m_sw, m_ne, m_se = _pad_square_fields(mass_sq, nv, nh)
    b_nw, b_sw, b_ne, b_se = _pad_square_fields(bnd_sq, nv, nh)
    e_nw, e_sw, e_ne, e_se = _pad_square_fields(
        np.ones_like(mass_sq, dtype=np.float64), nv, nh)

    ih = 1j * h

    # --- diagonal -----------------------------------------------------------
    n_adj = e_nw + e_sw + e_ne + e_se                     # stiffness: 4/2/1
    mass_d = (m_nw + 2.0 * m_sw + 2.0 * m_ne + m_se) * h2 / 12.0
    # boundary-mass diagonal: for a node on a boundary side, the squares
    # adjacent along that side (e.g. NW and NE for a bottom node).
    bdiag = np.zeros((nv, nh), dtype=dtype)
    bdiag[0, :] += b_nw[0, :] + b_ne[0, :]        # bottom side
    bdiag[-1, :] += b_sw[-1, :] + b_se[-1, :]     # top side
    bdiag[:, 0] += b_ne[:, 0] + b_se[:, 0]        # left side
    bdiag[:, -1] += b_nw[:, -1] + b_sw[:, -1]     # right side
    # each boundary side contributes (sum of its adjacent squares)/3; corners
    # see two sides, reproducing the reference's -2ikh/3 / -(kl+kr)h/3 terms.
    diag = n_adj - mass_d - ih * bdiag / 3.0

    # --- E / W links (horizontal mesh edges) --------------------------------
    # edge (m,j)-(m,j+1): adjacent squares NE (above) and SE (below).
    stiff_e = -0.5 * (e_ne + e_se)
    mass_e = -(m_ne + m_se) * h2 / 24.0
    bnd_e = np.zeros((nv, nh), dtype=dtype)
    bnd_e[0, :] = b_ne[0, :]                      # bottom boundary edge
    bnd_e[-1, :] = b_se[-1, :]                    # top boundary edge
    east = stiff_e + mass_e - ih * bnd_e / 6.0
    east[:, -1] = 0.0                              # no E neighbour at right

    # edge (m,j)-(m,j-1): adjacent squares NW and SW.
    stiff_w = -0.5 * (e_nw + e_sw)
    mass_w = -(m_nw + m_sw) * h2 / 24.0
    bnd_w = np.zeros((nv, nh), dtype=dtype)
    bnd_w[0, :] = b_nw[0, :]
    bnd_w[-1, :] = b_sw[-1, :]
    west = stiff_w + mass_w - ih * bnd_w / 6.0
    west[:, 0] = 0.0

    # --- N / S links (vertical mesh edges) ----------------------------------
    # edge (m,j)-(m+1,j): adjacent squares NW (left) and NE (right).
    stiff_n = -0.5 * (e_nw + e_ne)
    mass_n = -(m_nw + m_ne) * h2 / 24.0
    bnd_n = np.zeros((nv, nh), dtype=dtype)
    bnd_n[:, 0] = b_ne[:, 0]                      # left boundary edge
    bnd_n[:, -1] = b_nw[:, -1]                    # right boundary edge
    north = stiff_n + mass_n - ih * bnd_n / 6.0
    north[-1, :] = 0.0

    # edge (m,j)-(m-1,j): adjacent squares SW and SE.
    stiff_s = -0.5 * (e_sw + e_se)
    mass_s = -(m_sw + m_se) * h2 / 24.0
    bnd_s = np.zeros((nv, nh), dtype=dtype)
    bnd_s[:, 0] = b_se[:, 0]
    bnd_s[:, -1] = b_sw[:, -1]
    south = stiff_s + mass_s - ih * bnd_s / 6.0
    south[0, :] = 0.0

    # --- NE / SW diagonal links (triangle hypotenuses) ----------------------
    ne = -m_ne * h2 / 12.0
    ne[-1, :] = 0.0
    ne[:, -1] = 0.0
    sw = -m_sw * h2 / 12.0
    sw[0, :] = 0.0
    sw[:, 0] = 0.0

    coef = np.stack([diag, east, west, north, south, ne, sw])
    # keep coefficients host-side: device upload happens on first use,
    # and the planes path (tpcg.ops.cplx) splits planes before upload
    return Stencil2D(OFFSETS, coef.astype(dtype), (nv, nh))


def helm_fe_var(N: int, omega: float, C: np.ndarray, rho: float,
                Nhoriz=None, Nvert=None, dtype=np.complex128) -> Stencil2D:
    """Variable-wave-speed Helmholtz FE matrix (``helmFE_var.py:9-331``).

    C : (Nvert-1, Nhoriz-1) wave speeds per square; k = omega / C.
    """
    Nhoriz = Nhoriz or N
    Nvert = Nvert or N
    C = np.asarray(C, dtype=np.float64)
    assert C.shape == (Nvert - 1, Nhoriz - 1), (C.shape, Nvert, Nhoriz)
    k = omega / C
    h = 1.0 / (N - 1.0)
    mass_sq = (1.0 + 1j * rho) * k ** 2
    return assemble_helmholtz_fe(h, mass_sq, k.astype(dtype), dtype=dtype)


def local_rect(N: int, k: float, eps: float, eta: float, L: float = 1.0,
               Nhoriz: int = None, Nvert: int = None,
               dtype=np.complex128) -> Stencil2D:
    """Constant-coefficient Helmholtz FE block on an (Nvert x Nhoriz)
    sub-rectangle with mesh width ``h = L/(N-1)``
    (``p_h-PY_C-CL-multi-GPU.py:1434-1634``).  With ``eta = k`` this is the
    impedance ("Robin == 1") ORAS subdomain operator."""
    Nhoriz = Nhoriz or N
    Nvert = Nvert or N
    mass_sq = np.full((Nvert - 1, Nhoriz - 1), k * k + 1j * eps, dtype=dtype)
    bnd_sq = np.full((Nvert - 1, Nhoriz - 1), eta, dtype=dtype)
    h = L * 1.0 / (N - 1.0)
    return assemble_helmholtz_fe(h, mass_sq, bnd_sq, dtype=dtype)


def helm_fe(N: int, k: float, eps: float, dtype=np.complex128) -> Stencil2D:
    """Constant-coefficient global Helmholtz FE matrix
    (``p_h-PY_C-CL-multi-GPU.py:91-613``, sans the shared/own row split)."""
    return local_rect(N, k, eps, eta=k, L=1.0, Nhoriz=N, Nvert=N, dtype=dtype)
