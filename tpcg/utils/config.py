"""Configuration for the distributed Helmholtz solver.

Replaces the reference's ~60 module-level globals + ``set_globals()`` reset
(``p_h-PY_C-CL-multi-GPU.py:3508-3634``) with one dataclass.  Field
defaults mirror the reference's defaults, with the source global named.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class HelmholtzConfig:
    # problem (``__main__`` tail, :3639-3675)
    k: float = 20.0                  # kkk (:3608)
    beta: float = 1.0                # epsilon = k**beta (:3610, 3672)
    M_subd: int = 2                  # subdomains per side (argv M_s)
    W_subd: int = 16                 # subdomain width (argv W_s)
    OL: int = -1                     # overlap; -1 -> (W_subd-2)//2 (:3660)
    use_poisson: bool = False        # Use_Poisson (:3568)

    # preconditioner (as_prec)
    as_prec: int = 1                 # 0 none, 1 one-level AS (:3499-3504)
    robin: int = 1                   # 1 impedance blocks (:3671)
    restricted_as: bool = True       # Restricted_AS (:3583)
    averaging: int = 1               # Averaging (:3582)
    use_cg: int = 2                  # UseCG sub-solver mode (:3684)
    cg_max_it: int = 256             # CGMaxIT (:3607)
    cg_tol: float = 1e-5             # CGtol (:3606) (early-exit modes only)
    eps_prec1: float = -1.0          # ep1; -1 -> epsilon (:3673)

    # Krylov (gmres dispatcher, :3294-3338)
    gmres_ver: str = "fgmres"        # GMRES_VER (:3541)
    tol: float = 1e-6                # Tol (:3443)
    restart: int = 600               # restrt (:3504)
    fgmres_chunk: int = 1            # Arnoldi steps fused per device call
    #                                  (1 == reference behaviour, and the
    #                                  fastest measured on an H100)
    fgmres_chunk_split: bool = True  # predictive last-chunk splitting
    #                                  (wasted prec applies ~0; costs one
    #                                  extra traced program per solve)

    # variable-coefficient island (:3593-3605)
    var_coeff: bool = False          # VarCoeff
    use_marmousi: bool = False       # UseMarmousi
    mar_mult_in: float = 1.0         # MarMult_in
    mar_mult_out: float = 1.0        # MarMult_out
    mar_match: bool = True           # MarMatch
    mar_shift: int = 0               # Marshift

    # O-shape domain / inactive-node masking (:3603-3605).  The reference
    # declares ``OshapeD`` + per-subdomain 0/1 ``InactiveNodes`` masks and
    # multiplies the RHS (:1429-1430), the random guess (:2760-2762) and
    # the ones guess (:3482-3484) by them; the masks themselves are
    # external input (never populated in the snapshot).  ``inactive_mask``
    # here is a global (N, N) 0/1 grid (None + oshape_d=True -> the
    # default middle-third O-shape hole, ``tpcg.problems.oshape_mask``).
    oshape_d: bool = False           # OshapeD (:3604)
    inactive_mask: object = None     # InactiveNodes (:3605), global grid

    # run control
    guess: int = 1                   # 1 ones, 2 random, else zeros (:3474)
    verbose: int = 10                # (:3585)
    dtype: str = "complex64"         # device dtype (reference: csingle)
    use_planes: bool = False         # complex as float real/imag planes
    #                                  instead of native complex
    seed: int = 0                    # for guess == 2

    @property
    def epsilon(self) -> float:
        return self.k ** self.beta

    @property
    def eps1(self) -> float:
        return self.epsilon if self.eps_prec1 < 0 else self.eps_prec1

    @property
    def overlap(self) -> int:
        return (self.W_subd - 2) // 2 if self.OL < 0 else self.OL
