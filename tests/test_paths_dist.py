"""The ORAS subdomain solves against the float64 oracle.

The batched subdomain CG of ``SchwarzPrec`` (UseCG=1/2/6) used to run in
a whole-solve hand-written kernel (``prec_kernel="fused"``).  It now runs
the XLA ``block_cg`` / ``block_cg_planes`` recurrence; each subdomain's result
must match ``tpcg.reference.cg`` on that subdomain's block with the same
fixed iteration count.  Fields: (M, W, variable coefficients, planes,
CG iterations).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tpcg import reference
from tpcg.parallel import Decomposition, SchwarzPrec, make_partition
from tpcg.parallel.hsolver import build_preconditioner
from tpcg.sparse import Stencil2D
from tpcg.utils.config import HelmholtzConfig

CASES = {
    "fused-prec-vs-xla-planes": (2, 8, False, True, 120),
    "fused-prec-e2e-native": (3, 8, False, False, 120),
    "var-coef-planes": (2, 10, True, True, 80),
    "var-coef-native": (2, 10, True, False, 80),
}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_subdomain_solve_matches_oracle(case):
    M, W, var, planes, iters = case
    cfg = HelmholtzConfig(k=6.0, M_subd=M, W_subd=W, var_coeff=var,
                          mar_mult_in=2.0, mar_mult_out=1.0, use_cg=2)
    decomp = Decomposition(make_partition(M, W, cfg.overlap))
    P = build_preconditioner(cfg, decomp)
    sp = SchwarzPrec(decomp, P, cg_iterations=iters, planes=planes)
    S = decomp.part.sdsz
    rng = np.random.default_rng(M + W)
    z = (rng.standard_normal(decomp.grid_shape)
         + 1j * rng.standard_normal(decomp.grid_shape)).astype(np.complex64)
    zin = jnp.asarray(np.stack([z.real, z.imag]) if planes else z)
    got = np.asarray(sp.subdomain_solve(zin))
    if planes:
        got = got[0] + 1j * got[1]
    for i in range(M):
        for j in range(M):
            if isinstance(P, Stencil2D):
                A = P.to_scipy()
            else:
                coef, offsets = P
                A = Stencil2D(offsets, np.asarray(coef)[:, i, j],
                              (S, S)).to_scipy()
            want = reference.cg(A.astype(np.complex128),
                                z[i, j].reshape(-1).astype(np.complex128),
                                n_iterations=iters)
            err = (np.linalg.norm(got[i, j].reshape(-1) - want)
                   / np.linalg.norm(want))
            assert err < 1e-3, (i, j, err)
