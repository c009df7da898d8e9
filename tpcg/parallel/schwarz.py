"""One-level (Restricted) Additive Schwarz preconditioner.

==  ``as_prec`` (``p_h-PY_C-CL-multi-GPU.py:1837-2006``): solve every
subdomain's impedance block against the incoming residual, then run the
overlap exchange (RAS zeroing + overlap-add + averaging).

The reference's sub-solver dispatch (``UseCG``) maps as:

  UseCG=0 exact ``spsolve``      -> ``method="dense_lu"``: one dense LU of
     the (identical) subdomain block, batched triangular solves on device.
  UseCG=2 one batched multi-RHS GPU CG (all blocks share P[0])
                                 -> ``method="block_cg"``: the stacked
     subdomain axis *is* the RHS axis of ``tpcg.cg.block_cg`` -- exactly
     the trick the reference plays (identical equal-size blocks), with the
     fixed ``CGMaxIT`` iteration count (default 256, ``:3607``).
  UseCG=1 per-subdomain single-RHS CG -> same numerics as 2 (independent
     per-RHS recurrences make the batched solve bit-identical), so it is an
     alias here; the reference only distinguished them for GPU-dispatch
     granularity.
  UseCG=5 NumPy CG oracle        -> ``tpcg.reference.cg_early_exit`` on
     host (testing only).
  UseCG=6 multi-GPU thread fan-out -> sharding the (M, M) subdomain axes
     over the device mesh: the same ``block_cg`` call, with the batch axis
     distributed by ``jax.sharding`` instead of Python threads
     (``distribute_computations_with_threads``, ``:2142-2181``).

``Robin == 1`` (impedance blocks via ``local_rect``/``helm_fe_var``) is the
reference's default and ours; ``Robin == 0`` (reuse the cropped global A as
the subdomain operator, Dirichlet-ish) is supported by passing that
coefficient crop as ``P``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp

from ..cg import block_cg
from ..sparse import Stencil2D
from .halo import Decomposition


@dataclasses.dataclass
class SchwarzPrec:
    """z -> OL_update(P^{-1} z), batched over all subdomains.

    decomp    : Decomposition
    P         : the (shared) subdomain operator as a Stencil2D of shape
                (sdsz, sdsz), or per-subdomain coefficients
                (noff, M, M, S, S) for the variable-coefficient case.
    method    : "block_cg" (device, fixed-iteration CG, UseCG=1/2/6)
                or "dense_lu" (device, exact, UseCG=0).
    cg_iterations : fixed CG iteration count (CGMaxIT, reference :3607).
    restricted / averaging : ORAS flags (Restricted_AS / Averaging).
    """
    decomp: Decomposition
    P: object
    method: str = "block_cg"
    cg_iterations: int = 256
    cg_tol: float = 1e-5
    restricted: bool = True
    averaging: bool = True
    planes: bool = False
    _lu: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _pair: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.planes:
            self._init_planes()
            return
        if self.method == "dense_lu":
            import jax.scipy.linalg as jsl
            if isinstance(self.P, Stencil2D):
                dense = np.asarray(self.P.to_scipy().todense())
                lu, piv = jsl.lu_factor(jnp.asarray(dense))
                self._lu = (lu, piv)
            else:
                raise NotImplementedError(
                    "dense_lu needs a shared Stencil2D block")

    def _init_planes(self):
        """Two-plane setup (see tpcg/ops/cplx.py).  The planes are
        float32, or float64 when the block is complex128 and x64 is on."""
        import jax
        from ..ops.cplx import make_pair_operator
        fdt = np.float32
        if (np.asarray(self._coef()).dtype == np.complex128
                and jax.config.jax_enable_x64):
            fdt = np.float64
        self._fdt = fdt
        if isinstance(self.P, Stencil2D):
            if self.method == "dense_lu":
                # complex solve as a real 2n x 2n block system
                # [[Ar, -Ai], [Ai, Ar]] [xr; xi] = [zr; zi]
                import jax.scipy.linalg as jsl
                dense = np.asarray(self.P.to_scipy().todense())
                n = dense.shape[0]
                K = np.zeros((2 * n, 2 * n), dtype=fdt)
                K[:n, :n] = dense.real
                K[:n, n:] = -dense.imag
                K[n:, :n] = dense.imag
                K[n:, n:] = dense.real
                lu, piv = jsl.lu_factor(jnp.asarray(K))
                self._lu = (lu, piv)
            else:
                self._pair = make_pair_operator(self.P, dtype=fdt)
        else:
            if self.method == "dense_lu":
                raise NotImplementedError(
                    "dense_lu needs a shared Stencil2D block")
            coef, offsets = self.P
            c = np.asarray(coef)
            coef3 = np.stack([c.real, c.imag, c.real + c.imag]).astype(fdt)
            self._pair = (jnp.asarray(coef3), offsets)

    def _coef(self):
        return self.P.coef if isinstance(self.P, Stencil2D) else self.P[0]

    def _solve_shared(self, z2d: jnp.ndarray) -> jnp.ndarray:
        """z2d: (n_p, nrhs) -> X (n_p, nrhs) with the shared block."""
        if self.method == "dense_lu":
            import jax.scipy.linalg as jsl
            return jsl.lu_solve(self._lu, z2d)
        if self.method == "numpy":
            # host NumPy-CG subsolves per subdomain -- the reference's
            # UseCG=5 oracle mode (p_h-PY_C-CL-multi-GPU.py:1911-1918),
            # early-exit at CGtol like its NumPy CG.
            from .. import reference
            A = self.P.to_scipy()
            z = np.asarray(z2d)
            cols = [reference.cg_early_exit(A, z[:, i], tol=self.cg_tol,
                                            maxit=self.cg_iterations)
                    for i in range(z.shape[1])]
            return jnp.asarray(np.stack(cols, axis=1).astype(z.dtype))
        res = block_cg(self.P, z2d, n_iterations=self.cg_iterations)
        return res.x

    def _solve_batched_numpy(self, z: jnp.ndarray) -> jnp.ndarray:
        """Host NumPy-CG oracle (UseCG=5) for per-subdomain coefficients:
        each subdomain solves against its *own* block, early-exit at
        CGtol (``p_h-PY_C-CL-multi-GPU.py:1911-1918`` with per-subdomain
        P[i], the var-coeff first-call build at :1870-1874)."""
        from .. import reference
        coef, offsets = self.P
        c = np.asarray(coef)                      # (noff, M, M, S, S)
        zh = np.asarray(z)
        M, S = self.decomp.part.M, self.decomp.part.sdsz
        out = np.empty_like(zh)
        for i in range(M):
            for j in range(M):
                A = Stencil2D(offsets, c[:, i, j], (S, S)).to_scipy()
                out[i, j] = reference.cg_early_exit(
                    A, zh[i, j].ravel(), tol=self.cg_tol,
                    maxit=self.cg_iterations).reshape(S, S)
        return jnp.asarray(out)

    def _solve_batched_coef(self, z: jnp.ndarray) -> jnp.ndarray:
        """Per-subdomain stencil coefficients (VarCoeff path): fixed-
        iteration CG where the matvec applies each subdomain's own block."""
        coef, offsets = self.P  # (noff, M, M, S, S), offsets tuple

        def matvec(x):
            return Decomposition.apply_stencil_raw(coef, offsets, x)

        def dot(a, b):
            return jnp.sum(a * b, axis=(-2, -1))[..., None, None]

        res = block_cg(matvec, z, n_iterations=self.cg_iterations, dot=dot)
        return res.x

    # ---- two-plane path ------------------------------------------------
    def _solve_planes(self, z: jnp.ndarray) -> jnp.ndarray:
        """Subdomain solves on planes: z (2, M, M, S, S) -> same shape and
        dtype, computed in the operator's precision."""
        from ..ops.cplx import block_cg_planes

        M, S = self.decomp.part.M, self.decomp.part.sdsz
        n_p = S * S
        zdt, z = z.dtype, z.astype(self._fdt)
        if self.method == "dense_lu":
            import jax.scipy.linalg as jsl
            z2 = z.reshape(2, M * M, n_p)
            stacked = jnp.concatenate([z2[0].T, z2[1].T], axis=0)
            x = jsl.lu_solve(self._lu, stacked)       # (2 n_p, nsubd)
            return (jnp.stack([x[:n_p].T, x[n_p:].T])
                    .reshape(2, M, M, S, S).astype(zdt))
        if isinstance(self._pair, tuple):
            coef3, offsets = self._pair
            raw = self.decomp.apply_stencil_raw

            def matvec(x2d):                          # (2, n_p, nsubd)
                xg = x2d.transpose(0, 2, 1).reshape(2, M, M, S, S)
                m1 = raw(coef3[0], offsets, xg[0])
                m2 = raw(coef3[1], offsets, xg[1])
                m3 = raw(coef3[2], offsets, xg[0] + xg[1])
                yg = jnp.stack([m1 - m2, m3 - m1 - m2])
                return yg.reshape(2, M * M, n_p).transpose(0, 2, 1)
        else:
            matvec = self._pair
        z2d = z.reshape(2, M * M, n_p).transpose(0, 2, 1)
        x2d = block_cg_planes(matvec, z2d,
                              n_iterations=self.cg_iterations).x
        return x2d.transpose(0, 2, 1).reshape(2, M, M, S, S).astype(zdt)

    def subdomain_solve(self, z: jnp.ndarray) -> jnp.ndarray:
        """The subdomain solves alone, before the overlap exchange:
        (M, M, S, S) complex, or (2, M, M, S, S) planes."""
        if self.planes:
            return self._solve_planes(z)
        M, S = self.decomp.part.M, self.decomp.part.sdsz
        if isinstance(self.P, tuple):
            # honor the UseCG=5 host-oracle request for per-subdomain
            # coefficients too
            return (self._solve_batched_numpy(z) if self.method == "numpy"
                    else self._solve_batched_coef(z))
        # (M, M, S, S) -> (n_p, nsubd): subdomains become the RHS batch
        x2d = self._solve_shared(z.reshape(M * M, S * S).T)
        return x2d.T.reshape(M, M, S, S)

    def apply_with(self, pair, lu, z):
        """Apply with explicit device operands (so callers can jit with
        ``_pair``/``_lu`` as ARGUMENTS instead of closure constants, which
        would be baked into every traced program).  Bypasses ``__init__``/``__post_init__`` on purpose:
        re-running them inside a trace would redo host-side setup
        (scipy dense/LU) on traced arrays."""
        sp2 = object.__new__(SchwarzPrec)
        sp2.__dict__.update(self.__dict__)
        sp2._pair = pair
        sp2._lu = lu
        return sp2(z)

    def __call__(self, z: jnp.ndarray) -> jnp.ndarray:
        """z: (M, M, S, S) complex -> preconditioned correction, same
        shape (or (2, M, M, S, S) float planes when ``planes=True``)."""
        r = self.subdomain_solve(z)
        if self.planes:
            return self.decomp.ol_update_planes(
                r, restricted=self.restricted, averaging=self.averaging)
        return self.decomp.ol_update(r, restricted=self.restricted,
                                     averaging=self.averaging)
