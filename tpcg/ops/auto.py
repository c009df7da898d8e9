"""Planning of stencil CG solves.

``plan_stencil_cg`` inspects a ``Stencil2D`` once (host side), fixes how
the fixed-iteration block CG of the reference (``clcg.c:111-466``) runs
on it, and returns a plan whose ``solve`` runs the whole loop as one
jitted XLA program.  This mirrors the reference hosts' one-time kernel
build + buffer upload (``clcg.c:137-214``, ``cl.py:70-94``) -- planning
is the expensive step, solves are pure device execution.

Two decisions are made:

* the complex representation -- native complex (path ``"xla"``, the
  default) or float real/imag planes through the Karatsuba pair operator
  (path ``"xla-planes"``);
* RHS batch chunking -- batches wider than ``_BATCH_CHUNK`` run as
  balanced chunks inside the same program (``tpcg.cg.solve_in_chunks``),
  which bounds the working set without changing any result.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

# RHS per chunk of a batched solve.  Bounds the (n, chunk) working set of
# very wide batches; not tuned on the card yet.
_BATCH_CHUNK = 32

PATHS = ("xla", "xla-planes")


def _norm_b(b, nv, nh):
    # squeeze only for inputs WITHOUT a batch axis: an (Nv, Nh) grid or
    # a flat (Nv*Nh,) vector.  Anything else -- explicit (B, Nv, Nh),
    # flat (B*Nv*Nh,), column-stacked (B, Nv*Nh) -- keeps its batch
    # axis in the output (a ``squeeze = ndim < 3`` heuristic silently
    # returned only the first RHS for flat batches).
    b = np.asarray(b)
    squeeze = (b.shape == (nv, nh)
               or (b.ndim == 1 and b.size == nv * nh))
    B = b.reshape(-1, nv, nh)
    return B, squeeze


@dataclass
class StencilCGPlan:
    """A chosen execution path for one (stencil, n_iterations) pair."""
    path: str        # "xla" | "xla-planes"
    grid: tuple
    n_iterations: int
    _solve: Callable = field(repr=False)

    def solve(self, b, x0=None):
        """b, x0 : (Nv, Nh) or (B, Nv, Nh) arrays (flat forms accepted,
        see ``_norm_b``).

        Returns ``(x, history)`` with x shaped like b and history
        ``(n_iterations+1,)`` (single RHS) or ``(n_iterations+1, B)``.
        """
        return self._solve(b, x0)


def plan_stencil_cg(stencil, n_iterations: int,
                    path: str = "xla") -> StencilCGPlan:
    """Prepare the CG solve of ``stencil``.

    path : ``"xla"`` (the stencil's own dtype; complex stays native) or
           ``"xla-planes"`` (complex stencils only: float planes).
    """
    nv, nh = stencil.grid
    is_complex = np.iscomplexobj(np.asarray(stencil.coef))
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    if path == "xla-planes" and not is_complex:
        raise ValueError("path 'xla-planes' needs a complex stencil")
    build = _build_planes if path == "xla-planes" else _build_native
    return StencilCGPlan(path=path, grid=(nv, nh),
                         n_iterations=n_iterations,
                         _solve=build(stencil, n_iterations))


def stencil_cg(stencil, b, x0=None, n_iterations: int = 10,
               path: str = "xla"):
    """One-shot convenience: plan + solve (see :func:`plan_stencil_cg`)."""
    return plan_stencil_cg(stencil, n_iterations, path=path).solve(b, x0)


def _build_native(stencil, n_iterations):
    import jax
    import jax.numpy as jnp
    from ..cg import block_cg, solve_in_chunks

    nv, nh = stencil.grid
    n = nv * nh
    coef = np.asarray(stencil.coef)
    is_complex = np.iscomplexobj(coef)
    dt = (np.result_type(coef.dtype, np.complex64) if is_complex
          else np.result_type(coef.dtype, np.float32))
    A = jax.device_put(stencil)
    fn = jax.jit(lambda A, bm, x0m: solve_in_chunks(
        lambda bb, xx: block_cg(A, bb, xx, n_iterations=n_iterations),
        bm, x0m, _BATCH_CHUNK))

    def solve(b, x0):
        B, squeeze = _norm_b(b, nv, nh)
        bm = jnp.asarray(B.reshape(-1, n).T.astype(dt))
        x0m = (jnp.asarray(_norm_b(x0, nv, nh)[0].reshape(-1, n).T
                           .astype(dt)) if x0 is not None else None)
        res = fn(A, bm, x0m)
        x = np.asarray(res.x).T.reshape(-1, nv, nh)
        hist = np.asarray(res.residual_history)
        if squeeze:
            return x[0], hist[:, 0]
        return x, hist
    return solve


def _build_planes(stencil, n_iterations):
    import jax
    import jax.numpy as jnp
    from .cplx import block_cg_planes_chunked, make_pair_operator

    nv, nh = stencil.grid
    n = nv * nh
    Pop = make_pair_operator(stencil, dtype=jnp.float32)
    fn = jax.jit(lambda P, bp, x0p: block_cg_planes_chunked(
        P, bp, x0p, n_iterations=n_iterations, chunk=_BATCH_CHUNK))

    def to_planes(B):
        return jnp.asarray(np.stack([B.real, B.imag]).reshape(2, -1, n)
                           .transpose(0, 2, 1).astype(np.float32))

    def solve(b, x0):
        B, squeeze = _norm_b(b, nv, nh)
        bp = to_planes(B)
        x0p = (to_planes(_norm_b(x0, nv, nh)[0]) if x0 is not None
               else jnp.zeros_like(bp))
        res = fn(Pop, bp, x0p)
        x = np.asarray(res.x)                        # (2, n, B)
        hist = np.asarray(res.residual_history)
        xc = ((x[0] + 1j * x[1]).T.reshape(-1, nv, nh)
              .astype(np.complex64))
        if squeeze:
            return xc[0], hist[:, 0]
        return xc, hist
    return solve
