"""Complex arithmetic as explicit real planes.

The reference carries complex values as OpenCL ``float2`` with hand-rolled
``cmul``/``cadd`` helpers (``kernel/complex/cmplx.h:4-25``).  This module
does the analogous thing: complex arrays are stored as a leading size-2
axis of real planes ``p[0] = re, p[1] = im``, and every complex op is
spelled out in real arithmetic.  The complex SpMV becomes three real SpMVs
via Karatsuba (with a cached ``Ar + Ai`` operator) instead of the generic
4-multiply lowering -- 25% fewer FLOPs, at the price of reading three
real coefficient planes where native complex reads two complex ones.
Native complex is the default of every entry point; planes run only when
a caller asks for them (native was faster on an H100, ``PERF.md``).

``PairOperator`` wraps any real container from ``tpcg.sparse`` (Stencil2D /
DiaMatrix / EllMatrix) pair; ``block_cg_planes`` is the fixed-iteration
block-CG recurrence over planes with the same COCG semantics as
``tpcg.cg.block_cg`` (unconjugated dots, per-RHS alpha/beta,
``clcg.c:297-419``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..cg import _freeze_floor


def to_planes(x, dtype=jnp.float32) -> jnp.ndarray:
    """complex array -> (2, ...) float planes."""
    x = np.asarray(x)
    return jnp.stack([jnp.asarray(x.real.astype(dtype)),
                      jnp.asarray(x.imag.astype(dtype))])


def from_planes(p) -> np.ndarray:
    p = np.asarray(p)
    return p[0] + 1j * p[1]


def cmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(2, ...) x (2, ...) elementwise complex multiply (``cmplx.h:18-21``
    semantics)."""
    return jnp.stack([a[0] * b[0] - a[1] * b[1],
                      a[0] * b[1] + a[1] * b[0]])


def cdiv(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Complex division with Smith-style scaling: the naive |b|^2
    denominator underflows (to a subnormal, or to zero where subnormals
    are flushed) once residuals shrink past ~1e-19 in f32, which would
    NaN a long fixed-iteration CG run."""
    m = jnp.maximum(jnp.abs(b[0]), jnp.abs(b[1]))
    ms = jnp.where(m == 0, 1.0, m)
    b0, b1 = b[0] / ms, b[1] / ms
    d = (b0 * b0 + b1 * b1) * ms
    return jnp.stack([(a[0] * b0 + a[1] * b1) / d,
                      (a[1] * b0 - a[0] * b1) / d])


def cabs(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(a[0] * a[0] + a[1] * a[1])


def udot_planes(a: jnp.ndarray, b: jnp.ndarray, axis=0) -> jnp.ndarray:
    """Unconjugated inner product (COCG bilinear form,
    ``kernel/complex/vdot.cl:15``): returns (2, ...reduced...).
    ``axis`` indexes the plane-sliced data array (a[0]), so axis=0 reduces
    the length-n axis of (2, n, nrhs) planes."""
    re = jnp.sum(a[0] * b[0] - a[1] * b[1], axis=axis)
    im = jnp.sum(a[0] * b[1] + a[1] * b[0], axis=axis)
    return jnp.stack([re, im])


@partial(jax.tree_util.register_dataclass,
         data_fields=["ar", "ai", "ars"], meta_fields=["real_only"])
@dataclasses.dataclass(frozen=True)
class PairOperator:
    """Complex linear operator A = Ar + i*Ai as two real containers, plus
    the cached Karatsuba operator Ars = Ar + Ai.

    matvec on (2, n[, nrhs]) planes:
        m1 = Ar xr ; m2 = Ai xi ; m3 = Ars (xr + xi)
        y  = (m1 - m2, m3 - m1 - m2)            [3 real SpMVs]
    For a real matrix (Ai == 0) it degrades to 2 independent SpMVs.
    """
    ar: object
    ai: object
    ars: object
    real_only: bool = False

    @property
    def n(self):
        return self.ar.shape[0]

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        xr, xi = x[0], x[1]
        if self.real_only:
            return jnp.stack([self.ar.matvec(xr), self.ar.matvec(xi)])
        m1 = self.ar.matvec(xr)
        m2 = self.ai.matvec(xi)
        m3 = self.ars.matvec(xr + xi)
        return jnp.stack([m1 - m2, m3 - m1 - m2])

    def __matmul__(self, x):
        return self.matvec(x)


def _rebuild(container, new_field_value, field):
    return dataclasses.replace(container, **{field: new_field_value})


def make_pair_operator(A, dtype=jnp.float32) -> PairOperator:
    """Split a complex container from ``tpcg.sparse`` into a PairOperator.

    Works for Stencil2D (field ``coef``), DiaMatrix (``data``) and
    EllMatrix (``vals``).
    """
    for field in ("coef", "data", "vals"):
        if hasattr(A, field):
            v = np.asarray(getattr(A, field))
            re = jnp.asarray(v.real.astype(dtype))
            im = jnp.asarray(v.imag.astype(dtype))
            real_only = not np.iscomplexobj(v) or not np.any(v.imag)
            ar = _rebuild(A, re, field)
            ai = _rebuild(A, im, field)
            ars = _rebuild(A, re + im, field)
            return PairOperator(ar, ai, ars, real_only=real_only)
    raise TypeError(f"unsupported container {type(A)}")


class CGPlanesResult(NamedTuple):
    x: jnp.ndarray                  # (2, n, nrhs)
    residual_history: jnp.ndarray   # (iters+1, nrhs)
    delta: jnp.ndarray              # (2, nrhs)


def block_cg_planes(A, b: jnp.ndarray, x0: Optional[jnp.ndarray] = None,
                    n_iterations: int = 10) -> CGPlanesResult:
    """Fixed-iteration block CG over complex planes.

    A : PairOperator or callable on (2, n, nrhs) planes.
    b : (2, n) or (2, n, nrhs).
    Identical recurrence to ``tpcg.cg.block_cg`` (COCG dots, independent
    per-RHS scalars, exact-convergence guard).
    """
    matvec = A if callable(A) and not hasattr(A, "matvec") else A.matvec
    squeeze = b.ndim == 2
    if squeeze:
        b = b[..., None]
    if x0 is None:
        x0 = jnp.zeros_like(b)
    elif x0.ndim == 2:
        x0 = x0[..., None]
    r0 = b - matvec(x0)
    d0 = r0
    delta0 = udot_planes(r0, r0, axis=0)          # (2, nrhs)

    def mag(z):                     # |z| to within sqrt(2), no underflow
        return jnp.maximum(jnp.abs(z[0]), jnp.abs(z[1]))

    floor, tiny = _freeze_floor(mag(delta0))

    def step(carry, _):
        x, r, d, delta = carry
        q = matvec(d)
        dq = udot_planes(d, q, axis=0)
        # the freeze guard of tpcg.cg.block_cg (see _freeze_floor)
        done = (mag(delta) <= floor) | (mag(dq) < tiny)
        safe_dq = jnp.where(done[None], jnp.ones_like(dq), dq)
        alpha = jnp.where(done[None], 0.0, cdiv(delta, safe_dq))
        x = x + cmul(alpha[:, None, :], d)
        r = r - cmul(alpha[:, None, :], q)
        delta_new = udot_planes(r, r, axis=0)
        safe_delta = jnp.where(done[None], jnp.ones_like(delta), delta)
        beta = jnp.where(done[None], 0.0, cdiv(delta_new, safe_delta))
        d = r + cmul(beta[:, None, :], d)
        return (x, r, d, delta_new), jnp.sqrt(cabs(delta_new))

    (x, _, _, delta), hist = lax.scan(
        step, (x0, r0, d0, delta0), None, length=n_iterations)
    history = jnp.concatenate([jnp.sqrt(cabs(delta0))[None], hist], axis=0)
    if squeeze:
        x = x[..., 0]
    return CGPlanesResult(x=x, residual_history=history, delta=delta)


def block_cg_planes_chunked(A, b: jnp.ndarray,
                            x0: Optional[jnp.ndarray] = None,
                            n_iterations: int = 10,
                            chunk: int = 32) -> CGPlanesResult:
    """Arbitrary-batch :func:`block_cg_planes`: balanced RHS chunks of at
    most ``chunk`` solved back-to-back inside one program
    (``tpcg.cg.solve_in_chunks``)."""
    from ..cg import solve_in_chunks
    if b.ndim == 2:
        return block_cg_planes(A, b, x0, n_iterations)
    return solve_in_chunks(
        lambda bb, xx: block_cg_planes(A, bb, xx, n_iterations), b, x0,
        chunk)
