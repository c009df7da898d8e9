"""Block conjugate-gradient solver -- the device core.

This replaces the whole L1+L2 of the reference (OpenCL kernels
``spmv/vdot/axpy/aypx/sub`` + the C/PyOpenCL hosts ``clcg.c:111-466`` /
``cl.py:44-200``).  None of the five kernels exist separately: the
iteration body below is traced once and XLA fuses the vector updates and
the dot-product reductions around the SpMV.  Where the reference pays
4 host<->device round-trips per iteration for the alpha/beta scalar math
(``clcg.c:309-416``, called out as the main bottleneck in report SVI), here
the entire fixed-iteration loop is a single on-device ``lax.scan`` -- zero
host synchronisation until the final result fetch.

Numerics match the reference exactly (see ``tpcg/reference.py`` for why the
dots are unconjugated, and why each RHS carries independent alpha/beta).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


def udot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unconjugated inner product over axis 0 (COCG bilinear form).

    Matches ``kernel/complex/vdot.cl:15`` (``cmul`` without conjugation) and
    ``helmFE_var.py:516`` (``dot(r, r)``).
    """
    return jnp.sum(a * b, axis=0)


class CGResult(NamedTuple):
    x: jnp.ndarray                 # solution, same shape as b
    residual_history: jnp.ndarray  # (n_iterations + 1, nrhs) sqrt|<r,r>|
    delta: jnp.ndarray             # final <r, r> per RHS


def _as_matvec(A) -> Callable[[jnp.ndarray], jnp.ndarray]:
    if callable(A) and not hasattr(A, "matvec"):
        return A
    return A.matvec


def _freeze_floor(abs_delta0):
    """``(floor, tiny)`` of the freeze guard shared by the CG recurrences.

    A column freezes (alpha = beta = 0, the iterate kept) once
    ``|<r,r>| <= floor``, i.e. its residual is down to eps^2 of its start
    (or ``<r0,r0>`` is 0), or once ``|<d,q>|`` is below the smallest
    normal number.  Past that point the iterate no longer changes above
    its own rounding, and running on only amplifies rounding noise: in
    float32, COCG run thousands of iterations past convergence (the
    reference's fixed-iteration protocol) breaks down on a noise pivot
    and turns to NaN.  Deliberate robustness fix over ``clcg.c:317``.
    """
    fi = jnp.finfo(abs_delta0.dtype)
    return jnp.maximum(fi.tiny, fi.eps ** 4 * abs_delta0), fi.tiny


def block_cg(A, b: jnp.ndarray, x0: Optional[jnp.ndarray] = None,
             n_iterations: int = 10, dot: Callable = udot) -> CGResult:
    """Fixed-iteration block CG: ``n_rhs`` independent CG recurrences sharing
    one SpMV per iteration (the reference's "block" mode, report SIV).

    A  : operator -- a container from ``tpcg.sparse`` or a matvec callable.
         Must map (n, nrhs)->(n, nrhs) (all our containers do).
    b  : (n,) or (n, nrhs).  Column-major multi-RHS packing at the public
         API boundary is handled by ``tpcg.api.cg``.
    x0 : initial guess, defaults to zeros.
    dot: inner product over axis 0; default unconjugated (COCG).  The
         distributed layer passes a masked+psum version here.

    Differentiable, jittable, shardable.  No convergence test -- iteration
    count is static, exactly like ``clcg.c:297``.
    """
    matvec = _as_matvec(A)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    d0 = r0
    delta0 = dot(r0, r0)

    floor, tiny = _freeze_floor(jnp.abs(delta0))

    def step(carry, _):
        x, r, d, delta = carry
        q = matvec(d)
        dq = dot(d, q)
        done = (jnp.abs(delta) <= floor) | (jnp.abs(dq) < tiny)
        alpha = jnp.where(done, 0, delta / jnp.where(done, 1, dq))
        x = x + alpha * d
        r = r - alpha * q
        delta_new = dot(r, r)
        beta = jnp.where(done, 0, delta_new / jnp.where(done, 1, delta))
        d = r + beta * d
        return (x, r, d, delta_new), jnp.sqrt(jnp.abs(delta_new))

    (x, _, _, delta), hist = lax.scan(
        step, (x0, r0, d0, delta0), None, length=n_iterations)
    res0 = jnp.sqrt(jnp.abs(delta0))
    history = jnp.concatenate([res0[None], hist], axis=0)
    return CGResult(x=x, residual_history=history, delta=delta)


def solve_in_chunks(solve: Callable, b: jnp.ndarray,
                    x0: Optional[jnp.ndarray], chunk: int):
    """Run ``solve(b_chunk, x0_chunk)`` over RHS chunks of the last axis
    of ``b`` inside one program (``lax.map``) and stitch the outputs.

    Every output leaf must carry the RHS on its last axis (``CGResult`` /
    ``CGPlanesResult`` do).  Per-RHS recurrences are independent
    (``clcg.c:317-333``), so chunking bounds the working set of large
    batches without changing any result.  Chunks are balanced: the batch
    splits into ``ceil(nrhs/chunk)`` equal chunks, zero-padded; a zero RHS
    freezes at ``delta0 == 0`` and is cut off again.
    """
    nrhs = b.shape[-1]
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if nrhs <= chunk:
        return solve(b, x0)
    nc = -(-nrhs // chunk)
    chunk = -(-nrhs // nc)
    pad = nc * chunk - nrhs
    if pad:
        widths = [(0, 0)] * (b.ndim - 1) + [(0, pad)]
        b = jnp.pad(b, widths)
        x0 = jnp.pad(x0, widths)

    def split(v):
        return jnp.moveaxis(v.reshape(v.shape[:-1] + (nc, chunk)), -2, 0)

    outs = lax.map(lambda bx: solve(*bx), (split(b), split(x0)))
    return jax.tree_util.tree_map(
        lambda o: jnp.moveaxis(o, 0, -2).reshape(
            o.shape[1:-1] + (nc * chunk,))[..., :nrhs], outs)


def cg_solve(A, b, x0=None, tol=1e-5, maxit=1000, M=None, dot: Callable = udot):
    """CG with preconditioning and on-device early exit
    (``lax.while_loop``) -- the device analogue of ``PCG``
    (``helmFE_var.py:546-586``) and the big scripts' NumPy ``CG``
    (``p_h-PY_C-CL-multi-GPU.py:1333-1364``).

    Returns ``(x, iterations)``.  Stops when ``sqrt|<r,r>|`` (max over RHS)
    drops below ``tol`` or after ``maxit`` iterations.
    M : optional preconditioner matvec/callable (applied as z = M(r)).
    """
    matvec = _as_matvec(A)
    prec = (lambda r: r) if M is None else _as_matvec(M)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)

    def cond(state):
        i, x, r, p, rho_prev, resnorm = state
        return jnp.logical_and(i < maxit, jnp.max(resnorm) >= tol)

    def body(state):
        i, x, r, p, rho_prev, _ = state
        z = prec(r)
        rho = dot(r, z)
        beta = jnp.where((i == 0) | (rho_prev == 0),
                         jnp.zeros_like(rho),
                         rho / jnp.where(rho_prev == 0, 1, rho_prev))
        p = z + beta * p
        q = matvec(p)
        pq = dot(p, q)
        # breakdown / already-converged guard (same rationale as block_cg:
        # a zero RHS column must freeze, not NaN-poison every column)
        done = (rho == 0) | (pq == 0)
        alpha = jnp.where(done, 0, rho / jnp.where(done, 1, pq))
        x = x + alpha * p
        r = r - alpha * q
        resnorm = jnp.sqrt(jnp.abs(dot(r, r)))
        return (i + 1, x, r, p, rho, resnorm)

    nrhs_shape = r0.shape[1:] if r0.ndim > 1 else ()
    big = jnp.full(nrhs_shape, jnp.inf, dtype=jnp.abs(r0).dtype)
    ones = jnp.ones(nrhs_shape, dtype=r0.dtype)
    state = (jnp.asarray(0), x0, r0, jnp.zeros_like(r0), ones, big)
    i, x, *_ = lax.while_loop(cond, body, state)
    return x, i
