"""Row-sharded distributed CG over the subdomain mesh.

BASELINE config 5: the multi-device port of the plain CG solver itself
(as opposed to the ORAS/FGMRES stack): the operator is the row-sharded
global matrix (``Decomposition.ax_op`` -- local stencil + ring overwrite,
collective-permutes under sharding) and the COCG dot products reduce over
*unique* dofs only, exactly like the reference's distributed ``norm``
(``p_h-PY_C-CL-multi-GPU.py:2108-2121``) -- under ``jit`` with a sharded
mesh these become ``psum`` across devices.

State is (M, M, S, S) complex subdomain fields (or (2, M, M, S, S)
float planes); overlap copies stay consistent throughout because
both the matvec and the updates are replicated on overlaps (the input b
must be overlap-consistent, e.g. via ``Decomposition.crop_grid``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..cg import CGResult
from .halo import Decomposition


def distributed_cg(decomp: Decomposition, coef: jnp.ndarray, offsets,
                   b: jnp.ndarray, x0: Optional[jnp.ndarray] = None,
                   n_iterations: int = 10) -> CGResult:
    """Fixed-iteration COCG on the row-sharded global operator.

    coef : (noff, M, M, S, S) cropped global stencil coefficients.
    b    : (M, M, S, S) overlap-consistent RHS.
    With a gapless partition (``make_partition(strict_parity=False)``)
    the unique-dof dots equal the global dots and the residual history is
    identical to single-device ``block_cg`` on the global matrix; with the
    reference-parity partition the (quirky) unique regions skip a few
    dofs, like the reference's own ``norm``.
    """
    u = jnp.asarray(decomp._unique, b.real.dtype)

    def dot(a, c):
        return jnp.sum(a * c * u)

    def matvec(x):
        return decomp.ax_op(coef, offsets, x)

    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    delta0 = dot(r0, r0)

    def step(carry, _):
        x, r, d, delta = carry
        q = matvec(d)
        dq = dot(d, q)
        done = (delta == 0) | (dq == 0)
        alpha = jnp.where(done, 0, delta / jnp.where(done, 1, dq))
        x = x + alpha * d
        r = r - alpha * q
        delta_new = dot(r, r)
        beta = jnp.where(done, 0, delta_new / jnp.where(done, 1, delta))
        d = r + beta * d
        return (x, r, d, delta_new), jnp.sqrt(jnp.abs(delta_new))

    (x, _, _, delta), hist = lax.scan(
        step, (x0, r0, r0, delta0), None, length=n_iterations)
    history = jnp.concatenate([jnp.sqrt(jnp.abs(delta0))[None], hist])
    return CGResult(x=x, residual_history=history, delta=delta)


def distributed_cg_planes(decomp: Decomposition, coef3: jnp.ndarray,
                          offsets, b: jnp.ndarray,
                          x0: Optional[jnp.ndarray] = None,
                          n_iterations: int = 10):
    """Two-plane float variant (b: (2, M, M, S, S))."""
    from ..ops.cplx import cabs, cdiv, cmul

    u = jnp.asarray(decomp._unique, b.dtype)

    def dot(a, c):
        re = jnp.sum((a[0] * c[0] - a[1] * c[1]) * u)
        im = jnp.sum((a[0] * c[1] + a[1] * c[0]) * u)
        return jnp.stack([re, im])

    def matvec(x):
        return decomp.ax_op_planes(coef3, offsets, x)

    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    delta0 = dot(r0, r0)

    def step(carry, _):
        x, r, d, delta = carry
        q = matvec(d)
        dq = dot(d, q)
        done = (delta[0] == 0) & (delta[1] == 0) \
            | ((dq[0] == 0) & (dq[1] == 0))
        alpha = jnp.where(done, 0.0,
                          cdiv(delta, jnp.where(done, 1.0, dq)))
        a_b = alpha[:, None, None, None, None]
        x = x + cmul(a_b, d)
        r = r - cmul(a_b, q)
        delta_new = dot(r, r)
        beta = jnp.where(done, 0.0,
                         cdiv(delta_new, jnp.where(done, 1.0, delta)))
        d = r + cmul(beta[:, None, None, None, None], d)
        return (x, r, d, delta_new), jnp.sqrt(cabs(delta_new))

    (x, _, _, delta), hist = lax.scan(
        step, (x0, r0, r0, delta0), None, length=n_iterations)
    history = jnp.concatenate([jnp.sqrt(cabs(delta0))[None], hist])
    return CGResult(x=x, residual_history=history, delta=delta)
