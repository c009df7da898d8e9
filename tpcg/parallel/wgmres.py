"""Weighted / recursive GMRES (GMRESR-style direction recycling).

==  ``weighted_gmres`` (``p_h-PY_C-CL-multi-GPU.py:3037-3291``): at each
step the new direction is ``A r`` (preconditioned), double-orthogonalised
against the stored ``Ae`` basis (the same correction applied to the ``e``
basis keeps ``Ae[k] = A e[k]``), then ``x += d e[k]``, ``r -= d Ae[k]``
with ``d = <w, r>``.  The residual is recomputed from scratch every 10
iterations (``:3278``), and the solver soft-fails on non-monotonic
residuals (factor 1.25) or ``stall_iterations`` steps of < 2.5% progress
(``:3206-3240``).

Mixed precision: the operator and the preconditioner run on the device
in the caller's dtype, while the recurrence itself -- the ``e``/``Ae``
bases, ``x``, ``r`` and every dot and norm -- runs on the host in
complex128.  The stopping test compares the *preconditioned* residual
against ``tol * ||b||``; with the reference's all-ones initial guess the
preconditioned residual starts an order of magnitude above ``||b||``, so
the test asks for a reduction near float32's unit roundoff.  A float32
recurrence stalls on its own rounding just above that target, and the
stalled Gram-Schmidt then normalises rounding noise into huge ``e``
directions that drive ``x`` to overflow.  In complex128 the recurrence
tracks the float64 solve's iteration count with float32 operators.

The price is two or more host<->device round trips of the full vector
per iteration, so the bases live in host memory and ``b`` must be
fetchable by this process: a mesh spanning several processes is refused
by ``hsolver`` (``fgmres`` keeps its recurrence on the device).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .fgmres import FGMRESResult


def weighted_gmres(matvec: Callable, b, M: Optional[Callable] = None,
                   x0=None, tol: float = 1e-6, maxiter: int = 200,
                   restart: Optional[int] = None,
                   require_monotonicity: bool = True,
                   hard_failure: bool = True,
                   no_progress_factor: float = 1.025,
                   stall_iterations: int = 10,
                   weights=None, planes: bool = False,
                   callback: Optional[Callable] = None) -> FGMRESResult:
    """Solve ``A x = b`` by weighted GMRES.

    matvec / M : device operator and (left) preconditioner on arrays
        shaped and typed like ``b``.
    weights : per-entry weights of the inner product and norm (the
        unique-dof mask of a decomposition); all ones when None.
    planes : ``b`` is a (2, ...) real/imag plane pair rather than a
        complex array; ``x`` is returned in the same layout.
    """
    if restart is None:
        restart = maxiter

    b = jnp.asarray(b)
    dev_dtype, sharding = b.dtype, b.sharding

    def to_host(v):
        v = np.asarray(v)
        if planes:
            return v[0].astype(np.float64) + 1j * v[1].astype(np.float64)
        return v.astype(np.complex128)

    def to_dev(h):                      # back in b's dtype and sharding
        if planes:
            h = np.stack([h.real, h.imag])
        return jax.device_put(h.astype(dev_dtype), sharding)

    bh = to_host(b)
    w8 = (np.ones(bh.shape) if weights is None
          else np.broadcast_to(np.asarray(weights, np.float64), bh.shape))

    def norm(v):
        return float(np.sqrt(np.sum((v.real ** 2 + v.imag ** 2) * w8)))

    def wdot(V, v):                     # conj(V_k) . v for every row k
        return (np.conj(V) * (v * w8)).reshape(len(V), -1).sum(axis=1)

    def apply_M(v):
        return v if M is None else to_host(M(to_dev(v)))

    def apply_A(v):
        return to_host(matvec(to_dev(v)))

    if x0 is None:
        x = np.zeros_like(bh)
        r = apply_M(bh)
        recalc_r = False
    else:
        x = to_host(x0)
        r = np.zeros_like(bh)
        recalc_r = True

    Ae = np.zeros((restart,) + bh.shape, np.complex128)
    e = np.zeros((restart,) + bh.shape, np.complex128)

    def result(iterations, converged):
        xd = to_dev(x)
        return FGMRESResult(xd, iterations, residual_norms, converged)

    norm_b = norm(bh)
    last = None
    stall = 0
    residual_norms = []
    kk = 0
    for iteration in range(maxiter):
        if kk == restart:
            kk = 0
            orth_count = restart
        else:
            orth_count = kk
        if recalc_r:
            r = apply_M(bh - apply_A(x))
        norm_r = norm(r)
        residual_norms.append(norm_r)
        if callback is not None and iteration > 0:
            callback(norm_r)
        if norm_r < tol * norm_b:
            return result(iteration, True)
        if last is not None:
            # the reference's "hard" mode only prints and keeps iterating
            # (its raise statements are commented out, :3206-3240); the
            # soft mode returns early with the current iterate.
            if norm_r > 1.25 * last and require_monotonicity:
                if hard_failure:
                    print("*** WARNING: non-monotonic residuals in GMRES")
                else:
                    return result(iteration, False)
            if stall_iterations and norm_r > last / no_progress_factor:
                stall += 1
                if stall >= stall_iterations:
                    if hard_failure:
                        print("*** WARNING: GMRES stalled")
                        stall = 0
                    else:
                        return result(iteration, False)
            else:
                stall = 0
        last = norm_r

        w = apply_M(apply_A(r))
        rp = r
        # rows past the active ones are zero; only the active rows count
        Aa, ea = Ae[:orth_count + 1], e[:orth_count + 1]
        for _ in range(2):
            dd = wdot(Aa, w)
            w = w - np.tensordot(dd, Aa, axes=(0, 0))
            rp = rp - np.tensordot(dd, ea, axes=(0, 0))
            nw = norm(w)
            if not 0.0 < nw < np.inf:
                # exact breakdown (A r already lies in the stored span),
                # or a diverged recurrence
                return result(iteration, False)
            w = w / nw
            rp = rp / nw
        Ae[kk] = w
        e[kk] = rp
        d = wdot(w[None], r)[0]
        recalc_r = (iteration + 1) % 10 == 0
        if not recalc_r:
            r = r - d * w
        x = x + d * e[kk]
        kk += 1
    return result(maxiter, False)
