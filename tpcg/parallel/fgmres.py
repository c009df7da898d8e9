"""Flexible GMRES (right-preconditioned) -- the distributed Krylov driver.

==  ``zpgmres`` (``p_h-PY_C-CL-multi-GPU.py:2837-3034``), the reference's
default Krylov method (``GMRES_VER='fgmres'``, ``:3541``): one Arnoldi
cycle with two-pass classical Gram-Schmidt, Givens-rotation update of the
Hessenberg matrix, the preconditioned basis MV stored for the flexible
solution update, and the unique-dof Hermitian ``wdot``/``norm`` for all
reductions.  (The reference's outer restart loop can never execute twice --
the inner loop always returns at ``kk == krylsize-1``, ``:3026-3031`` -- so
a single cycle is the faithful behaviour.)

Design notes:
 * Convergence control is data-dependent, so the loop runs on host, but
   each iteration's device work (preconditioner, distributed matvec,
   batched dots, basis update) is one jitted call.
 * The Krylov bases are fixed-shape ``(krylsize+1, ...)`` buffers and the
   Gram-Schmidt dots are computed against the *full* (zero-padded) basis
   with an active-column mask; this keeps a single compiled program for
   the whole solve instead of one per ``kk``.  Padded columns are zero, so
   they contribute nothing to the dots or the update.
 * The Givens scalar recurrence (order ~krylsize^2 flops total) runs on
   host in float64/complex128, like the reference's rank-local H updates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass
class FGMRESResult:
    x: object
    iterations: int
    residual_norms: List[float]
    converged: bool
    # preconditioner applications computed past the convergence point by
    # the fused-chunk mode (0 in per-iteration mode and for solves whose
    # convergence lands on a chunk boundary; bounded by chunk-1)
    wasted_applies: int = 0


def _givens(h_diag: complex, h_sub: float):
    """Construct the Givens rotation eliminating ``h_sub`` under ``h_diag``
    (``p_h-PY_C-CL-multi-GPU.py:3004-3015``)."""
    dotp = np.sqrt(abs(h_diag) ** 2 + abs(h_sub) ** 2)
    if abs(h_diag) != 0.0:
        g2 = h_sub * abs(h_diag) / (h_diag * dotp)
        g1 = abs(h_diag) / dotp
    elif abs(h_sub) != 0.0:
        g1 = 0.0
        g2 = h_sub / abs(h_sub)
    else:
        g1, g2 = 1.0, 0.0j
    return g1, g2


def _as_complex(d) -> np.ndarray:
    """Device dot result -> host complex vector.  Accepts native complex
    (K,) or two-plane (2, K) layouts."""
    d = np.asarray(d)
    if d.ndim == 2 and d.shape[0] == 2:
        return d[0] + 1j * d[1]
    return d.astype(np.complex128)


# The basis contractions below are float32 ``dot_general``s; on a GPU
# XLA may run those in TF32 (about three decimal digits) unless asked for
# full precision, which would perturb every Gram-Schmidt step.
_HIGHEST = lax.Precision.HIGHEST


def _native_lincomb(coeffs, basis: jnp.ndarray) -> jnp.ndarray:
    """Linear combination sum_i c_i basis_i; works with host numpy or
    traced coefficients."""
    return jnp.tensordot(jnp.asarray(coeffs).astype(basis.dtype), basis,
                         axes=(0, 0), precision=_HIGHEST)


def planes_lincomb(coeffs: np.ndarray, basis: jnp.ndarray) -> jnp.ndarray:
    """Complex linear combination of a two-plane basis (K, 2, ...)."""
    cr = jnp.asarray(coeffs.real.astype(basis.dtype))
    ci = jnp.asarray(coeffs.imag.astype(basis.dtype))
    return _lincomb_dev_planes(jnp.stack([cr, ci]), basis)


def _lincomb_dev_planes(cp: jnp.ndarray, basis: jnp.ndarray) -> jnp.ndarray:
    """Device-side complex lincomb: cp (2, K) planes, basis (K, 2, ...)."""
    cr, ci = cp[0], cp[1]
    vr, vi = basis[:, 0], basis[:, 1]

    def dot(c, v):
        return jnp.tensordot(c, v, (0, 0), precision=_HIGHEST)
    return jnp.stack([dot(cr, vr) - dot(ci, vi),
                      dot(cr, vi) + dot(ci, vr)])


def fgmres(matvec: Callable, b, M: Optional[Callable] = None, x0=None,
           tol: float = 1e-6, krylsize: int = 100, norm=None, wdot=None,
           lincomb=None, lincomb_dev=None, planes: Optional[bool] = None,
           jit_tail: bool = True, check_triangular: bool = False,
           chunk: int = 1, chunk_split: bool = True, operands=None,
           callback: Optional[Callable] = None) -> FGMRESResult:
    """Solve ``A x = b`` with one FGMRES cycle of up to ``krylsize`` steps.

    matvec / M : distributed operator and (flexible) preconditioner over
        arbitrary-shape arrays (the ORAS layer passes (M, M, S, S) fields,
        or (2, M, M, S, S) float planes).
    norm(v) -> float, wdot(V, v) -> batched Hermitian dots over the
        leading axis (native complex (K,) or planes (2, K) layout), and
        lincomb(host complex coeffs, V) -> sum_i c_i V_i (used for the
        final solution update); lincomb_dev(device dots, V) is its traced
        twin used inside the fused Gram-Schmidt step.  Defaults are plain
        dense complex reductions; for planes vectors pass
        ``Decomposition.norm_planes`` / ``.wdot_planes`` (lincombs are
        selected automatically from the layout).
    planes : set explicitly for float vectors whose leading axis is 2 but
        which are NOT two-plane complex (auto-detection assumes planes for
        float32 (2, ...) arrays).
    jit_tail : the per-iteration Arnoldi tail is jitted by default; host
        (non-traceable) operators are detected on the first iteration and
        fall back to eager execution automatically.
    chunk : Arnoldi steps fused per device call.  The Arnoldi recursion
        (preconditioner, matvec, 2-pass CGS, basis update) is independent
        of the Givens bookkeeping, so ``chunk`` whole steps run in ONE
        jitted program and only then does the host apply rotations and
        test convergence, so larger chunks trade host syncs per
        iteration against wasted work at convergence (1, the default of
        ``HelmholtzConfig.fgmres_chunk``, was fastest on an H100).
        Converging mid-chunk wastes at most ``chunk - 1`` preconditioner
        applications; the extra orthonormal basis columns are ignored by
        the back-substitution (y is zero past the convergence index).
        Requires a jittable M; chunk=1 reproduces the reference exactly.
    chunk_split : shrink the last chunk(s) when convergence is
        predicted imminent (from the observed contraction rate), so a
        converging solve wastes ~0 preconditioner applications.  ONE
        traced program serves every chunk size 1..chunk (the step count
        is a traced scalar gating each step's preconditioner + matvec
        with ``lax.cond``), so shrinking costs no re-trace -- only one
        extra host sync per additional (smaller) chunk.  Set
        False to accept <= chunk-1 wasted applications and the minimum
        number of host round-trips.
    operands : optional pytree of device arrays for the operator and
        preconditioner.  When given, the calling conventions become
        ``matvec(operands, x)`` and ``M(operands, z)`` and the arrays
        flow through the jitted Arnoldi programs as arguments instead of
        closure constants (which get re-embedded into the HLO on every
        fresh solve).  Callers doing REPEATED solves should always pass
        ``operands``: with plain closures every solve re-traces to a
        different program (persistent-compile-cache misses) and large
        closure-captured arrays are embedded in every compiled program.
    tol : relative to ||r0|| (``:2938-2939``).
    """
    if norm is None:
        norm = lambda v: jnp.sqrt(jnp.sum((jnp.conj(v) * v).real))
    if wdot is None:
        wdot = lambda V, v: jnp.sum(
            jnp.conj(V) * v, axis=tuple(range(1, V.ndim)))
    if lincomb is None:
        lincomb = _native_lincomb

    # ``operands`` threads the operator/preconditioner device arrays
    # through the jitted Arnoldi programs as ARGUMENTS: with plain
    # closures they are baked into the HLO as constants, which bloats
    # every re-trace and re-embeds fresh device arrays per solve.  When
    # given, ``matvec(operands, x)`` / ``M(operands, z)`` are the calling
    # conventions; the default keeps the 1-arg closure style.
    if operands is None:
        _ops = ()
        mv2 = lambda ops, x: matvec(x)
        M2 = (lambda ops, z: M(z)) if M is not None else (
            lambda ops, z: z)
    else:
        _ops = operands
        mv2 = matvec
        M2 = M if M is not None else (lambda ops, z: z)

    import jax

    b = jnp.asarray(b)
    shape, dtype = b.shape, b.dtype
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = jnp.asarray(x0, dtype=dtype)
        # the initial residual matvec runs as ONE device program like the
        # Arnoldi tail (eager dispatch launches every op separately);
        # host-side operators fall back to eager.
        if jit_tail:
            try:
                r = jax.jit(lambda ops, bb, xx: bb - mv2(ops, xx))(
                    _ops, b, x)
            except (jax.errors.TracerArrayConversionError,
                    jax.errors.ConcretizationTypeError):
                r = b - mv2(_ops, x)
        else:
            r = b - mv2(_ops, x)
    norm_b = float(norm(r))
    residual_norms = [norm_b]
    if norm_b == 0.0:
        return FGMRESResult(x, 0, residual_norms, True)
    atol = tol * norm_b

    K = krylsize
    VV = jnp.zeros((K + 1,) + shape, dtype)
    MV = jnp.zeros((K + 1,) + shape, dtype)

    beta = norm_b
    VV = VV.at[0].set(r / beta)

    H = np.zeros((K + 1, K), dtype=np.complex128)
    giv1 = np.zeros(K, dtype=np.float64)
    giv2 = np.zeros(K, dtype=np.complex128)
    s = np.zeros(K + 1, dtype=np.complex128)
    s[0] = beta

    kmask = np.arange(K + 1)
    # two-plane layout detection (leading size-2 float32 axis); pass
    # ``planes`` explicitly for float vectors that are not planes.
    planes_mode = planes if planes is not None else (
        len(shape) > 0 and shape[0] == 2 and dtype == jnp.float32)
    if lincomb_dev is None:
        lincomb_dev = (_lincomb_dev_planes if planes_mode
                       else _native_lincomb)

    def arnoldi_tail(ops, VV, MV, v, kk, active):
        """Everything after the preconditioner, fused into one device
        program: matvec, two-pass CGS, subdiagonal norm, basis update.
        One host sync per iteration (the (hcol, h_sub) fetch) instead of
        three."""
        MV = MV.at[kk].set(v)
        pp = mv2(ops, v)
        d1 = wdot(VV, pp) * active
        pp = pp - lincomb_dev(d1, VV)
        d2 = wdot(VV, pp) * active
        pp = pp - lincomb_dev(d2, VV)
        h_sub = jnp.asarray(norm(pp))
        # happy breakdown: exact convergence inside the Arnoldi step gives
        # h_sub == 0 -- keep the (zero) basis column finite instead of
        # NaN-ing it (the reference shares this flaw, :2987; deliberate fix
        # like the analogous guard in tpcg/cg.py).
        safe = jnp.where(h_sub == 0, jnp.ones_like(h_sub), h_sub)
        VV = VV.at[kk + 1].set(pp / safe.astype(pp.dtype))
        return VV, MV, jnp.asarray(d1) + jnp.asarray(d2), h_sub

    tail = jax.jit(arnoldi_tail) if jit_tail else arnoldi_tail
    # the preconditioner application must run as ONE device program --
    # eager application dispatches hundreds of tiny ops per call.
    # Host-side (non-traceable) M falls back to eager on the first call.
    M2j = jax.jit(M2) if jit_tail else M2

    def host_update(kk, hcol, h_sub):
        """Givens bookkeeping + convergence test for one new column.
        Returns the residual estimate."""
        H[: kk + 1, kk] = hcol[: kk + 1]
        # apply previous rotations to the new column (:2999-3003)
        for i in range(kk):
            t = H[i, kk]
            H[i, kk] = giv1[i] * t + np.conj(giv2[i]) * H[i + 1, kk]
            H[i + 1, kk] = giv1[i] * H[i + 1, kk] - giv2[i] * t
        g1, g2 = _givens(H[kk, kk], h_sub)
        giv1[kk], giv2[kk] = g1, g2
        H[kk, kk] = g1 * H[kk, kk] + np.conj(g2) * h_sub
        s[kk + 1] = -g2 * s[kk]
        s[kk] = g1 * s[kk]
        res = abs(s[kk + 1])
        residual_norms.append(res)
        if callback is not None:
            callback(res)
        return res

    converged = False
    wasted_applies = 0
    kk = 0
    if chunk > 1:
        # fused-chunk mode: `steps` whole Arnoldi iterations per device
        # program, host Givens afterwards (see docstring).
        adt = np.float32 if planes_mode else np.float64
        from jax import lax

        nchunk = min(chunk, K)

        def arnoldi_chunk(ops, VV, MV, kk0, nact):
            """``nchunk`` statically-unrolled Arnoldi steps; only the
            first ``nact`` (a TRACED scalar) do real work.  Inactive
            steps skip the expensive preconditioner + matvec via
            ``lax.cond`` and run the cheap CGS tail on zero vectors,
            which is a no-op by construction: the padded basis rows
            beyond the active frontier are zero, dots against a zero
            ``pp`` vanish, and ``VV/MV`` writes re-write zeros (or are
            dropped as out-of-bounds scatters past row K).  ONE traced
            program therefore serves every chunk size 1..nchunk -- the
            earlier design traced a second single-step program for the
            adaptive last-chunk split, and on one-shot processes that
            trace cost more than the preconditioner waste it saved."""
            hcols, hsubs = [], []
            for t in range(nchunk):
                kk = kk0 + t
                on = t < nact
                z = VV[kk]
                v = lax.cond(on, lambda zz: M2(ops, zz),
                             lambda zz: jnp.zeros_like(zz), z)
                active = (jnp.arange(K + 1) <= kk).astype(adt)
                MV = MV.at[kk].set(v)
                pp = lax.cond(on, lambda vv: mv2(ops, vv),
                              lambda vv: jnp.zeros_like(vv), v)
                d1 = wdot(VV, pp) * active
                pp = pp - lincomb_dev(d1, VV)
                d2 = wdot(VV, pp) * active
                pp = pp - lincomb_dev(d2, VV)
                h_sub = jnp.asarray(norm(pp))
                safe = jnp.where(h_sub == 0, jnp.ones_like(h_sub), h_sub)
                VV = VV.at[kk + 1].set(pp / safe.astype(pp.dtype))
                hcols.append(jnp.asarray(d1) + jnp.asarray(d2))
                hsubs.append(h_sub)
            return VV, MV, jnp.stack(hcols), jnp.stack(hsubs)

        import math

        chunk_fn = jax.jit(arnoldi_chunk)
        stop = False
        kk0 = 0
        last_res = norm_b
        rate = None          # observed per-iteration contraction factor
        while kk0 < K:
            steps = min(nchunk, K - kk0)
            # adaptive last-chunk shrink: predict the iterations left
            # from the observed contraction rate and run only that many
            # steps -- a mid-chunk exit then wastes no preconditioner
            # applications (each costs a full subdomain batched CG in
            # the ORAS stack).  Any steps value reuses the ONE gated
            # program (`nact` is traced), so this costs no re-trace.
            if steps > 1 and chunk_split:
                n_pred = None
                if rate is not None and 0.0 < rate < 1.0 and last_res > 0:
                    n_pred = (math.log(max(atol, 1e-300) / last_res)
                              / math.log(rate))
                if last_res < 10.0 * atol:
                    steps = 1
                elif n_pred is not None and n_pred <= steps - 0.5:
                    # round the prediction up so model error costs one
                    # extra host sync, not a whole chunk of waste
                    steps = max(1, min(steps, int(math.ceil(n_pred))))
            r_start = last_res
            VV, MV, hcols_dev, hsubs_dev = chunk_fn(
                _ops, VV, MV, jnp.asarray(kk0), steps)
            hcols_np = np.asarray(hcols_dev)
            hsubs_np = np.asarray(hsubs_dev)
            for t in range(steps):
                kk = kk0 + t
                res = host_update(kk, _as_complex(hcols_np[t]),
                                  float(hsubs_np[t]))
                last_res = res
                if res < atol or kk == K - 1:
                    converged = res < atol
                    stop = True
                    wasted_applies = steps - 1 - t
                    break
            if stop:
                break
            if r_start > 0 and last_res > 0 and last_res < r_start:
                rate = (last_res / r_start) ** (1.0 / steps)
            kk0 += steps
    else:
        for kk in range(K):
            z = VV[kk]
            try:
                v = M2j(_ops, z)
            except (jax.errors.TracerArrayConversionError,
                    jax.errors.ConcretizationTypeError):
                M2j = M2
                v = M2(_ops, z)
            # two-pass classical Gram-Schmidt against the active basis
            # (:2977-2984); padded columns are zero and contribute
            # nothing.
            active = jnp.asarray((kmask <= kk).astype(np.float32
                                                      if planes_mode
                                                      else np.float64))
            try:
                VV, MV, hcol_dev, h_sub_dev = tail(
                    _ops, VV, MV, v, jnp.asarray(kk), active)
            except jax.errors.TracerArrayConversionError:
                # host-side (non-traceable) operators: fall back to eager
                tail = arnoldi_tail
                VV, MV, hcol_dev, h_sub_dev = tail(
                    _ops, VV, MV, v, jnp.asarray(kk), active)
            res = host_update(kk, _as_complex(hcol_dev),
                              float(h_sub_dev))
            if res < atol or kk == K - 1:
                converged = res < atol
                break

    # back-substitution H y = s on the rotated triangular system, with the
    # reference's underflow guard (``zsolupcont``, :2766-2834), then the
    # flexible update x += sum_i y_i MV[i].
    m = kk + 1
    y = np.zeros(K, dtype=np.complex128)
    for j in range(m - 1, -1, -1):
        acc = s[j] - np.dot(H[j, j + 1:m], y[j + 1:m])
        if abs(acc) < abs(H[j, j]) * 1e-16:
            y[j] = 0.0
        else:
            y[j] = acc / H[j, j]
    if check_triangular:
        # ``zsolupcont(check=True)`` (:2810-2827): verify the triangular
        # solve H y = s before trusting the update.
        resid = np.abs(np.triu(H[:m, :m]) @ y[:m] - s[:m])
        bad = np.nonzero(resid > 1e-10 * max(1.0, abs(s[0])))[0]
        for j in bad:
            print(f"#### zsolup check: row {j} residual {resid[j]:.3e}"
                  "  <-- triangular solve inaccurate", flush=True)
    x = x + lincomb(y, MV[:K])
    return FGMRESResult(x, m, residual_norms, converged,
                        wasted_applies=wasted_applies)
