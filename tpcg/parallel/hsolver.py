"""Top-level distributed Helmholtz solver.

==  ``HSolver`` + the ``gmres`` dispatcher + ``counter``
(``p_h-PY_C-CL-multi-GPU.py:3341-3505, 3294-3338, 1807-1827``):

  1. build the equal-size partition (grid expanded by 2*OL, :3397-3402),
  2. assemble the global operator (Helmholtz FE const/var coeff, or the
     Poisson debug problem) and crop it per subdomain,
  3. assemble the plane-wave impedance RHS,
  4. build the ORAS preconditioner (impedance blocks, batched subdomain CG),
  5. run FGMRES / wGMRES with the iteration counter callback,
  6. verify the true residual ||A x - b|| like the reference's post-solve
     check (:3316-3337).

All device state is (M, M, S, S); pass ``mesh`` to shard the subdomain grid
over devices (the replacement for MPI ranks + the multi-GPU thread
fan-out).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..problems.helmholtz import helm_fe, helm_fe_var, local_rect
from ..problems.poisson import poisson
from ..problems.rhs import plane_wave_rhs
from ..utils.config import HelmholtzConfig
from .fgmres import fgmres
from .halo import Decomposition
from .partition import make_partition
from .schwarz import SchwarzPrec
from .wgmres import weighted_gmres


def island_wave_speed(N: int, M_subd: int, mult_in: float, mult_out: float,
                      match_subdomains: bool = True, shift: int = 0
                      ) -> np.ndarray:
    """The synthetic "1/3 island" variable-coefficient field
    (``HSolver``, ``p_h-PY_C-CL-multi-GPU.py:3404-3441``): wave speed
    ``mult_in`` on the middle-third square, ``mult_out`` outside, with the
    jump either aligned to subdomain boundaries or to the 3x3 coarse grid,
    optionally shifted NW by ``shift`` cells.  (A stand-in for the Marmousi
    model; ``UseMarmousi`` file loading is handled by the caller.)"""
    if match_subdomains:
        lft = int(M_subd / 3.0)
        rgt = int(2 * M_subd / 3.0)
        morig = np.full((M_subd, M_subd), mult_out, dtype=float)
        morig[lft:rgt, lft:rgt] = mult_in
    else:
        morig = np.full((3, 3), mult_out, dtype=float)
        morig[1, 1] = mult_in
    mx, my = morig.shape
    c = np.empty((N - 1, N - 1))
    for i in range(N - 1):
        ii = min(i + shift, N - 2)
        for j in range(N - 1):
            jj = min(j + shift, N - 2)
            c[i, j] = morig[int(ii / (N - 1) * mx), int(jj / (N - 1) * my)]
    return c


@dataclasses.dataclass
class Counter:
    """Iteration counter / per-iteration timer callback
    (``counter``, ``p_h-PY_C-CL-multi-GPU.py:1807-1827``)."""
    verbose: int = 0
    it: int = 0
    time_per_it: float = 0.0
    residuals: List[float] = dataclasses.field(default_factory=list)
    _t: float = dataclasses.field(default_factory=time.time)

    def __call__(self, z):
        self.it += 1
        dt = time.time() - self._t
        if self.it > 1:
            self.time_per_it += dt
        self.residuals.append(float(z))
        if self.verbose == 10:
            print(self.it, "--", z, " ", dt, "s", flush=True)
        elif self.verbose > 0:
            print("\r", self.it, "-->", z, end=" ", flush=True)
        self._t = time.time()
        return z


@dataclasses.dataclass
class HSolverResult:
    # (M, M, S, S) complex solution.  In planes mode this is a HOST numpy
    # array (the planes are reassembled into complex on the host).
    x: object
    iterations: int
    residual_norms: List[float]
    true_residual: float
    converged: bool
    decomp: Decomposition
    wall_time: float
    time_per_it: float
    # preconditioner applications computed past convergence by the
    # chunked FGMRES mode (see fgmres ``chunk``); ~0 on converging
    # solves thanks to the adaptive last-chunk split
    wasted_prec_applies: int = 0


def build_operator(cfg: HelmholtzConfig, decomp: Decomposition):
    """Assemble the global operator for the expanded grid and crop it to
    (noff, M, M, S, S) subdomain coefficients, plus the RHS."""
    N = decomp.part.N
    if cfg.use_poisson:
        S = poisson(N)
        b = np.ones((N, N), dtype=np.float64)
    else:
        if cfg.var_coeff:
            C = island_wave_speed(N, cfg.M_subd, cfg.mar_mult_in,
                                  cfg.mar_mult_out, cfg.mar_match,
                                  cfg.mar_shift)
            # the reference passes the absolute damping as rho here
            # (:3453: helm_fe_var(N, k, C=Marmousi, rho=epsilon)).
            S = helm_fe_var(N, cfg.k, C, cfg.epsilon)
        else:
            S = helm_fe(N, cfg.k, cfg.epsilon)
        b = plane_wave_rhs(N, cfg.k)
    coef = decomp.crop_stencil(np.asarray(S.coef))
    return S, coef, b


def build_preconditioner(cfg: HelmholtzConfig, decomp: Decomposition,
                         coef_global=None, offsets_global=None):
    """The ORAS subdomain blocks (``as_prec`` first-call setup,
    ``p_h-PY_C-CL-multi-GPU.py:1848-1906``)."""
    N, S = decomp.part.N, decomp.part.sdsz
    if cfg.robin == 1:
        if cfg.var_coeff:
            # per-subdomain impedance blocks from the cropped wave speed
            # (:1870-1874; note the reference passes rho=eps_prec1 here).
            C = island_wave_speed(N, cfg.M_subd, cfg.mar_mult_in,
                                  cfg.mar_mult_out, cfg.mar_match,
                                  cfg.mar_shift)
            M = decomp.part.M
            coefs = []
            for p in range(decomp.part.nsubd):
                r, c = decomp.part.row0[p], decomp.part.col0[p]
                blk = helm_fe_var(N, cfg.k, C[r:r + S - 1, c:c + S - 1],
                                  cfg.eps1, Nhoriz=S, Nvert=S)
                coefs.append(np.asarray(blk.coef))
            coef = np.stack(coefs, axis=1).reshape(
                (-1, M, M, S, S))
            offsets = blk.offsets
            return (jnp.asarray(coef.astype(_np_dtype(cfg))), offsets)
        return local_rect(N, cfg.k, cfg.eps1, eta=cfg.k, L=1.0,
                          Nhoriz=S, Nvert=S, dtype=_np_dtype(cfg))
    # Robin == 0: reuse the (cropped) global operator as the subdomain
    # blocks (Dirichlet-flavoured AS).  When the preconditioner damping
    # differs from the operator's, the reference assembles a separate fine
    # matrix A_eps with eps_prec1 and crops that instead
    # (p_h-PY_C-CL-multi-GPU.py:1882-1906); same here.
    if cfg.use_poisson or abs(cfg.eps1 - cfg.epsilon) < 1e-30:
        if coef_global is None or offsets_global is None:
            raise ValueError("robin=0 needs the cropped global operator")
        return (jnp.asarray(coef_global), offsets_global)
    if cfg.var_coeff:
        C = island_wave_speed(N, cfg.M_subd, cfg.mar_mult_in,
                              cfg.mar_mult_out, cfg.mar_match,
                              cfg.mar_shift)
        A_eps = helm_fe_var(N, cfg.k, C, cfg.eps1)
    else:
        A_eps = helm_fe(N, cfg.k, cfg.eps1)
    return (jnp.asarray(decomp.crop_stencil(np.asarray(A_eps.coef))),
            A_eps.offsets)


def _np_dtype(cfg: HelmholtzConfig):
    # The reference pipeline is complex throughout, even for the real
    # Poisson debug problem (complex impedance preconditioner blocks,
    # complex initial guess, MPI.COMPLEX buffers).
    return np.complex64 if cfg.dtype == "complex64" else np.complex128


def generate_random_guess(decomp: Decomposition, dtype, seed=0,
                          planes: bool = False):
    """Consistent random initial guess: random per-subdomain values made
    consistent across overlaps by a forced-averaging ``OL_update``
    (``Generate_random``, ``p_h-PY_C-CL-multi-GPU.py:2749-2763``)."""
    rng = np.random.default_rng(seed)
    shape = decomp.grid_shape
    x = rng.random(shape) + 1j * rng.random(shape)
    if planes:
        fdt = np.float32 if dtype == np.complex64 else np.float64
        xp = jnp.asarray(np.stack([x.real, x.imag]).astype(fdt))
        return decomp.ol_update_planes(xp, restricted=True, averaging=True)
    x = jnp.asarray(x.astype(dtype))
    return decomp.ol_update(x, restricted=True, averaging=True)


def hsolver(cfg: HelmholtzConfig, mesh=None,
            callback: Optional[Counter] = None) -> HSolverResult:
    dtype = _np_dtype(cfg)
    planes = cfg.use_planes
    multi_process = mesh is not None and len(
        {d.process_index for d in mesh.devices.flat}) > 1
    if multi_process and cfg.gmres_ver == "wgmres":
        raise ValueError(
            "gmres_ver='wgmres' keeps its recurrence on the host and "
            "fetches every vector there each iteration; it cannot run on "
            "a mesh spanning multiple processes, use gmres_ver='fgmres'")
    part = make_partition(cfg.M_subd, cfg.W_subd, cfg.overlap)
    decomp = Decomposition(part)
    Mg, S = part.M, part.sdsz

    Sglob, coef_np, b_global = build_operator(cfg, decomp)
    offsets = Sglob.offsets

    # OshapeD inactive-node masking: zero the RHS (and below, the initial
    # guesses) at inactive nodes (``p_h-PY_C-CL-multi-GPU.py:1429-1430,
    # 2760-2762, 3482-3484``; masks are external input there, default
    # O-shape hole here).
    inactive = None
    if cfg.oshape_d:
        from ..problems.rhs import oshape_mask
        mask_g = (np.asarray(cfg.inactive_mask)
                  if cfg.inactive_mask is not None
                  else oshape_mask(decomp.part.N))
        b_global = b_global * mask_g
        inactive = decomp.crop_grid(mask_g)

    bg = decomp.crop_grid(b_global)
    if planes:
        fdt = np.float32 if cfg.dtype == "complex64" else np.float64
        coef = jnp.asarray(np.stack([
            coef_np.real, coef_np.imag,
            coef_np.real + coef_np.imag]).astype(fdt))
        b = jnp.asarray(np.stack([bg.real, bg.imag]).astype(fdt))
    else:
        coef = jnp.asarray(coef_np.astype(dtype))
        b = jnp.asarray(bg.astype(dtype))

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        lead = (None,) if planes else ()
        coef_spec = P(*(lead + (None, "sd")))
        state_spec = P(*(lead + ("sd",)))
        coef = jax.device_put(coef, NamedSharding(mesh, coef_spec))
        b = jax.device_put(b, NamedSharding(mesh, state_spec))

    # NB: coef is passed as a jit ARGUMENT, not a closure constant --
    # closures bake device arrays into the HLO as constants, so every
    # hsolver() call would trace and compile a new program.
    if planes:
        _ax_j = jax.jit(
            lambda c, x: decomp.ax_op_planes(c, offsets, x))
        matvec = lambda x: _ax_j(coef, x)
        norm = jax.jit(decomp.norm_planes)
        wdot = jax.jit(decomp.wdot_planes)
        from .fgmres import planes_lincomb as lincomb
    else:
        _ax_j = jax.jit(lambda c, x: decomp.ax_op(c, offsets, x))
        matvec = lambda x: _ax_j(coef, x)
        norm = jax.jit(decomp.norm)
        wdot = jax.jit(decomp.wdot)
        lincomb = None

    prec = None
    if cfg.as_prec == 1:
        P_block = build_preconditioner(cfg, decomp, coef_np, offsets)
        method = {0: "dense_lu", 1: "block_cg", 2: "block_cg",
                  5: "numpy", 6: "block_cg"}.get(cfg.use_cg, "block_cg")
        if method == "numpy" and planes:
            method = "block_cg"   # host oracle mode is complex-only
        if method == "numpy" and multi_process:
            raise ValueError(
                "UseCG=5 (host NumPy oracle preconditioner) fetches "
                "device state to the host every application and cannot "
                "run on a mesh spanning multiple processes; use UseCG "
                "in {0, 1, 2, 6}")
        sp = SchwarzPrec(decomp, P_block, method=method,
                         cg_iterations=cfg.cg_max_it, cg_tol=cfg.cg_tol,
                         restricted=cfg.restricted_as,
                         averaging=bool(cfg.averaging), planes=planes)
        # the UseCG=5 host-NumPy oracle mode cannot be jitted
        if method == "numpy":
            prec = sp.__call__
        else:
            # device operands (_pair / _lu) go in as jit ARGUMENTS --
            # see the matvec note above
            # NB: the tuple-_pair case (var_coeff / robin=0 planes mode)
            # carries STATIC stencil offsets alongside the coefficient
            # planes -- those must not ride through jit as leaves (int
            # offsets would become tracers and crash the static shift
            # logic); only arrays go in the argument pytree.
            if isinstance(sp._pair, tuple):
                _c3, _offs = sp._pair
                _prec_j = jax.jit(
                    lambda c3, lu, z: sp.apply_with((c3, _offs), lu, z))
                prec = lambda z: _prec_j(_c3, sp._lu, z)
            else:
                _prec_j = jax.jit(
                    lambda pair, lu, z: sp.apply_with(pair, lu, z))
                prec = lambda z: _prec_j(sp._pair, sp._lu, z)

    state_shape = ((2,) if planes else ()) + decomp.grid_shape
    sdt = b.dtype
    if cfg.guess == 1:
        if planes:
            x0 = jnp.concatenate([jnp.ones((1,) + decomp.grid_shape, sdt),
                                  jnp.zeros((1,) + decomp.grid_shape, sdt)])
        else:
            x0 = jnp.ones(state_shape, sdt)
    elif cfg.guess == 2:
        x0 = generate_random_guess(decomp, dtype, cfg.seed, planes=planes)
    else:
        x0 = None
    if inactive is not None and x0 is not None:
        # masking happens after the consistency OL_update, like the
        # reference's Generate_random (:2760-2762)
        m = jnp.asarray(inactive).astype(x0.dtype)
        x0 = x0 * (m[None] if planes else m)

    if callback is None:
        callback = Counter(verbose=0)

    t0 = time.time()
    if cfg.gmres_ver == "wgmres":
        res = weighted_gmres(matvec, b, M=prec, x0=x0, tol=cfg.tol,
                             maxiter=cfg.restart,
                             weights=decomp.unique_weights(),
                             planes=planes, callback=callback)
    else:
        chunk = cfg.fgmres_chunk
        if chunk > 1 and prec is not None and cfg.use_cg == 5:
            chunk = 1          # host-oracle preconditioner is unjittable
        # operands convention: the coefficient planes and preconditioner
        # arrays ride fgmres's jitted Arnoldi programs as ARGUMENTS (see
        # the matvec note above -- closure constants re-embed device
        # arrays on every solve)
        if planes:
            mv_ops = lambda ops, x: decomp.ax_op_planes(ops[0], offsets,
                                                        x)
        else:
            mv_ops = lambda ops, x: decomp.ax_op(ops[0], offsets, x)
        M_ops = None
        prec_arrays = (None, None)
        if prec is not None:
            if method == "numpy":
                M_ops = lambda ops, z: sp(z)
            elif isinstance(sp._pair, tuple):
                _c3o, _offso = sp._pair
                M_ops = lambda ops, z: sp.apply_with((ops[1], _offso),
                                                     ops[2], z)
                prec_arrays = (_c3o, sp._lu)
            else:
                M_ops = lambda ops, z: sp.apply_with(ops[1], ops[2], z)
                prec_arrays = (sp._pair, sp._lu)
        operands = (coef,) + prec_arrays
        res = fgmres(mv_ops, b, M=M_ops, x0=x0, tol=cfg.tol,
                     krylsize=cfg.restart, norm=norm, wdot=wdot,
                     lincomb=lincomb, planes=planes, chunk=chunk,
                     chunk_split=cfg.fgmres_chunk_split,
                     operands=operands, callback=callback)
    wall = time.time() - t0

    if multi_process:
        # Multi-process mesh: the solution is sharded across hosts and
        # a plain host fetch of non-addressable shards raises.
        # Replicate it (one XLA all-gather over the mesh) so every
        # process holds the full field -- the analogue of the
        # reference's rank-wise gather at solve end.
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(mesh, PartitionSpec())
        res = dataclasses.replace(
            res, x=jax.jit(lambda a: a, out_shardings=rep)(res.x))

    # post-solve true-residual verification (:3316-3337)
    true_res = float(norm(matvec(res.x) - b))
    if x0 is None:
        ref = float(norm(b))
    else:
        ref = float(norm(matvec(x0) - b))
    if true_res > cfg.tol * ref and cfg.verbose:
        print("############ did it converge to the solution????  <--------")
        print("#### norm(A*x-b)=", true_res, "tol=", cfg.tol)
        print("#### tol*||r0||=", cfg.tol * ref)

    x_out = res.x
    if planes:
        xp = np.asarray(res.x)
        x_out = (xp[0] + 1j * xp[1]).astype(dtype)

    its = callback.it if callback.it else res.iterations
    tpi = callback.time_per_it / max(its - 1, 1)
    return HSolverResult(x=x_out, iterations=its,
                         residual_norms=res.residual_norms,
                         true_residual=true_res, converged=res.converged,
                         decomp=decomp, wall_time=wall, time_per_it=tpi,
                         wasted_prec_applies=getattr(res,
                                                     "wasted_applies", 0))
