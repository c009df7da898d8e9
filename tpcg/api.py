"""Drop-in API surface of the reference's C solver.

``cg`` mirrors ``clcg::cg`` (``clcg.h:3-5``, ``clcg.c:111-466``) and the
PyOpenCL host ``cl.CG`` (``cl.py:44-200``): CSR arrays in, solution out,
with the reference's column-major multi-RHS packing ``v[i + r*size]``
(``clcg.c:14-25``).  Internally the matrix is converted once to a device
container (``tpcg.sparse.to_device_matrix``) and the whole
fixed-iteration loop runs on device as one XLA program.

Deliberate fixes vs the reference (SURVEY §"Quirks"):
  * real inputs keep their float dtype (``cl.py:61`` wrongly used
    ``np.intc``);
  * no per-call kernel rebuild for ``n_rhs == 1`` (``cl.py:45``);
  * works for any ``size`` (the reference required
    ``size >= LOCAL_SIZE == 256``, ``clcg.c:123``).
"""
from __future__ import annotations

import numpy as np

from .cg import block_cg
from .sparse import to_device_matrix


def _solve_planes(A, B, X0, n_iterations):
    """Complex solve as two float planes (``tpcg.ops.cplx``).  complex128
    inputs run in float64 planes when x64 is enabled, else float32."""
    import jax
    import jax.numpy as jnp
    from .ops.cplx import (block_cg_planes_chunked, from_planes,
                           make_pair_operator, to_planes)

    dtype = np.asarray(B).dtype
    fdt = (jnp.float64 if dtype == np.complex128
           and jax.config.jax_enable_x64 else jnp.float32)
    Pop = make_pair_operator(A, dtype=fdt)
    res = block_cg_planes_chunked(
        Pop, to_planes(B, fdt),
        to_planes(X0, fdt) if X0 is not None else None,
        n_iterations=n_iterations)
    X = from_planes(np.asarray(res.x)).astype(dtype)
    return X, np.asarray(res.residual_history)


def _solve_native(A, B, X0, n_iterations):
    """Real or native-complex solve on the matrix's own dtype."""
    import jax.numpy as jnp
    result = block_cg(A, jnp.asarray(B),
                      jnp.asarray(X0) if X0 is not None else None,
                      n_iterations=n_iterations)
    return np.asarray(result.x), np.asarray(result.residual_history)


def _solve(A, B, X0, n_iterations, is_complex, planes):
    if is_complex and planes:
        return _solve_planes(A, B, X0, n_iterations)
    return _solve_native(A, B, X0, n_iterations)


def _unpermute(X, perm):
    if perm is None:
        return X
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return X[inv]


def cg(size: int, non_zeros: int, a_values, b, a_pointers, a_cols, x=None,
       n_rhs: int = 1, n_iterations: int = 10, is_complex=None,
       record_history: bool = False, planes: bool = False):
    """Solve ``A X = B`` with ``n_iterations`` of block CG.

    a_values/a_pointers/a_cols : CSR arrays (len nnz / size+1 / nnz).
    b, x : length ``size * n_rhs``, column-major RHS stacking
           (``v[i + r*size]``); ``x`` is the initial guess (zeros if None).
    is_complex : inferred from dtypes when None (the C API's explicit flag,
           ``clcg.h:5``, is accepted for parity).
    planes : run a complex system as float real/imag planes
           (``tpcg.ops.cplx``) instead of native complex.
    Returns the solution with the same packing (and the per-RHS residual
    history when ``record_history``).
    """
    import scipy.sparse as sp

    a_values = np.asarray(a_values)
    b = np.asarray(b)
    if is_complex is None:
        is_complex = np.iscomplexobj(a_values) or np.iscomplexobj(b)
    dtype = np.complex64 if is_complex else np.float32
    if a_values.dtype in (np.complex128, np.float64):
        dtype = np.complex128 if is_complex else np.float64

    A_sci = sp.csr_matrix((a_values.astype(dtype), np.asarray(a_cols),
                           np.asarray(a_pointers)), shape=(size, size))
    # banded (possibly after RCM reordering) -> gather-free DIA layout,
    # else the ELL gather layout; residual histories are
    # permutation-invariant, so reordering is transparent here.
    A, perm = to_device_matrix(A_sci, reorder=True)
    B = np.asarray(b, dtype=dtype).reshape(n_rhs, size).T      # (n, nrhs)
    X0 = np.asarray(x, dtype=dtype).reshape(n_rhs, size).T \
        if x is not None else None
    if perm is not None:
        B = B[perm]
        X0 = X0[perm] if X0 is not None else None
    X, history = _solve(A, B, X0, n_iterations, is_complex, planes)
    out = _unpermute(X, perm).T.reshape(-1)                    # column-major
    if record_history:
        return out, history
    return out


def cg_matrix(A, b, x=None, n_rhs=None, n_iterations=10,
              record_history=False, planes=False):
    """Convenience wrapper: scipy matrix / device container in, same
    column-major packing semantics (and ``planes`` option) as ``cg``."""
    import scipy.sparse as sp

    perm = None
    n = A.shape[0]
    if sp.issparse(A):
        # same RCM policy as ``cg``: a shuffled banded matrix lands on the
        # gather-free DIA path through every entry point
        A, perm = to_device_matrix(sp.csr_matrix(A), reorder=True)
    b = np.asarray(b)
    n_rhs = n_rhs or (b.size // n)
    B = b.reshape(n_rhs, n).T
    X0 = np.asarray(x).reshape(n_rhs, n).T if x is not None else None
    if perm is not None:
        B = B[perm]
        X0 = X0[perm] if X0 is not None else None
    # a complex matrix with a real RHS still needs the complex solve
    is_complex = (np.iscomplexobj(B)
                  or np.issubdtype(np.dtype(A.dtype), np.complexfloating))
    if is_complex and not np.iscomplexobj(B):
        B = B.astype(np.result_type(B.dtype, A.dtype))
        X0 = X0.astype(B.dtype) if X0 is not None else None
    X, history = _solve(A, B, X0, n_iterations, is_complex, planes)
    out = np.asarray(_unpermute(X, perm)).T.reshape(-1)
    if record_history:
        return out, history
    return out
