"""Multi-host (multi-process) entry path for the distributed solver.

The reference is SPMD from launch: ``mpirun --oversubscribe -n 5
python p_helmholtz.py`` starts one MPI rank per process and every rank
executes the same script against ``MPI.COMM_WORLD``
(``p_h-PY_C-CL-multi-GPU.py:3629-3631``; ``p_helmholtz.py:7``).  The
JAX analogue is multi-controller SPMD: one process per host, each
initialised through :func:`jax.distributed.initialize`, after which
``jax.devices()`` spans the whole cluster and a single
:class:`~jax.sharding.Mesh` over it makes the existing ``hsolver(...,
mesh=)`` path run with its collectives between all devices of the job.
No solver code changes: the sharded arrays are built with
``jax.device_put`` against a ``NamedSharding`` over the global mesh,
which transfers only each process's addressable shards.

Launch (one line per host, mirroring the mpirun contract)::

    COORDINATOR_ADDRESS=host0:1234 NUM_PROCESSES=4 PROCESS_ID=$RANK \
        python -m tpcg.cli helmholtz 4 34 2 256 --multihost

or programmatically::

    from tpcg.parallel.multihost import initialize_from_env, hsolver_multihost
    initialize_from_env()           # no-op for a single process
    res = hsolver_multihost(cfg)    # mesh over every device in the job

This module is deliberately thin: everything distributed lives in the
mesh-aware solver (``tpcg/parallel/hsolver.py``, ``halo.py``); this is
only the process-bootstrap that MPI gave the reference for free.
Verified end-to-end by ``tests/test_multihost.py::
test_two_process_distributed_solve``: two real jax.distributed
processes on localhost (CPU devices, collectives over gloo) run the
mesh-sharded solve to convergence and produce the identical replicated
solution; multi-host runs differ only in the transport.
"""
from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_from_env(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> bool:
    """Bring up the multi-controller runtime from args or environment.

    Reads ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``
    (the conventional jax.distributed env triple) when arguments are not
    given.  Managed clusters that JAX can auto-detect (SLURM, for one)
    need none of them -- ``jax.distributed.initialize()``
    auto-detects -- so when nothing is configured and auto-detection is
    unavailable we treat the job as single-process and return False.

    Returns True iff a multi-process runtime was initialised (i.e.
    ``jax.process_count() > 1`` afterwards is meaningful).
    """
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])

    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None and num_processes is None:
        # Nothing explicit: try managed-cluster auto-detection, fall
        # back to single-process silently (the common local case).
        try:
            jax.distributed.initialize()
            return jax.process_count() > 1
        except Exception:
            return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_count() > 1


def global_mesh(axis: str = "sd",
                m_subd: Optional[int] = None) -> "jax.sharding.Mesh":
    """1-D mesh over every device in the job (all hosts).

    The leading subdomain-grid axis is the only sharded axis the solver
    uses (``hsolver(mesh=)`` shards the (M, M, S, S) state on axis 0),
    so the mesh is 1-D and follows the algorithm alone: each device
    holds a contiguous block of subdomain rows and exchanges halos with
    the devices holding the rows above and below.  Within one host the
    GPUs are joined all to all, so no device order is better than
    another; devices keep JAX's default order, which keeps each host's
    devices together so that only the rows at host boundaries cross
    the slower inter-host network.

    ``m_subd``: size of the subdomain axis the solver will shard.  The
    mesh is capped to the largest device count that divides it (the same
    rule as the single-host driver) -- a 4-device job solving an M=2 grid
    runs on a 2-device mesh rather than failing the sharding check.

    Multi-process jobs: EVERY process must contribute devices to the
    mesh (a mesh missing some process's devices would leave that
    process blocked outside the collectives), so the cap must stay a
    multiple of the process count and the kept devices are taken
    evenly from each process -- nd/P per process, in process order,
    which keeps each process's devices adjacent in the mesh.  Raises when ``m_subd`` admits no such mesh size
    (relaunch with a process count that divides ``m_subd``).
    """
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()
    nproc = jax.process_count()
    nd = len(devs)
    if m_subd is not None:
        cand = [d for d in range(1, nd + 1)
                if m_subd % d == 0 and d % nproc == 0]
        if not cand:
            raise ValueError(
                f"no mesh size divides M_subd={m_subd} while spanning "
                f"all {nproc} processes; relaunch with a process count "
                f"that divides M_subd")
        nd = max(cand)
    if nproc > 1:
        by_proc = {}
        for d in devs:
            by_proc.setdefault(d.process_index, []).append(d)
        k = nd // nproc
        devs = [d for p in sorted(by_proc) for d in by_proc[p][:k]]
    return Mesh(np.asarray(devs[:nd]), (axis,))


def hsolver_multihost(cfg, callback=None):
    """Run the distributed Helmholtz solve over all hosts in the job.

    Requires ``cfg.M_subd`` to tile the mesh (the solver pads/validates
    as in the single-host mesh path).  Every process calls this with the
    same ``cfg``; results are process-replicated (the solver's outputs
    are small host arrays).
    """
    from .hsolver import hsolver
    return hsolver(cfg, mesh=global_mesh(m_subd=cfg.M_subd),
                   callback=callback)
