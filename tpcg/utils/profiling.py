"""Profiling and roofline accounting.

The reference's observability is wall-clock spans + per-iteration timing
(SURVEY §5); here ``jax.profiler`` trace capture is added, plus a roofline
calculator for the CG iteration so measured GFLOPS can be judged against
the memory-bandwidth ceiling of the device (CG is bandwidth-bound).
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import time

# Peak HBM bandwidth in GB/s by ``jax.devices()[0].device_kind``.  Data-
# sheet values (NVIDIA H100 SXM5 data sheet), not measurements: no
# program reaches them, so state a roofline share with the card's power
# limit beside it.
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def hbm_peak_gbps(device_kind: str) -> float:
    """Data-sheet HBM bandwidth of ``device_kind``; raises for a device
    that is not in :data:`HBM_PEAK_GBPS` (there is no default)."""
    try:
        return HBM_PEAK_GBPS[device_kind]
    except KeyError:
        raise KeyError(f"no HBM peak recorded for device kind "
                       f"{device_kind!r}") from None


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace around a block (view with
    tensorboard-plugin-profile or xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_trace_summary(logdir: str, top: int = 8) -> dict:
    """Reduce the newest ``jax.profiler`` trace under ``logdir`` to device
    metrics.

    Device events are those on the GPU planes' stream lines (kernels and
    copies).  ``window_ns`` runs from the first device event's start to
    the last one's end; ``busy_ns`` is the union of the event intervals
    in it and ``idle_share`` is ``1 - busy / window``.  ``top`` lists the
    operations with the largest summed device time.  ``lines`` counts the
    events on every GPU line, so a reader can check what was counted.
    """
    from jax.profiler import ProfileData
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    data = ProfileData.from_file(paths[-1])
    events, lines = [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.start_ns, e.start_ns + e.duration_ns, e.name)
                   for e in line.events]
            lines[f"{plane.name} | {line.name}"] = len(evs)
            if "stream" in line.name.lower():
                events += evs
    if not events:
        return {"device_events": 0, "lines": lines}
    events.sort()
    busy, cur_s, cur_e = 0.0, events[0][0], events[0][1]
    for s, e, _ in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in events) - events[0][0]
    per_op = {}
    for s, e, name in events:
        tot, cnt = per_op.get(name, (0.0, 0))
        per_op[name] = (tot + e - s, cnt + 1)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_events": len(events), "window_ns": window,
            "busy_ns": busy, "idle_share": 1.0 - busy / window,
            "top": [{"op": k, "total_ns": v[0], "count": v[1]}
                    for k, v in ranked],
            "lines": lines}


@dataclasses.dataclass
class PhaseTimer:
    """Named wall-clock spans, like the reference's time() bracketing
    (``p_h-PY_C-CL-multi-GPU.py:3708-3712``) but structured."""
    spans: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.spans.items()})


def cg_iteration_flops(n: int, nnz: int, is_complex: bool,
                       n_rhs: int = 1) -> int:
    """FLOPs per CG iteration per report Table II:
    real: SpMV 2*nnz + 2 dots * 2n + 3 axpy * 2n;  complex: x4."""
    per = 2 * nnz + 2 * 2 * n + 3 * 2 * n
    if is_complex:
        per *= 4
    return per * n_rhs


def cg_iteration_bytes(n: int, nnz_streams: int, is_complex: bool,
                       n_rhs: int = 1, dtype_bytes: int = 4) -> int:
    """HBM bytes per iteration of a streaming CG iteration: matrix
    coefficient streams + ~6 vector reads/writes (r, d, q, x traffic).
    ``nnz_streams`` = number of real coefficient values read per
    iteration (3 * nnz for the Karatsuba planes matvec)."""
    scale = 2 if is_complex else 1
    return dtype_bytes * (nnz_streams + 6 * n * scale * n_rhs)


def roofline_fraction(measured_gflops: float, n: int, nnz: int,
                      is_complex: bool, device_kind: str,
                      n_rhs: int = 1) -> float:
    """Fraction of the HBM-bandwidth-limited GFLOPS ceiling achieved by a
    streaming CG iteration on ``device_kind``."""
    fl = cg_iteration_flops(n, nnz, is_complex, n_rhs)
    nnz_streams = 3 * nnz if is_complex else nnz
    by = cg_iteration_bytes(n, nnz_streams, is_complex, n_rhs)
    ceiling = hbm_peak_gbps(device_kind) * fl / by  # GFLOPS at full bw
    return measured_gflops / ceiling
