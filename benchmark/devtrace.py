"""The device trace of a few whole sampler calls, reduced to what the
per-layer metrics read.

``capture`` runs the calls under ``torch.profiler``. For the metrics it
traces the device alone, which costs the host little, and takes the
calls' wall time on the host clock (each call ends in a synchronise). For
the breakdown of idle time it traces host and device together over one
call inside a ``bench::call`` span of the benchmark's own, and names each
long idle gap by the host op that ran through it. A trace now and then
comes back without some of its device records: where the program's own
kernels (``cdm::``) in the trace do not match the launches its counters
report, the trace is taken again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Tuple

import numpy as np

PORT_KERNELS = "cdm::"
SPAN = "bench::call"


@dataclasses.dataclass
class Trace:
    calls: int             # whole sampler calls traced
    window_s: float        # the traced calls' wall time
    busy_s: float          # union of device-op intervals in the window
    ops: List[Tuple[str, float]]            # (name, seconds) a device op
    gaps: List[Tuple[str, float]]           # (what the host ran, seconds)

    def by_name(self) -> List[Tuple[str, float]]:
        """Device seconds by op name, the largest first."""
        total = {}
        for name, sec in self.ops:
            total[name] = total.get(name, 0.0) + sec
        return sorted(total.items(), key=lambda kv: -kv[1])


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted (start, end) rows covering ``intervals``."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    out = [iv[0].copy()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append(np.array([s, e]))
    return np.array(out)


def _attribute(gaps: np.ndarray, host: List[Tuple[str, int, int]],
               top: int = 256) -> List[Tuple[str, float]]:
    """Idle seconds by the host op that overlapped each of the ``top``
    longest gaps most ("python" where the host ran no op), summed by
    name, the largest first."""
    if not len(gaps):
        return []
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.int64)
    ends = np.array([h[2] for h in host], dtype=np.int64)
    total = {}
    for g0, g1 in gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:top]]:
        ov = np.minimum(ends, g1) - np.maximum(starts, g0)
        best = int(np.argmax(ov)) if len(ov) else -1
        name = names[best] if best >= 0 and ov[best] > 0 else "python"
        total[name] = total.get(name, 0.0) + float(g1 - g0) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])


def reduce(events, calls: int, wall_s=None) -> Tuple[Trace, int]:
    """The trace of ``calls`` calls from ``events`` (the profiler's kineto
    events) and the number of the program's own kernels among its device
    ops. The window is ``wall_s`` seconds where given (a device-only
    trace), else the ``bench::call`` spans', and then its idle gaps are
    named."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, spans = [], [], []
    for e in events:
        s, e_ns, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cuda:
            # the spans' own device-side copies are no device work
            if name != SPAN and not getattr(
                    e, "is_user_annotation", lambda: False)():
                dev.append((name, s, e_ns))
        elif name == SPAN:
            spans.append((s, e_ns))
        else:
            host.append((name, s, e_ns))
    if spans:
        w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
        dev = [d for d in dev if d[2] > w0 and d[1] < w1]
    elif dev:
        w0, w1 = min(d[1] for d in dev), max(d[2] for d in dev)
    else:
        return Trace(calls, 0.0, 0.0, [], []), 0
    iv = np.array([[max(s, w0), min(e, w1)] for _, s, e in dev],
                  dtype=np.int64).reshape(-1, 2)
    busy = _union(iv)
    gaps = []
    if spans:
        edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
        gaps = _attribute(edges[edges[:, 1] > edges[:, 0]], host)
    ops = [(name, (e - s) / 1e9) for name, s, e in dev]
    trace = Trace(calls=calls,
                  window_s=(w1 - w0) / 1e9 if wall_s is None else wall_s,
                  busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
                  ops=ops, gaps=gaps)
    return trace, sum(PORT_KERNELS in name for name, _, _ in dev)


def capture(run_call: Callable[[], object], n_calls: int,
            launches: Callable[[], int], host_ops: bool = False,
            tries: int = 10):
    """Runs ``run_call()`` ``n_calls`` times under the profiler, each
    ending in a synchronise: the device alone, the window on the host
    clock; or with ``host_ops`` host and device, each call in a
    ``bench::call`` span. Retakes the trace until it keeps as many of the
    program's kernels as ``launches()`` (its counters) says it launched.
    Returns (trace, the calls' outputs of every try)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if host_ops else [])
    outs = []
    for attempt in range(tries):
        before = launches()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            start = time.perf_counter()
            for _ in range(n_calls):
                with (record_function(SPAN) if host_ops
                      else contextlib.nullcontext()):
                    outs.append(run_call())
                    torch.cuda.synchronize()
            wall_s = time.perf_counter() - start
        trace, port_ops = reduce(prof.profiler.kineto_results.events(),
                                 n_calls, None if host_ops else wall_s)
        if trace.ops and port_ops == launches() - before:
            return trace, outs
        time.sleep(0.2 * (attempt + 1))
    raise RuntimeError(f"{tries} traces in a row lost device records")
