"""The port's own spans in one sampler call traced with the host's ops, and
what the span readers take from them.

The port opens a profiler range named ``cdm.<layer>`` around each
layer of its DiT sampling path (the port's ``utils/profiling.py`` lists
them). Traced with the host's ops, each range lands in the kineto trace
beside the CUDA API calls (``cuda*``, ``cu*``) and the device's ops, on one
clock. So:

* each device op belongs to the innermost span that held the host when the
  CUDA API call that launched it started (the call and the op
  share a ``correlation_id``); ops of no span are the harness's own;
* the host's issue time of a step is its ``cdm.ddim.step`` span less the
  time the host stood blocked on the card's full launch queue: of each
  CUDA API call inside a step on the launching thread, what it
  took beyond the median of the calls of its name in the trace;
* each idle gap of the device is named ``<innermost span> > <host op>``,
  the host op that overlapped it most (devtrace's choice), or the op alone
  outside every span; and every gap is summed under the span that
  launched the op ending it (the card's own pause before each launch).

``of(run)`` takes that trace once a run, after the run's own traces (the
first span reader to run calls it): one call of the cell's program,
loaded anew on weights and noise of a seed of its own (``SEED``: its images
are not checked, and no time it reads depends on their values), inside
devtrace's ``bench::call`` span, its noise drawn inside ``bench::draw``,
ending in a synchronise; retaken while the trace has lost some of the
program's kernels, as devtrace does. A program that opens no span gives a
trace with no step, and the readers read None.

The breakdown's ``idle_gaps`` come from this call, not from the run's own
host+device call: ``of`` puts its gap names in ``run.trace.gaps``, which the
run prints after its readers. devtrace names a gap by the host event that
overlaps it most, and with the port's spans in the trace that is a whole
``cdm.*`` span; a cell whose metrics leave out the span readers keeps
those names. Folding the spans and the correlation ids into
``devtrace.reduce``, over the run's own host+device call, would make this
second call and its names go.
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import devtrace  # noqa: E402

PREFIX = "cdm."
STEP = "cdm.ddim.step"
DRAW = "bench::draw"
RUNTIME = "cu"    # the prefix of every CUDA API call's name
SEED = 2 ** 31 + 97


@dataclasses.dataclass
class SpanTrace:
    spans: List[Tuple[str, int, int, int]]   # (name, start, end, parent)
    ops: List[Tuple[str, float, int]]        # (name, seconds, owning span)
    blocked_s: float       # runtime calls in steps beyond their names' median
    window_s: float        # the bench::call span
    gaps: List[Tuple[str, float]]            # (span > host op, idle seconds)
    idle: Dict[str, float]   # idle seconds by the span of the op ending each

    @property
    def steps(self) -> int:
        return sum(name == STEP for name, _, _, _ in self.spans)

    def host_s(self, name: str) -> float:
        """Seconds the host spent in the spans named ``name``."""
        return sum(e - s for n, s, e, _ in self.spans if n == name) / 1e9

    def self_s(self, name: str) -> float:
        """``host_s(name)`` less what their child spans cover."""
        child = sum(e - s for _, s, e, p in self.spans
                    if p >= 0 and self.spans[p][0] == name)
        return self.host_s(name) - child / 1e9

    def by_owner(self) -> Dict[str, float]:
        """Device seconds by the name of the span that owns each op ("-":
        of no span)."""
        out = {}
        for _, sec, o in self.ops:
            key = self.spans[o][0] if o >= 0 else "-"
            out[key] = out.get(key, 0.0) + sec
        return out

    def device_s(self, *names: str) -> float:
        owned = self.by_owner()
        return sum(owned.get(name, 0.0) for name in names)


def _innermost(spans: Sequence[Tuple[str, int, int]],
               points: Sequence[int]) -> List[int]:
    """For each of ``points``, the index of the innermost of ``spans``
    (properly nested (name, start, end)) that contains it, or -1."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    out = [-1] * len(points)
    stack, j = [], 0
    for q in sorted(range(len(points)), key=points.__getitem__):
        t = points[q]
        while j < len(order) and spans[order[j]][1] <= t:
            nxt = order[j]
            while stack and spans[stack[-1]][2] < spans[nxt][1]:
                stack.pop()
            stack.append(nxt)
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def reduce(events) -> SpanTrace:
    """The span trace of one call from ``events`` (the profiler's kineto
    events of a host+device trace over one ``bench::call`` span)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    window, spans, dev, runtime, host = None, [], [], [], []
    for e in events:
        name, s, end = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if name != devtrace.SPAN and not getattr(
                    e, "is_user_annotation", lambda: False)():
                dev.append((name, s, end, e.correlation_id()))
        elif name == devtrace.SPAN:
            window = (s, end, e.start_thread_id())
        elif name.startswith(PREFIX) or name == DRAW:
            spans.append((name, s, end, e.start_thread_id()))
        else:
            host.append((name, s, end))
            if name.startswith(RUNTIME):
                runtime.append((name, s, end, e.correlation_id(),
                                e.start_thread_id()))
    if window is None:
        raise ValueError(f"no {devtrace.SPAN} span in the trace")
    w0, w1, caller = window
    spans = [(n, s, e) for n, s, e, tid in spans
             if tid == caller and w0 <= s and e <= w1]
    dev = [d for d in dev if d[2] > w0 and d[1] < w1]

    # the owner of each device op: the span its launch started in
    launch = {c: (s, tid) for _, s, _, c, tid in runtime}
    launched = [launch.get(c) for _, _, _, c in dev]
    owners = _innermost(spans, [at[0] if at else w0 - 1 for at in launched])
    ops = [(name, (e - s) / 1e9, o) for (name, s, e, _), o
           in zip(dev, owners)]

    # blocked: launching-thread runtime calls in steps past their median
    threads = {at[1] for at in launched if at}
    took = {}
    for name, s, e, _, tid in runtime:
        if tid in threads:
            took.setdefault(name, []).append((s, e - s))
    steps = np.array(sorted((s, e) for n, s, e in spans if n == STEP),
                     dtype=np.int64).reshape(-1, 2)
    blocked = 0
    for calls in took.values():
        median = statistics.median(d for _, d in calls)
        for s, d in calls:
            i = np.searchsorted(steps[:, 0], s, side="right") - 1
            if i >= 0 and s <= steps[i, 1]:
                blocked += max(0, d - median)

    iv = np.array([[max(s, w0), min(e, w1)] for _, s, e, _ in dev],
                  dtype=np.int64).reshape(-1, 2)
    busy = devtrace._union(iv)
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    edges = edges[edges[:, 1] > edges[:, 0]]

    # every gap to the span that launched the op ending it
    starting = {}
    for (s, _), o in zip(iv, owners):
        starting.setdefault(int(s), o)
    idle = {}
    for g0, g1 in edges:
        o = starting.get(int(g1), -1)
        key = spans[o][0] if o >= 0 else "-"
        idle[key] = idle.get(key, 0.0) + float(g1 - g0) / 1e9
    return SpanTrace(spans=[(n, s, e, p) for (n, s, e), p
                            in zip(spans, _parents(spans))],
                     ops=ops, blocked_s=blocked / 1e9,
                     window_s=(w1 - w0) / 1e9,
                     gaps=_name_gaps(edges, host, spans), idle=idle)


def _parents(spans: Sequence[Tuple[str, int, int]]) -> List[int]:
    """The index of each span's innermost enclosing span, or -1."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    out, stack = [-1] * len(spans), []
    for i in order:
        while stack and spans[stack[-1]][2] < spans[i][2]:
            stack.pop()
        out[i] = stack[-1] if stack else -1
        stack.append(i)
    return out


def _name_gaps(gaps: np.ndarray, host, spans, top: int = 256):
    """Idle seconds by ``<innermost span> > <host op>`` over the ``top``
    longest gaps: the host op that overlapped each gap most ("python"
    where the host ran no op), the span that held the host at the middle
    of that overlap; summed by name, the largest first."""
    if not len(gaps):
        return []
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.int64)
    ends = np.array([h[2] for h in host], dtype=np.int64)
    picked, mids = [], []
    for g0, g1 in gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:top]]:
        ov = np.minimum(ends, g1) - np.maximum(starts, g0)
        best = int(np.argmax(ov)) if len(ov) else -1
        if best >= 0 and ov[best] > 0:
            lo, hi = max(g0, starts[best]), min(g1, ends[best])
            picked.append((names[best], g1 - g0))
        else:
            lo, hi = g0, g1
            picked.append(("python", g1 - g0))
        mids.append(int((lo + hi) // 2))
    total = {}
    for (op, ns), o in zip(picked, _innermost(spans, mids)):
        name = f"{spans[o][0]} > {op}" if o >= 0 else op
        total[name] = total.get(name, 0.0) + float(ns) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])


def capture(call, draw, launches, tries: int = 10) -> SpanTrace:
    """One ``call(draw())`` under the profiler with the host's ops, inside
    ``bench::call`` (the draw inside ``bench::draw``), ending in a
    synchronise; retaken until the trace keeps as many of the program's
    kernels as ``launches()`` says it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(tries):
        before = launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(devtrace.SPAN):
                with record_function(DRAW):
                    x = draw()
                call(x)
                torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        port = sum(devtrace.PORT_KERNELS in e.name() for e in events
                   if e.device_type() == cuda)
        if port and port == launches() - before:
            return reduce(events)
        time.sleep(0.2 * (attempt + 1))
    raise RuntimeError(f"{tries} traces in a row lost device records")


def load(cell, seed: int = SEED):
    """(call, draw, launches) of ``cell``'s program on the card, loaded
    anew from ``seed``."""
    import correct
    call, _, launches = cell.program.load(cell, seed, "cuda")
    return call, lambda: correct.draw_x(cell, seed, 0, "cuda"), launches


def take(cell) -> SpanTrace:
    """The span trace of one call of ``cell`` on the card, after one
    untraced call (the caching allocator holds the call's blocks then, as
    in a run's window)."""
    call, draw, launches = load(cell)
    call(draw())
    return capture(call, draw, launches)


def of(run):
    """The run's span trace, taken once (None on a run with no trace of
    its own, or off the card). Names the run's idle gaps by span."""
    if not hasattr(run, "spans"):
        import torch
        run.spans = None
        if run.trace is not None and torch.cuda.is_available():
            run.spans = take(run.cell)
            run.trace.gaps = run.spans.gaps
    return run.spans
