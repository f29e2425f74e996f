"""The port's spans in a trace and the span readers, on made-up events:
ownership by the innermost span, the host's blocked launches, gaps named
by span, the four readers' values; and the devtrace reduction and the
accepted readers reading the same with the spans added to the events."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import devtrace  # noqa: E402
import spantrace  # noqa: E402
import spec  # noqa: E402
import test_benchmark_trace as accepted  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
K1 = accepted.K1
CALLER, LAUNCHER, OTHER = 1, 4242, 77   # thread ids


@dataclasses.dataclass
class Event:
    """A kineto event as ``devtrace`` and ``spantrace`` read it."""
    _name: str
    _device: object
    _start: int
    _end: int
    _kind: str = "cpu_op"
    _corr: int = 0
    _tid: int = CALLER

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid


def span(name, s, e):
    return Event(name, CPU, s, e, "user_annotation")


def launch(corr, s, e=None, tid=LAUNCHER, name="cudaLaunchKernel"):
    return Event(name, CPU, s, s + 10 if e is None else e, "cuda_runtime",
                 corr, tid)


def op(name, corr, s, e):
    return Event(name, CUDA, s, e, "kernel", corr)


# one call of two steps: the first runs one expert of one block, the
# second only its own op; each op launched from the span named beside it
# (the experts' forwards open no span of their own: the first step's
# cast, between the head and the blend, is the step's own)
EVENTS = [
    span(devtrace.SPAN, 0, 10000),
    Event(devtrace.SPAN, CUDA, 0, 10000, "gpu_user_annotation"),
    span(spantrace.DRAW, 10, 100),
    span("cdm.sample", 200, 9800),
    span("cdm.ddim.step", 1000, 5000),
    span("cdm.dit.embed", 1100, 1300),
    span("cdm.dit.fold", 1300, 1500),
    span("cdm.dit.block", 1500, 2500),
    span("cdm.dit.head", 2500, 2900),
    span("cdm.blend", 3000, 3300),
    span("cdm.ddim.update", 3300, 4800),
    span("cdm.ddim.step", 5000, 9000),
    Event("cdm.ddim.step", CUDA, 5000, 9000, "gpu_user_annotation"),
    launch(1, 20), op("randn", 1, 30, 60),                        # draw
    launch(2, 250), op("fill", 2, 300, 400),                      # sample
    launch(3, 1150), op("patchify", 3, 1160, 1170),               # embed
    launch(4, 1350), op("mul", 4, 1360, 1380),                    # fold
    launch(5, 1600), op(K1, 5, 1610, 2610),                       # block
    launch(6, 2600), op("sgemm", 6, 2610, 2650),                  # head
    launch(7, 2950), op("cast", 7, 2960, 2965),                   # step 1
    launch(8, 3050), op("blend", 8, 3060, 3070),                  # blend
    launch(9, 3400), op("update", 9, 3410, 3450),                 # update
    launch(10, 4900), op("stack", 10, 4910, 4920),                # step 1
    launch(11, 5100, 7100), op("add", 11, 7110, 7200),            # step 2
    # not launches: another thread's slow call, a sync outside the steps,
    # a host op whose own id is a launch's
    launch(0, 6000, 7000, tid=OTHER, name="cudaGetDevice"),
    launch(0, 9850, 9990, name="cudaDeviceSynchronize"),
    Event("aten::to", CPU, 420, 1100, "cpu_op", 5),
    Event("aten::randn", CPU, 15, 90),
]
STEPS = 2


def test_each_op_belongs_to_the_innermost_span_of_its_launch():
    t = spantrace.reduce(EVENTS)
    owner = {name: (t.spans[o][0] if o >= 0 else None)
             for name, _, o in t.ops}
    assert owner == {
        "randn": spantrace.DRAW, "fill": "cdm.sample",
        "patchify": "cdm.dit.embed", "mul": "cdm.dit.fold",
        K1: "cdm.dit.block", "sgemm": "cdm.dit.head", "cast": "cdm.ddim.step",
        "blend": "cdm.blend", "update": "cdm.ddim.update",
        "stack": "cdm.ddim.step", "add": "cdm.ddim.step"}
    parent = {n: (t.spans[p][0] if p >= 0 else None)
              for n, _, _, p in t.spans}
    assert parent["cdm.dit.fold"] == "cdm.ddim.step"
    assert parent["cdm.ddim.step"] == "cdm.sample"
    assert parent["cdm.sample"] is None
    assert t.steps == STEPS and t.window_s == pytest.approx(10000e-9)
    # cdm.sample's self time: its 9600 less the two steps' 8000
    assert t.self_s("cdm.sample") == pytest.approx(1600e-9)


def test_a_blocked_launch_is_taken_off_the_host_issue_time():
    t = spantrace.reduce(EVENTS)
    # launch 11 took 2000 against the launches' median 10; the other
    # thread's slow call and the sync outside the steps count for nothing
    assert t.blocked_s == pytest.approx(1990e-9)
    assert t.host_s(spantrace.STEP) == pytest.approx(8000e-9)


def test_gaps_are_named_by_span_and_host_op():
    t = spantrace.reduce(EVENTS)
    gaps = dict(t.gaps)
    # 400-1160: aten::to (420-1100) in cdm.sample's own time
    assert gaps["cdm.sample > aten::to"] == pytest.approx(760e-9)
    # 0-30 and 60-300: aten::randn overlaps them most, in the draw's span
    assert gaps["bench::draw > aten::randn"] == pytest.approx(270e-9)
    # 4920-7110 (the blocked launch), 3450-4910 (the first step's last
    # launch) and 2650-2960 (the cast's launch), each in a step's own time
    assert gaps["cdm.ddim.step > cudaLaunchKernel"] == pytest.approx(
        2190e-9 + 1460e-9 + 310e-9)
    # 7200-10000: the sync, outside every span
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(2800e-9)
    # by the op each gap ends at: 0-30 before randn, 60-300 before fill
    assert t.idle[spantrace.DRAW] == pytest.approx(30e-9)
    assert t.idle["cdm.sample"] == pytest.approx(240e-9)
    assert t.idle["cdm.ddim.step"] == pytest.approx(
        1460e-9 + 2190e-9 + 310e-9)
    assert t.idle["-"] == pytest.approx(2800e-9)
    assert sum(t.idle.values()) == pytest.approx(sum(gaps.values()))


class Run:
    pass


def fake_run(events, spans=None):
    run = Run()
    run.cell = spec.load_cell("dit_p14_d256_l4.ddim50.b32768")
    run.trace, _ = devtrace.reduce(events, 2)
    run.calls, run.seconds, run.images, run.setup_s = 3, 2.0, 3 * 32768, 9.5
    if spans is not None:
        run.spans = spans
    return run


def test_the_span_readers():
    run = fake_run(accepted.EVENTS, spantrace.reduce(EVENTS))
    got = {m["name"]: spec.reader(m["name"])(run)
           for m in run.cell.per_layer}
    assert got["fold_device_ms_per_step"] == pytest.approx(
        1e3 * 20e-9 / STEPS)
    assert got["embed_head_device_ms_per_step"] == pytest.approx(
        1e3 * (10e-9 + 40e-9) / STEPS)
    assert got["sampler_device_ms_per_step"] == pytest.approx(
        1e3 * (10e-9 + 40e-9 + 5e-9 + 10e-9 + 90e-9) / STEPS)
    assert got["host_issue_ms_per_step"] == pytest.approx(
        1e3 * (8000e-9 - 1990e-9) / STEPS)


def test_a_program_without_spans_reads_none():
    no_spans = [e for e in EVENTS if not e.name().startswith("cdm.")]
    run = fake_run(accepted.EVENTS, spantrace.reduce(no_spans))
    for name in ("host_issue_ms_per_step", "fold_device_ms_per_step",
                 "embed_head_device_ms_per_step",
                 "sampler_device_ms_per_step"):
        assert spec.reader(name)(run) is None
    assert spec.reader(name)(fake_run(accepted.EVENTS)) is None  # no card


def test_the_run_takes_its_span_trace_once_and_names_its_gaps(monkeypatch):
    taken = []

    def take(cell):
        taken.append(cell.name)
        return spantrace.reduce(EVENTS)
    monkeypatch.setattr(spantrace, "take", take)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    run = fake_run(accepted.EVENTS)
    for m in run.cell.per_layer:
        spec.reader(m["name"])(run)
    assert taken == [run.cell.name]
    assert run.trace.gaps == spantrace.reduce(EVENTS).gaps


def with_spans(events):
    """``events`` with the port's spans inside each ``bench::call`` span,
    their device-side copies among them."""
    out = list(events)
    for e in events:
        if e.name() == devtrace.SPAN and e.device_type() == CPU:
            s, end = e.start_ns(), e.end_ns()
            for name, a, b in (("cdm.sample", s + 1, end - 1),
                               ("cdm.ddim.step", s + 2, end - 2),
                               ("cdm.dit.block", s + 3, end - 3)):
                out += [span(name, a, b),
                        Event(name, CUDA, a, b, "gpu_user_annotation")]
    return out


def test_the_accepted_reduction_and_readers_read_the_same_with_spans():
    plain, spanned = (devtrace.reduce(ev, 2)
                      for ev in (accepted.EVENTS, with_spans(accepted.EVENTS)))
    (t0, port0), (t1, port1) = plain, spanned
    assert port0 == port1 == 2
    assert (t1.ops, t1.busy_s, t1.window_s) == (t0.ops, t0.busy_s,
                                                t0.window_s)
    a, b = fake_run(accepted.EVENTS), fake_run(with_spans(accepted.EVENTS))
    names = ("images_per_s", "setup_s", "launches_per_step",
             "other_device_ms_per_step", "k1_roofline", "idle_share", "mfu")
    assert ({n: spec.reader(n)(a) for n in names}
            == {n: spec.reader(n)(b) for n in names})


def test_devtrace_alone_names_each_gap_by_a_whole_span():
    """devtrace's own breakdown with the port's spans in the trace: the host
    event that overlaps a gap most is the span around the whole call, so
    each gap inside it goes to ``cdm.sample``. The run's printed breakdown
    takes the span trace's names instead (``spantrace.of``)."""
    plain, _ = devtrace.reduce(accepted.EVENTS, 2)
    spanned, _ = devtrace.reduce(with_spans(accepted.EVENTS), 2)
    assert plain.gaps == [("aten::mul", pytest.approx(700e-9)),
                          ("python", pytest.approx(200e-9))]
    assert spanned.gaps == [("cdm.sample", pytest.approx(900e-9))]
    alone, _ = devtrace.reduce(EVENTS, 1)
    assert alone.gaps == [("cdm.sample", pytest.approx(8615e-9)),
                          (spantrace.DRAW, pytest.approx(30e-9))]
    named = spantrace.reduce(EVENTS).gaps
    assert sum(sec for _, sec in named) == pytest.approx(8645e-9)
    assert not any(n in (s.name() for s in EVENTS
                         if s._kind == "user_annotation")
                   for n, _ in named)


# --------------------------------------------------------------- on the card
CELLS = ("dit_p14_d256_l4.ddim50.b32768", "dit_p4_d256_l8.ddim50.b256")
HOST_PACED = ("dit_p14_d256_l4.ddim50.b32768", 2048)   # busy 0.15-0.20
SPANNED = ("cdm.dit.fold", "cdm.dit.embed", "cdm.dit.head", spantrace.STEP,
           "cdm.blend", "cdm.ddim.update", "cdm.sample", spantrace.DRAW)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def traces():
    """(span trace, device-only trace) of one call at a cell's size or at
    ``batch`` images, each taken once; the first call of each warms it."""
    taken = {}

    def get(name, batch=0):
        if (name, batch) not in taken:
            cell = spec.load_cell(name)
            if batch:
                cell.traffic = {**cell.traffic, "batch": batch}
            call, draw, launches = spantrace.load(cell)
            call(draw())
            spans = spantrace.capture(call, draw, launches)
            device, _ = devtrace.capture(lambda: call(draw()), 1, launches)
            taken[name, batch] = spans, device
        return taken[name, batch]
    return get


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_every_device_op_but_the_draw_has_a_span(traces, name):
    card()
    t, _ = traces(name)
    total = sum(sec for _, sec, _ in t.ops)
    assert t.device_s("-") < 0.01 * total, t.by_owner()
    assert t.steps == spec.load_cell(name).traffic["n_steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_block_span_owns_k1(traces, name):
    card()
    t, _ = traces(name)
    k1 = sum(sec for n, sec, _ in t.ops if "fused_dit_block" in n)
    assert t.device_s("cdm.dit.block") == pytest.approx(k1, rel=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_spans_account_for_the_device_time_outside_k1(traces, name):
    """fold, embed and head, the sampler's own, ``cdm.sample``'s own and
    the noise draw make up ``other_device_ms_per_step`` of a device-only
    trace of the same call."""
    card()
    t, device = traces(name)
    other = sum(sec for n, sec in device.ops if "fused_dit_block" not in n)
    assert t.device_s(*SPANNED) == pytest.approx(other, rel=0.05)


@pytest.mark.cuda
def test_a_host_paced_call_is_the_host_issue_time(traces):
    """Where the host paces the card, it is seldom blocked, and 50 steps of
    issue time and the call's own prelude make up the call."""
    card()
    t, _ = traces(*HOST_PACED)
    step_s = t.host_s(spantrace.STEP)
    assert t.blocked_s < 0.05 * step_s
    assert (step_s - t.blocked_s + t.self_s("cdm.sample")
            == pytest.approx(t.window_s, rel=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_at_a_cells_size_the_card_paces_the_host(traces, name):
    """The host issues a step in less than the card's time a step and
    stands blocked on the full launch queue for a real share of each step.
    With the host's ops recorded the sound runs read 0.32 of the steps'
    time at the least, and an estimator that finds no wait reads 0: the
    limit lies between."""
    card()
    t, device = traces(name)
    step_s = t.host_s(spantrace.STEP)
    assert t.blocked_s > 0.15 * step_s
    device_ms = 1e3 * sum(sec for _, sec in device.ops) / t.steps
    assert 1e3 * (step_s - t.blocked_s) / t.steps < device_ms
