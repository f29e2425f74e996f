"""The trace's reduction and the per-layer readers, on made-up events."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import counts  # noqa: E402
import devtrace  # noqa: E402
import spec  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
K1 = "void cdm::fused_dit_block_bf16_kernel<32, false>"


class Event:
    def __init__(self, name, device, start, end, annotation=False):
        self._v = (name, device, start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


EVENTS = [
    Event(devtrace.SPAN, CPU, 0, 1000, True),
    Event(devtrace.SPAN, CUDA, 0, 1000, True),   # the span's device copy
    Event(devtrace.SPAN, CPU, 1100, 2000, True),
    Event(K1, CUDA, 100, 400), Event("elementwise", CUDA, 350, 500),
    Event(K1, CUDA, 1200, 1900),
    Event("aten::mul", CPU, 500, 700), Event("aten::add", CPU, 1000, 1150),
]


def test_busy_is_the_union_and_gaps_are_named():
    trace, port = devtrace.reduce(EVENTS, 2)
    assert port == 2 and len(trace.ops) == 3
    assert trace.window_s == pytest.approx(2000e-9)
    assert trace.busy_s == pytest.approx(1100e-9)   # 100-500, 1200-1900
    # gaps 0-100, 500-1200 (aten::mul overlaps it most), 1900-2000
    assert trace.gaps == [("aten::mul", pytest.approx(700e-9)),
                          ("python", pytest.approx(200e-9))]
    assert trace.by_name()[0] == (K1, pytest.approx(1000e-9))


def test_a_device_only_trace_takes_the_host_clock_window():
    device = [e for e in EVENTS if e.device_type() == CUDA]
    trace, _ = devtrace.reduce(device, 2, wall_s=3e-6)
    assert trace.window_s == 3e-6 and trace.gaps == []


def test_readers():
    cell = spec.load_cell("dit_p14_d256_l4.ddim50.b32768")
    trace, _ = devtrace.reduce(EVENTS, 2)

    class Run:
        pass
    run = Run()
    run.cell, run.trace, run.calls, run.seconds = cell, trace, 3, 2.0
    run.images, run.setup_s = 3 * 32768, 9.5
    got = {m["name"]: spec.reader(m["name"])(run)
           for m in cell.end_to_end + cell.per_layer}
    assert got["images_per_s"] == 3 * 32768 / 2.0
    assert got["setup_s"] == 9.5
    assert got["launches_per_step"] == 3 / (2 * 50)
    assert got["other_device_ms_per_step"] == pytest.approx(
        1e3 * 150e-9 / 100)
    bound = counts.k1_bound_s(32768, 4, 256)
    assert got["k1_roofline"] == pytest.approx(100 * 2 * bound / 1000e-9)
    assert got["idle_share"] == pytest.approx(100 * (1 - 1100 / 2000))
    assert got["mfu"] == pytest.approx(
        100 * 3 * counts.sample_flops(cell.config["model"], 3, 32768, 50)
        / 2.0 / 989e12)
    run.trace = None
    assert all(spec.reader(m["name"])(run) is None for m in cell.per_layer)
