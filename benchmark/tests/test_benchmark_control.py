"""On the card, at each cell's own size: the control fails the check,
faults planted in the timed path fail it, the port's plain bf16 path reads
as the timed path does, and a short run passes it.

The control is the plain reference computed a precision below the one the
configurations state (bf16): every large GEMM on float8 e4m3 operands. Put
in the program's place at each cell's own size (its batch's noise, the
images a run checks), it must come out not correct on every seed. Run
with ``python -m pytest benchmark/tests -m cuda``; skips without a card.
"""

import json
import sys
from pathlib import Path

from unittest import mock

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

import correct  # noqa: E402
import run  # noqa: E402
import spec  # noqa: E402
import test_benchmark_faults as planted  # noqa: E402
from reference import weights  # noqa: E402

CELLS = ("dit_p14_d256_l4.ddim50.b32768", "dit_p4_d256_l8.ddim50.b256")


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, seed):
    card()
    cell = spec.load_cell(name)
    cfg = cell.config
    experts = weights.make_experts(
        cfg["model"], cfg["experts"], correct.sub_seed(seed, "weights"),
        "cuda", getattr(torch, cfg["serve_dtype"]))
    x = correct.draw_x(cell, seed, 0, "cuda")
    n = min(cell.traffic["check_images"], cell.traffic["batch"])
    rows = np.sort(np.random.default_rng(seed).choice(
        cell.traffic["batch"], n, replace=False))
    x = x.index_select(0, torch.as_tensor(rows, device="cuda"))
    ref = correct.reference_images(cell, experts, x)
    control = correct.reference_images(cell, experts, x, fp8=True)
    ok, shown = correct.judge(cell, correct.numbers(control, ref))
    assert not ok, shown


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(name):
    card()
    r = run.measure(spec.load_cell(name), 2 ** 31 + 21, 1.0, False)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["token_zeroed", "block_unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_at_the_cells_size_is_not_correct(name, fault):
    """A run of the benchmark's length, so that the check compares as many
    images as a run does: one token of p4's 256 zeroed reads under the
    limits on the 4 images of a single call."""
    card()
    seconds = json.loads((BENCH.parent / "BENCHMARK.json").read_text())[
        "run_seconds"]
    with planted.faults()[fault]:
        r = run.measure(spec.load_cell(name), 2 ** 31 + 31, seconds, False)
    assert not r["correct"], r["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_plain_bf16_path_reads_as_the_timed_path(name):
    """The port's bf16 path without K1 (``fused_block=False``), on a call's
    noise and weights, is as far from the reference as the timed path is:
    the gap is bf16 rounding, not K1's error."""
    card()
    from composable_diffusion_models_tpu_torch import entry
    seed = 2 ** 31 + 41
    cell = spec.load_cell(name)
    call, experts, _ = cell.program.load(cell, seed, "cuda")
    x = correct.draw_x(cell, seed, 0, "cuda")
    n = min(cell.traffic["check_images"], cell.traffic["batch"])
    rows = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(
        cell.traffic["batch"], n, replace=False)), device="cuda")
    timed = call(x).index_select(0, rows)
    real = entry.make_folded_apply
    with mock.patch.object(entry, "make_folded_apply",
                           lambda model, fused: real(model, False)):
        plain = call(x).index_select(0, rows)
    ref = correct.reference_images(cell, experts, x.index_select(0, rows))
    t, p = (correct.numbers(y, ref)["rel_err"] for y in (timed, plain))
    assert correct.judge(cell, correct.numbers(plain, ref))[0]
    assert abs(t - p) <= 0.25 * p, (t, p)
