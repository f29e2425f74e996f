"""The port's spans on the DiT sampling path (``utils/profiling.annotate``),
on the CPU: under ``torch.profiler`` a small ``entry.sample`` opens each
``cdm.*`` span as often as the path runs its layer, nested as the path
nests them; with no profiler running ``annotate`` makes no
``RecordFunction``; and the samples are the same bits either way."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from composable_diffusion_models_tpu_torch import convert, entry
from composable_diffusion_models_tpu_torch.models.dit import DiT
from composable_diffusion_models_tpu_torch.utils import profiling

torch.set_num_threads(1)
K, DEPTH, STEPS = 2, 2, 3
MODEL = DiT(patch=7, dim=64, depth=DEPTH, n_heads=4, in_channels=1,
            qkv_fused=True, img_size=14)
# span: (times a call, its parent)
SPANS = {
    "cdm.sample": (1, None),
    "cdm.ddim.step": (STEPS, "cdm.sample"),
    "cdm.ddim.update": (STEPS, "cdm.ddim.step"),
    "cdm.blend": (STEPS, "cdm.ddim.step"),
    "cdm.dit.embed": (STEPS * K, "cdm.ddim.step"),
    "cdm.dit.fold": (STEPS * K * DEPTH, "cdm.ddim.step"),
    "cdm.dit.block": (STEPS * K * DEPTH, "cdm.ddim.step"),
    "cdm.dit.head": (STEPS * K, "cdm.ddim.step"),
}


def _sample(fused_block=True):
    trees = [convert.from_flax(convert.init_params(MODEL, seed=3 + i))
             for i in range(K)]
    x = np.random.default_rng(0).standard_normal(
        (2, 14, 14, 1)).astype(np.float32)
    return entry.sample(trees, x, n_steps=STEPS, fused_block=fused_block,
                        device="cpu", dtype=torch.float32, model=MODEL)


def _spans(prof):
    """(name, start, end, parent name) of every ``cdm.*`` span."""
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("cdm.")),
                   key=lambda s: (s[1], -s[2]))
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] < e:
            stack.pop()
        out.append((name, s, e, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


@pytest.mark.parametrize("fused_block", [True, False])
def test_each_span_opens_as_often_as_its_layer_runs(fused_block):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sample(fused_block)
    spans = _spans(prof)
    assert not any("cdm::" in name for name, _, _, _ in spans)
    for name, (times, parent) in SPANS.items():
        mine = [p for n, _, _, p in spans if n == name]
        assert len(mine) == times, name
        assert set(mine) == {parent}, name
    assert {n for n, _, _, _ in spans} == set(SPANS)


def test_annotate_is_a_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"RecordFunction({name!r}) made")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    a, b = profiling.annotate("cdm.sample"), profiling.annotate("cdm.blend")
    assert a is b
    with a:
        pass
    with pytest.raises(AssertionError, match="RecordFunction"):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.annotate("cdm.sample")


def test_samples_are_the_same_bits_under_a_profiler():
    plain = _sample()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _sample()
    assert torch.equal(plain, traced)
