"""A run with the timed path broken underneath it comes out not correct.

Each cell's run is driven on the CPU past the harness's look for a card
(``run.measure``), at the cell's layouts cut to a tiny size (D 64, two
heads, depth 2, 4 tokens, 8 images a call) and under the cell's own
limits; the port's kernels take their plain versions. A sound run is
correct; so is none of these: a DiT block that returns its state
unchanged, half of the batch left as its noise, a token zeroed where K1
produces it.
"""

import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))

import run  # noqa: E402
import spec  # noqa: E402

CELLS = ("dit_p14_d256_l4.ddim50.b32768", "dit_p4_d256_l8.ddim50.b256")
SEED = 2 ** 31 + 977


def tiny(name):
    cell = spec.load_cell(name)
    m = cell.config["model"]
    patch = 7 if m["in_channels"] == 1 else 4
    m.update(dim=64, n_heads=2, depth=2, patch=patch, img_size=2 * patch)
    cell.traffic.update(batch=8, rows_per_call=4, check_images=8,
                        ref_block=8)
    return cell


def block_unchanged(tok, *args):
    return tok.clone()


def token_zeroed(real):
    def k1(*args):
        out = real(*args)
        out[:, 0] = 0
        return out
    return k1


def half_batch(real):
    def ddim(eps_fn, schedule, x, n_steps, **kw):
        out = x.clone()
        h = x.shape[0] // 2
        out[:h] = real(eps_fn, schedule, x[:h], n_steps, **kw)
        return out
    return ddim


def faults():
    from composable_diffusion_models_tpu_torch import entry
    from composable_diffusion_models_tpu_torch.models import dit
    return {
        "block_unchanged": mock.patch.object(dit, "fused_dit_block",
                                             block_unchanged),
        "token_zeroed": mock.patch.object(
            dit, "fused_dit_block", token_zeroed(dit.fused_dit_block)),
        "half_batch": mock.patch.object(entry, "ddim",
                                        half_batch(entry.ddim)),
    }


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = run.measure(tiny(name), SEED, 0.0, False, device="cpu")
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] == 8
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["block_unchanged", "token_zeroed",
                                   "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_run_is_not_correct(name, fault):
    with faults()[fault]:
        r = run.measure(tiny(name), SEED, 0.0, False, device="cpu")
    assert not r["correct"], r["check"]


def test_nonfinite_images_fail():
    import correct
    ref = torch.ones(4, 3, 3, 1)
    got = ref.clone()
    got[2, 0, 0, 0] = float("nan")
    values = correct.numbers(got, ref)
    assert values["nonfinite"] == 1 and values["rel_err"] == float("inf")
