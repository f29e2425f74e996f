"""The yardstick's counts against the figures PERF.md gives for them."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import counts  # noqa: E402

FLAGSHIP = dict(patch=14, dim=256, depth=4, n_heads=8, mlp_ratio=4,
                in_channels=1, img_size=28)
P4 = dict(patch=4, dim=256, depth=8, n_heads=8, mlp_ratio=4, in_channels=3,
          img_size=64)


def test_k1_count_at_the_flagship_batch_of_2048():
    assert counts.k1_flops(2048, 4, 256) / 1e9 == pytest.approx(12.92,
                                                                abs=5e-3)
    assert counts.k1_bound_s(2048, 4, 256) * 1e3 == pytest.approx(
        0.0131, abs=5e-5)


def test_k1_count_at_the_cluster_route_cell():
    assert counts.k1_flops(64, 256, 256) / 1e9 == pytest.approx(30.06,
                                                                abs=5e-3)
    assert counts.k1_bytes(64, 256, 256) / 1e6 == pytest.approx(18.35,
                                                                abs=5e-3)
    assert counts.k1_bound_s(64, 256, 256) * 1e3 == pytest.approx(
        0.0304, abs=5e-5)


def test_k1_bound_is_the_larger_of_operations_and_bytes():
    b, t, d = 32768, 4, 256
    assert counts.k1_bound_s(b, t, d) == counts.k1_flops(b, t, d) / 989e12
    b, t, d = 1, 4, 256   # one image: the weights' bytes bound it
    assert counts.k1_bound_s(b, t, d) == counts.k1_bytes(b, t, d) / 3.35e12


@pytest.mark.parametrize("model, experts, gflop", [
    (FLAGSHIP, 3, 3.905), (P4, 2, 377.07)])
def test_model_flops_per_image(model, experts, gflop):
    """Every expert's forward an image at 50 steps; the modulation once a
    step per expert adds under 1e-4 of an image at batch 32768."""
    per_image = counts.sample_flops(model, experts, 32768, 50) / 32768
    assert per_image / 1e9 == pytest.approx(gflop, abs=5e-3)


def test_the_modulation_is_charged_once_a_step_per_expert():
    one = counts.sample_flops(FLAGSHIP, 3, 1, 50)
    two = counts.sample_flops(FLAGSHIP, 3, 2, 50)
    assert one - (two - one) == 2 * 50 * 3 * 4 * 6 * 256 ** 2
