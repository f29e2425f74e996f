"""The plain reference and its weight maker on the CPU: the weights have the
layout the port's ``entry.sample`` takes and no leaf is zero, and the
reference's samples match the port's plain path (its kernels' plain
versions on CPU tensors) at a tiny DiT in float32."""

import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

from reference import dit as ref_dit  # noqa: E402
from reference import weights  # noqa: E402

# the two configurations' layouts at a tiny size: fused QKV and no labels
# (the flagship's), flax's per-head attention and a label slot (p4's)
TINY = {
    "fused": (dict(patch=7, dim=64, depth=2, n_heads=2, mlp_ratio=4,
                   in_channels=1, img_size=14, num_classes=[],
                   null_token=False, qkv_fused=True), [[], [], []]),
    "per_head": (dict(patch=4, dim=64, depth=2, n_heads=2, mlp_ratio=4,
                      in_channels=3, img_size=8, num_classes=[3],
                      null_token=False, qkv_fused=False), [[1], [2]]),
}


def leaves(tree, path=()):
    """(path, leaf) of every leaf of a nested-dict tree."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [x for k, v in tree.items() for x in leaves(v, path + (k,))]


def port_model(m):
    from composable_diffusion_models_tpu_torch.models.dit import DiT
    return DiT(patch=m["patch"], dim=m["dim"], depth=m["depth"],
               n_heads=m["n_heads"], in_channels=m["in_channels"],
               num_classes=tuple(m["num_classes"]),
               null_token=m["null_token"], qkv_fused=m["qkv_fused"],
               img_size=m["img_size"])


@pytest.mark.parametrize("layout", sorted(TINY))
def test_layout_is_the_ports(layout):
    from composable_diffusion_models_tpu_torch.convert import param_shapes
    m, labels = TINY[layout]
    tree = weights.make_experts(m, 1, 5, "cpu", torch.bfloat16)[0]
    got = {path: tuple(leaf.shape)
           for path, leaf in leaves(tree["params"])}
    want = {path: tuple(shape)
            for path, (shape, _) in param_shapes(port_model(m)).items()}
    assert got == want


@pytest.mark.parametrize("layout", sorted(TINY))
def test_every_leaf_random_at_its_scale(layout):
    m, labels = TINY[layout]
    trees = weights.make_experts(m, len(labels), 7, "cpu", torch.bfloat16)
    stds = {path: std for path, _, std in weights.leaf_specs(m)}
    for tree in trees:
        for path, leaf in leaves(tree["params"]):
            assert leaf.dtype == torch.bfloat16
            assert bool((leaf != 0).any()), f"{path} is all zeros"
            if leaf.numel() >= 1024:
                assert float(leaf.float().std()) == pytest.approx(
                    stds[path], rel=0.1), path
    a, b = (leaves(t["params"]) for t in trees[:2])
    assert not torch.equal(a[0][1], b[0][1]), "experts share their draws"


def test_same_seed_same_bits():
    m, labels = TINY["fused"]
    one, two, other = (weights.make_experts(m, 3, s, "cpu", torch.bfloat16)
                       for s in (11, 11, 12))
    for (p, x), (_, y), (_, z) in zip(*(leaves(t[2]["params"])
                                        for t in (one, two, other))):
        assert torch.equal(x, y) and not torch.equal(x, z), p


@pytest.mark.parametrize("layout", sorted(TINY))
def test_reference_matches_the_ports_plain_path(layout):
    """float32 both sides, 50 steps: the same function up to float32's
    summation order (max |diff| ~3e-5 of samples of scale 1)."""
    from composable_diffusion_models_tpu_torch import entry
    m, labels = TINY[layout]
    k = len(labels)
    trees = weights.make_experts(m, k, 3, "cpu", torch.float32)
    x = torch.randn(5, m["img_size"], m["img_size"], m["in_channels"],
                    generator=torch.Generator().manual_seed(4))
    port_labels = ((torch.tensor(labels),) if m["num_classes"] else ())
    got = entry.sample(trees, x, n_steps=50, device="cpu",
                       dtype=torch.float32, labels=port_labels,
                       model=port_model(m))
    ref = ref_dit.sample(trees, x, labels, m, 50)
    assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max())


def test_the_control_is_coarser_than_bf16():
    """The fp8 control moves the samples far more than the bf16 program's
    plain path does, at the flagship's layout."""
    from composable_diffusion_models_tpu_torch import entry
    m, labels = TINY["fused"]
    trees = weights.make_experts(m, 3, 8, "cpu", torch.bfloat16)
    x = torch.randn(8, 14, 14, 1, generator=torch.Generator().manual_seed(9))
    ref = ref_dit.sample(trees, x, labels, m, 50)
    bf16 = entry.sample(trees, x, n_steps=50, device="cpu",
                        dtype=torch.bfloat16, model=port_model(m))
    fp8 = ref_dit.sample(trees, x, labels, m, 50, fp8=True)

    def rel(a):
        return float((a - ref).norm() / ref.norm())
    assert rel(fp8) > 3 * rel(bf16)
