"""Port parity for the UNet: the weight bridge, the building blocks and the
whole forward against the JAX package's flax modules, on the same numpy
weights and inputs (small widths: base 8, 16 x 16 images)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composable_diffusion_models_tpu.models import unet as junet
from composable_diffusion_models_tpu.models.embeddings import (
    TimeEmbedding as JaxTimeEmbedding)
from composable_diffusion_models_tpu_torch import convert
from composable_diffusion_models_tpu_torch.models import UNet, unet
from composable_diffusion_models_tpu_torch.models.embeddings import (
    time_embedding)

torch.set_num_threads(1)

SMALL = dict(in_channels=3, base_dim=8, channel_mults=(1, 2), time_emb_dim=32)
CROSS = dict(num_classes=(10, 3), null_token=True, cross_attn=True)


@pytest.fixture(autouse=True)
def _jax_flash_takes_its_pallas_kernel(monkeypatch):
    """``flash_attn=True`` on the JAX side reaches the Pallas flash kernel
    (run in interpret mode on the CPU) instead of its einsum fallback."""
    monkeypatch.setenv("CDX_USE_PALLAS", "1")


def _jdt(dtype):
    return {None: None, torch.float32: jnp.float32,
            torch.bfloat16: jnp.bfloat16}[dtype]


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_tree(tree):
    return convert.unet_torch_layout(convert.from_flax(tree))


def _images(seed, b=2, hw=16, c=3):
    return np.random.default_rng(seed).standard_normal(
        (b, hw, hw, c)).astype(np.float32)


# ------------------------------------------------------------------ convert
@pytest.mark.parametrize("kw", [dict(), dict(num_classes=(3,)), CROSS,
                                dict(num_classes=(3, 3), out_channels=6,
                                     channel_mults=(1, 2, 4))])
def test_param_shapes_match_flax_init(kw):
    """``convert.init_params`` builds exactly ``UNet.init``'s tree: the same
    key paths and shapes."""
    cfg = {**SMALL, **kw}
    jm = junet.UNet(**cfg)
    labels = tuple(jnp.zeros((1,), jnp.int32)
                   for _ in cfg.get("num_classes", ()))
    flax_tree = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                        jnp.ones((1,)), *labels)
    ours = convert.init_params(UNet(**cfg), seed=0)

    def shapes(t):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(ours) == shapes(jax.tree_util.tree_map(np.asarray,
                                                         dict(flax_tree)))
    leaves = jax.tree_util.tree_leaves(ours)
    assert all(a.dtype == np.float32 and np.all(a != 0) for a in leaves)


def test_unet_torch_layout():
    """Conv kernels HWIO -> OIHW under ``weight``, everything else kept;
    applying it twice changes nothing."""
    tree = convert.from_flax(convert.init_params(UNet(**SMALL, **CROSS), 1))
    out = convert.unet_torch_layout(tree)
    k = tree["params"]["down_0"]["Conv_0"]["kernel"]
    w = out["params"]["down_0"]["Conv_0"]["weight"]
    assert "kernel" not in out["params"]["down_0"]["Conv_0"]
    assert tuple(w.shape) == (8, 8, 3, 3)
    torch.testing.assert_close(w, k.permute(3, 2, 0, 1), rtol=0, atol=0)
    dense = out["params"]["down_0"]["Dense_0"]["kernel"]
    assert dense is tree["params"]["down_0"]["Dense_0"]["kernel"]
    again = convert.unet_torch_layout(out)
    assert again["params"]["down_0"]["Conv_0"]["weight"] is w


# ----------------------------------------------------------- building blocks
@pytest.mark.parametrize("shape", [(2, 4, 4, 8), (1, 7, 5, 3), (2, 8, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_matches_jax(shape, dtype):
    """Half-pixel-centre bilinear 2x as two matmuls; the interpolation
    weights (0.25, 0.75, 1) are exact in bf16, so bf16 differs only by the
    rounding of the intermediate: one ulp of the input scale."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    ref = np.asarray(junet._upsample2x(jnp.asarray(x, _jdt(dtype))).astype(
        jnp.float32))
    got = unet._upsample2x(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype and got.is_contiguous()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8 * float(
        np.abs(x).max())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 7, 6, 3)])
def test_maxpool2x_matches_jax(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(junet._maxpool2x(jnp.asarray(x)))
    got = unet._maxpool2x(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gn_groups():
    assert [unet._gn_groups(c) for c in (64, 24, 12, 6, 7)] == [8, 8, 4, 2, 1]


@pytest.mark.parametrize("t", [np.array([0.1, 0.9], np.float32),
                               np.array([0.5], np.float32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_time_embedding_matches_jax(t, dtype):
    """Also at batch 1: the scalar-t tower whose (1, emb) row broadcasts."""
    p = convert.init_params(UNet(**SMALL), seed=2)["params"]["TimeEmbedding_0"]
    ref = np.asarray(JaxTimeEmbedding(8, 32, dtype=_jdt(dtype)).apply(
        {"params": _jax_tree(p)}, jnp.asarray(t)).astype(jnp.float32))
    got = time_embedding(convert.from_flax(p), torch.from_numpy(t), 8, dtype)
    assert got.dtype == dtype and tuple(got.shape) == (len(t), 32)
    # bf16: two Dense layers of bf16 roundings on O(1) values
    tol = 1e-5 if dtype == torch.float32 else 0.05
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


def _block_case(skip):
    tree = convert.init_params(UNet(**SMALL), seed=4)["params"]
    name = "up_0" if skip else "down_0"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 16 if skip else 8)).astype(np.float32)
    sk = rng.standard_normal((2, 8, 8, 8)).astype(np.float32) if skip else None
    t_emb = rng.standard_normal((1, 32)).astype(np.float32)
    return tree[name], x, sk, t_emb


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("fused_gn", [True, False])
def test_res_block_matches_jax(skip, fused_gn):
    """With ``skip`` the block normalises and convolves concat([x, skip])
    without building it (24 channels under 8 groups of 3 straddle the
    16 + 8 parts) and takes the 1x1 residual conv."""
    p, x, sk, t_emb = _block_case(skip)
    jkw = {} if sk is None else {"skip": jnp.asarray(sk)}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(junet.ResBlock(8, use_pallas=fused_gn).apply(
            {"params": _jax_tree(p)}, jnp.asarray(x), jnp.asarray(t_emb),
            **jkw))
    tp = _torch_tree(p)
    got = unet.res_block(tp, torch.from_numpy(x), torch.from_numpy(t_emb),
                         torch.float32, fused_gn,
                         None if sk is None else torch.from_numpy(sk))
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_matches_jax(use_flash, dtype):
    """Both branches: the flash kernel's (float32 probabilities) and the
    einsum pair's (probabilities rounded to v's dtype). bf16: four Dense
    layers and a LayerNorm of bf16 roundings around O(1) values."""
    p = convert.init_params(UNet(**SMALL, **CROSS), seed=6)["params"][
        "down_attn_0"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 2, 32)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(junet.CrossAttention(
            4, dtype=_jdt(dtype), use_flash=use_flash).apply(
                {"params": _jax_tree(p)}, jnp.asarray(x, _jdt(dtype)),
                jnp.asarray(ctx, _jdt(dtype))).astype(jnp.float32))
    got = unet.cross_attention(convert.from_flax(p),
                               torch.from_numpy(x).to(dtype),
                               torch.from_numpy(ctx).to(dtype), 4, dtype,
                               use_flash)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 0.06
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


# -------------------------------------------------------------- whole model
def _labels(kw, b):
    return [np.arange(b, dtype=np.int32) % (n + 1 if kw.get("null_token")
                                            else n)
            for n in kw.get("num_classes", ())]


def _forward_pair(kw, dtype, x, t, fused_gn=True, jax_pallas=False):
    cfg = {**SMALL, **kw}
    tree = convert.init_params(UNet(**cfg), seed=8)
    labels = _labels(cfg, x.shape[0])
    jm = junet.UNet(**cfg, dtype=_jdt(dtype), use_pallas=jax_pallas)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jm.apply(_jax_tree(tree), jnp.asarray(x),
                                  jnp.asarray(t),
                                  *(jnp.asarray(lab) for lab in labels)))
    got = UNet(**cfg, dtype=dtype, fused_gn=fused_gn).apply(
        _torch_tree(tree), torch.from_numpy(x), torch.as_tensor(t),
        *(torch.from_numpy(lab) for lab in labels))
    assert got.dtype == torch.float32 and got.shape == x.shape[:3] + (
        cfg.get("out_channels") or 3,)
    return got.numpy(), ref


@pytest.mark.parametrize("kw", [
    dict(), dict(num_classes=(3,)), CROSS, {**CROSS, "flash_attn": True},
    dict(num_classes=(3,), pad_to=32),
    dict(num_classes=(3, 3), out_channels=6, channel_mults=(1, 2, 4))],
    ids=["uncond", "class", "cross", "cross_flash", "pad32", "deep_out6"])
def test_unet_matches_jax_fp32(kw):
    got, ref = _forward_pair(kw, None, _images(9),
                             np.array([0.3, 0.8], np.float32))
    assert float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_unet_scalar_t_and_jax_pallas_paths():
    """A 0-d ``t`` (what the samplers pass) runs the batch-1 time tower;
    the JAX side goes through its Pallas GroupNorm kernel (interpret mode)
    and its flash kernel, the port through their plain versions."""
    got, ref = _forward_pair({**CROSS, "flash_attn": True}, None, _images(10),
                             np.float32(0.6), jax_pallas=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_unet_fused_gn_flag():
    """``fused_gn=False`` (the PyTorch-op composition) and ``True`` (the
    kernel's plain version on the CPU) are the same function."""
    x, t = _images(11), np.array([0.2, 0.7], np.float32)
    a, ref = _forward_pair(dict(num_classes=(3,)), None, x, t, fused_gn=True)
    b, _ = _forward_pair(dict(num_classes=(3,)), None, x, t, fused_gn=False)
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    np.testing.assert_allclose(b, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fused_gn,single,split,plain", [
    (True, 8, 2, 0), (False, 0, 0, 10)])
def test_unet_fused_gn_routes_every_groupnorm(monkeypatch, fused_gn, single,
                                              split, plain):
    """``fused_gn=True`` sends the 8 single-tensor GroupNorms of a 3-level
    UNet through ``groupnorm_silu`` and the up blocks' two ``[x, skip]``
    pairs through ``groupnorm_silu_split``; ``False`` sends all 10 through
    the PyTorch-op composition and touches neither wrapper."""
    from composable_diffusion_models_tpu_torch.models import unet as tunet
    calls = {"single": 0, "split": 0, "plain": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tunet, "groupnorm_silu",
                        counted("single", tunet.groupnorm_silu))
    monkeypatch.setattr(tunet, "groupnorm_silu_split",
                        counted("split", tunet.groupnorm_silu_split))
    monkeypatch.setattr(tunet, "groupnorm_silu_split_ref",
                        counted("plain", tunet.groupnorm_silu_split_ref))
    cfg = {**SMALL, "num_classes": (3,), "channel_mults": (1, 2, 4)}
    tree = _torch_tree(convert.init_params(UNet(**cfg), seed=8))
    x = torch.from_numpy(_images(13))
    out = UNet(**cfg, fused_gn=fused_gn).apply(
        tree, x, torch.tensor([0.2, 0.7]), torch.tensor([0, 2]))
    assert bool(torch.isfinite(out).all())
    assert calls == {"single": single, "split": split, "plain": plain}


@pytest.mark.parametrize("kw", [dict(num_classes=(3,)),
                                {**CROSS, "flash_attn": True}],
                         ids=["class", "cross_flash"])
def test_unet_matches_jax_bf16(kw):
    """bf16 compute, float32 head. Both sides round every conv, Dense and
    norm output to bf16 but accumulate in different orders, so single
    roundings flip and spread through ~25 layers: the two bf16 results
    differ as two independent roundings of the float32 result do.
    Measured on outputs of magnitude ~7: port vs JAX max 0.06 (2 bf16
    ulps), mean 0.011; JAX bf16 vs JAX float32 max 0.05, mean 0.010. Bars:
    5 ulps of the output scale per element, and a mean no more than twice
    the JAX package's own bf16-to-float32 distance."""
    x, t = _images(12), np.array([0.3, 0.8], np.float32)
    got, ref = _forward_pair(kw, torch.bfloat16, x, t)
    _, ref32 = _forward_pair(kw, None, x, t)
    diff = np.abs(got - ref)
    scale = float(np.abs(ref).max())
    assert scale > 0.1
    assert float(diff.max()) <= 5 * 2.0 ** -8 * scale
    assert float(diff.mean()) <= 2.0 * float(np.abs(ref - ref32).mean())


def test_unet_rejects():
    tree = _torch_tree(convert.init_params(UNet(**SMALL, num_classes=(3,)), 0))
    m = UNet(**SMALL, num_classes=(3,))
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="label slots"):
        m.apply(tree, x, torch.ones(1))
    with pytest.raises(ValueError, match="NHWC"):
        m.apply(tree, x[0], torch.ones(1), torch.zeros(1))
    with pytest.raises(ValueError, match="pad_to"):
        UNet(**SMALL, num_classes=(3,), pad_to=8).apply(
            tree, x, torch.ones(1), torch.zeros(1))
