"""Port parity for the shapes gate: the UNet's training path (the loss and
every gradient against ``jax.value_and_grad`` of the flax UNet in float32
and bf16 compute, ``train_expert`` with the JAX draws replayed, the
module's dropout, the flax init), the gate's DiT candidate folded at
64 tokens' shape family, the FLOP count, the kernel wrappers' refusal of
gradients and tangents, and ``entry.quality_gate_shapes`` end to end at
the script's ``--sanity`` sizes with the judge under ``SHAPES_CRITERIA``
against the script's."""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from composable_diffusion_models_tpu import train as jtrain
from composable_diffusion_models_tpu.models import DiT as JaxDiT
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.models import make_folded_apply as jfold
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import convert, entry, gate, train
from composable_diffusion_models_tpu_torch.models.dit import (
    DiT, make_folded_apply)
from composable_diffusion_models_tpu_torch.models.unet import UNet
from composable_diffusion_models_tpu_torch.ops import attention, kernels
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
BF16_ULP = 2.0 ** -8
SMALL_UNET = dict(in_channels=3, base_dim=8, channel_mults=(1, 2, 4),
                  num_classes=(3,))


def _script():
    spec = importlib.util.spec_from_file_location(
        "quality_gate_shapes", ROOT / "scripts" / "quality_gate_shapes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_unet_tree(tree):
    """A flax-layout numpy (or jax) tree in the layout ``UNet.apply`` reads."""
    return convert.unet_torch_layout(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, tree)))


def _loss_draws(key, bs, x_shape):
    """The JAX loss's draws in the port's order: t, then the noise."""
    kt, ke, _ = jax.random.split(key, 3)
    return [np.asarray(jax.random.uniform(kt, (bs,), minval=1e-3,
                                          maxval=1.0)),
            np.asarray(jax.random.normal(ke, x_shape, jnp.float32))]


def _unet_inputs(seed=0, b=4, size=16):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    lab = rng.integers(0, 3, b).astype(np.int32)
    return x0, lab


# ------------------------------------------------------- UNet training
def _unet_loss_and_grads(dtype, key, x0, lab, tree):
    """(JAX loss, JAX gradients, port loss, port gradients) of the small
    UNet's denoising loss on the same (x0, t, eps), the gradients as
    trees in the port's layout."""
    cfg = UNet(**SMALL_UNET, dtype=dtype)
    jm = JaxUNet(**SMALL_UNET, dtype=None if dtype is None else jnp.bfloat16)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        jtrain.make_loss_fn(jm.apply, JaxVP())))(
        _jtree(tree), key, jnp.asarray(x0), (jnp.asarray(lab),))
    loss, grads = train.value_and_grad(
        train.make_loss_fn(cfg.apply, VPSchedule()), _torch_unet_tree(tree),
        Replay(_loss_draws(key, 4, x0.shape)), torch.from_numpy(x0),
        (torch.from_numpy(lab).long(),))
    return (float(ref_loss), _torch_unet_tree(ref_grads), float(loss),
            grads)


def test_unet_loss_and_grads_match_jax():
    """The denoising loss of a base-8 UNet at 16 x 16 with one 3-class slot
    and GroupNorm in PyTorch ops (the gate's ``use_pallas=False``), on the
    same (x0, t, eps).

    float32: the loss to 1e-6 relative; every gradient leaf to 1e-5 of its
    scale, except the leaves whose gradient is zero in exact arithmetic
    (the conv and time-projection biases, and that projection's kernel,
    of the blocks whose GroupNorm has one channel a group: the norm removes
    any per-channel shift), which are float32 noise of ~1e-8 in both
    frameworks and are held to 1e-5 of the largest gradient.

    bf16 compute (float32 parameters, as the gate trains the unet64): the
    loss to 4 bf16 ulps of the JAX bf16 loss. The gradients pass through
    some 40 bf16 roundings, so JAX's own bf16 gradients stand 1e-3..0.13
    of each leaf's scale from its float32 ones; the port's are held no
    further from the float32 gradients than 3x JAX's bf16 distance, plus
    1e-6 of the largest gradient (measured up to 2.3x)."""
    tree = convert.init_params(UNet(**SMALL_UNET), seed=3)
    x0, lab = _unet_inputs()
    key = jax.random.PRNGKey(5)
    ref_loss, ref32, loss, got32 = _unet_loss_and_grads(None, key, x0, lab,
                                                        tree)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    paths, got = train.flatten(got32)
    ref_paths, ref = train.flatten(ref32)
    assert paths == ref_paths
    top = max(float(r.abs().max()) for r in ref)
    zero = 0
    for path, g, r in zip(paths, got, ref):
        scale = float(r.abs().max())
        zero += scale < 1e-5 * top
        bar = 1e-5 * (scale if scale >= 1e-5 * top else top)
        assert float((g - r).abs().max()) <= bar, (path, scale)
    assert zero == 6
    ref16_loss, ref16, loss16, got16 = _unet_loss_and_grads(
        torch.bfloat16, key, x0, lab, tree)
    assert abs(loss16 - ref16_loss) <= 4 * BF16_ULP * abs(ref16_loss)
    for path, g, r, r32 in zip(paths, train.flatten(got16)[1],
                               train.flatten(ref16)[1], ref):
        jax_err = float((r - r32).abs().max())
        err = float((g - r32).abs().max())
        assert err <= 3 * jax_err + 1e-6 * top, (path, err, jax_err)


def _jax_step_draws(key, chunk_lengths, n, bs, x_shape):
    out = []
    for c, length in enumerate(chunk_lengths):
        ck = jax.random.fold_in(key, c)
        for i in range(length):
            kb, kl = jax.random.split(jax.random.fold_in(ck, i))
            out.append(np.asarray(jax.random.randint(kb, (bs,), 0, n)))
            out += _loss_draws(kl, bs, x_shape)
    return out


def test_unet_train_expert_matches_jax():
    """``train_expert`` on the small UNet as the gate runs it (labels,
    EMA, the global-norm clip, Adam), 2 chunks x 2 steps with every JAX
    draw replayed: losses to 1e-5, the EMA tree to 1e-5 of each leaf's
    scale. Adam's epsilon is 1e-4, as in the DiT's test: a gradient that
    is zero in exact arithmetic is float32 noise in both frameworks."""
    cfg = UNet(**SMALL_UNET)
    jm = JaxUNet(**SMALL_UNET)
    tree = convert.init_params(cfg, seed=4)
    imgs = np.random.default_rng(6).uniform(-1, 1, (12, 16, 16, 3)).astype(
        np.float32)
    labs = (np.arange(12) % 3).astype(np.int32)
    key = jax.random.PRNGKey(8)
    kw = dict(steps=4, batch_size=4, steps_per_scan=2, lr=1e-3,
              ema_decay=0.9, clip_norm=1.0, adam_eps=1e-4)
    ref_ema, ref_losses = jtrain.train_expert(
        key, jm.apply, _jtree(tree), JaxVP(), jnp.asarray(imgs),
        (jnp.asarray(labs),), **kw)
    draws = Replay(_jax_step_draws(key, [2, 2], 12, 4, (4, 16, 16, 3)))
    ema, losses = train.train_expert(
        draws, cfg.apply, _torch_unet_tree(tree), VPSchedule(),
        torch.from_numpy(imgs), (torch.from_numpy(labs).long(),), **kw)
    assert not draws.queue
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=0, atol=1e-5)
    for path, g, r in zip(*train.flatten(ema),
                          train.flatten(_torch_unet_tree(ref_ema))[1]):
        err = float((g - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), (path, err)


def test_unet_trains_after_serving():
    """A forward under ``torch.inference_mode`` (serving) first builds the
    upsampling matrices the UNet caches; a training step on the same sizes
    afterwards still differentiates (they are not inference tensors)."""
    from composable_diffusion_models_tpu_torch.models import unet
    unet._interp_matrix.cache_clear()
    cfg = UNet(**SMALL_UNET)
    params = _torch_unet_tree(convert.init_params(cfg, seed=6))
    x0, lab = _unet_inputs(4)
    lab = torch.from_numpy(lab).long()
    with torch.inference_mode():
        cfg.apply(params, torch.from_numpy(x0), torch.full((4,), 0.5), lab)
    loss, grads = train.value_and_grad(
        train.make_loss_fn(cfg.apply, VPSchedule()), params, 2,
        torch.from_numpy(x0), (lab,))
    assert math.isfinite(float(loss))
    assert float(grads["params"]["init_conv"]["weight"].abs().max()) > 0


def test_unet_dropout():
    """``train=True``: dropout 0.1 after each block's second GroupNorm +
    SiLU, as flax draws it (kept values divided by 0.9): the module's
    output moves, the masks keep ~90% and scale by 1/0.9 exactly;
    ``train=False`` (and a zero rate) is the inference forward, bit for
    bit; ``train=True`` without a generator raises."""
    from composable_diffusion_models_tpu_torch.models import unet
    h = torch.randn(64, 32, 32, 8, generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        hd = h.to(dtype)
        out = unet.dropout(hd, 0.1, torch.Generator().manual_seed(1))
        kept = out != 0
        assert abs(float(kept.float().mean()) - 0.9) < 0.005
        assert torch.equal(out[kept], (hd / 0.9)[kept])
    cfg = UNet(**SMALL_UNET)
    params = _torch_unet_tree(convert.init_params(cfg, seed=2))
    x0, lab = _unet_inputs(1)
    x, t = torch.from_numpy(x0), torch.full((4,), 0.5)
    lab = torch.from_numpy(lab).long()
    ref = cfg.apply(params, x, t, lab)
    assert torch.equal(cfg.apply(params, x, t, lab, train=False), ref)
    gen = torch.Generator().manual_seed(3)
    off = UNet(**SMALL_UNET, dropout=0.0)
    assert torch.equal(off.apply(params, x, t, lab, train=True), ref)
    on = cfg.apply(params, x, t, lab, train=True, generator=gen)
    assert float((on - ref).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="torch.Generator"):
        cfg.apply(params, x, t, lab, train=True)


def test_unet_flax_init():
    """``flax_init`` of the UNet: GroupNorm scales one and biases zero (no
    draw), label embeddings N(0, 1/256), kernels lecun-normal truncated at
    two standard deviations; in the layout apply reads it runs, and a
    second key gives other kernels."""
    cfg = UNet(**SMALL_UNET)
    tree = convert.flax_init(cfg, 5)
    p = tree["params"]
    assert set(train.flatten(tree)[0]) == set(
        ("params",) + k for k in convert.param_shapes(cfg))
    assert torch.equal(p["down_0"]["gn1"]["scale"], torch.ones(8))
    assert not p["down_0"]["Conv_0"]["bias"].any()
    k = p["up_0"]["Conv_0"]["kernel"]
    std = (1 / (9 * 24)) ** 0.5 / 0.87962566103423978
    assert float(k.abs().max()) <= 2 * std and float(k.std()) > 0.5 * std
    emb = p["label_emb_0"]["embedding"]
    assert 0.5 / 16 < float(emb.std()) < 2 / 16
    x0, lab = _unet_inputs(2)
    out = cfg.apply(convert.unet_torch_layout(tree), torch.from_numpy(x0),
                    torch.full((4,), 0.3), torch.from_numpy(lab).long())
    assert out.shape == (4, 16, 16, 3) and bool(torch.isfinite(out).all())
    other = convert.flax_init(cfg, 6)["params"]["up_0"]["Conv_0"]["kernel"]
    assert not torch.equal(k, other)


# ------------------------------------------------ the gate's DiT candidate
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_folded_dit_p8_matches_flax(dtype):
    """The gate's candidate family (patch 8, one 3-class slot, 3 channels)
    at 16 x 16, 4 tokens, narrowed to dim 64 and depth 2, folded with a
    batch-constant t and label as the gate serves it: float32 against the
    flax forward to 1e-5 of the output scale; bf16 against the JAX folded
    path to 4 bf16 ulps of the scale."""
    kw = dict(patch=8, dim=64, depth=2, n_heads=4, in_channels=3,
              num_classes=(3,))
    cfg = DiT(**kw, img_size=16, dtype=dtype)
    tree = convert.init_params(cfg, seed=7)
    x = np.random.default_rng(8).standard_normal((5, 16, 16, 3)).astype(
        np.float32)
    t, lab = np.array([0.42], np.float32), np.array([2], np.int32)
    if dtype is None:
        ref = JaxDiT(**kw).apply(_jtree(tree), jnp.asarray(x),
                                 jnp.full((5,), 0.42), jnp.full((5,), 2))
    else:
        ref = jfold(JaxDiT(**kw, dtype=jnp.bfloat16))(
            _jtree(tree), jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(t, jnp.bfloat16), jnp.asarray(lab))
    ref = np.asarray(ref, np.float32)
    p = convert.from_flax(tree)
    xt = torch.from_numpy(x)
    if dtype is not None:
        p = train.tree_map(lambda a: a.to(dtype), p)
        xt = xt.to(dtype)
    got = make_folded_apply(cfg)(p, xt, torch.from_numpy(t).to(xt.dtype),
                                 torch.from_numpy(lab)).float().numpy()
    tol = 1e-5 if dtype is None else 4 * BF16_ULP
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_folded_dit_p4_matches_flax(dtype):
    """The gate's dit_p4 family (patch 4, one 3-class slot, 3 channels) at
    36 x 36, 81 tokens (two 64-row blocks an image on the card: the
    cluster route, and a partial last block), narrowed to dim 64 with heads
    of 32 and depth 2, folded as the gate serves it. bf16, through
    ``fused_dit_block`` (its plain version on the CPU): against the JAX
    folded path to 4 bf16 ulps of the scale. float32, which the kernel
    takes only up to 64 tokens at this width (the wrapper raises, as on
    the card): the folded path with ``fused_block=False`` against the flax
    forward to 1e-5 of the output scale."""
    kw = dict(patch=4, dim=64, depth=2, n_heads=2, in_channels=3,
              num_classes=(3,))
    cfg = DiT(**kw, img_size=36, dtype=dtype)
    tree = convert.init_params(cfg, seed=9)
    x = np.random.default_rng(10).standard_normal((3, 36, 36, 3)).astype(
        np.float32)
    t, lab = np.array([0.61], np.float32), np.array([1], np.int32)
    if dtype is None:
        ref = JaxDiT(**kw).apply(_jtree(tree), jnp.asarray(x),
                                 jnp.full((3,), 0.61), jnp.full((3,), 1))
    else:
        ref = jfold(JaxDiT(**kw, dtype=jnp.bfloat16))(
            _jtree(tree), jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(t, jnp.bfloat16), jnp.asarray(lab))
    ref = np.asarray(ref, np.float32)
    p = convert.from_flax(tree)
    xt = torch.from_numpy(x)
    if dtype is not None:
        p = train.tree_map(lambda a: a.to(dtype), p)
        xt = xt.to(dtype)
    args = (p, xt, torch.from_numpy(t).to(xt.dtype), torch.from_numpy(lab))
    if dtype is None:
        with pytest.raises(ValueError, match="81 tokens"):
            make_folded_apply(cfg)(*args)
        got = make_folded_apply(cfg, fused_block=False)(*args)
    else:
        got = make_folded_apply(cfg)(*args)
    got = got.float().numpy()
    tol = 1e-5 if dtype is None else 4 * BF16_ULP
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_dit_flop_count():
    """The counted figure reproduces the flagship's 4.377 GFLOP a sampled
    image (3 experts x 50 steps), and counts the shapes gate's candidate:
    one forward of dit_p8_d256_l8 at 64 x 64 (64 tokens) per block 4ND^2 +
    2N^2D + 8ND^2 + 6D^2 MACs, times 8 blocks, plus patchify and
    unpatchify 2ND * 192."""
    assert entry.gflop_per_image() == pytest.approx(4.377, abs=5e-4)
    assert entry.dit_gflop_per_image(entry.FLAGSHIP) * 150 == \
        pytest.approx(entry.gflop_per_image())
    _, serve = entry.shapes_gate_model("dit_p8_d256_l8", 64)
    n, d = 64, 256
    macs = 8 * (12 * n * d * d + 2 * n * n * d + 6 * d * d) + 2 * n * d * 192
    assert entry.dit_gflop_per_image(serve) == pytest.approx(2 * macs / 1e9)
    assert serve.n_tokens == 64 and serve.dtype == torch.bfloat16


def test_shapes_gate_models():
    """The script's configuration names: unet<W> and dit_p<P>_d<D>_l<L>
    (heads 8 unless _h<H>); a patch that does not divide the image or an
    unknown name raise."""
    tr, sv = entry.shapes_gate_model("unet64")
    assert tr == dataclasses.replace(sv, fused_gn=False)
    assert (tr.base_dim, tr.num_classes, tr.dtype, sv.fused_gn) == (
        64, (3,), torch.bfloat16, True)
    tr, sv = entry.shapes_gate_model("dit_p4_d128_l2_h4", 32)
    assert (tr.patch, tr.dim, tr.depth, tr.n_heads, tr.img_size, tr.dtype,
            sv.dtype) == (4, 128, 2, 4, 32, None, torch.bfloat16)
    with pytest.raises(ValueError, match="divisible"):
        entry.shapes_gate_model("dit_p5_d64_l1", 64)
    with pytest.raises(ValueError, match="unknown config"):
        entry.shapes_gate_model("vit64")


# ------------------------------------------- kernels refuse autodiff
def _wrapper_calls():
    """(name, call(inputs), inputs) for every kernel wrapper at a small
    shape its limits take, on CPU tensors."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)
    d = 32
    blk = [rnd(2, 4, d), rnd(d, 3 * d), rnd(3 * d), rnd(d, d), rnd(d),
           rnd(d, 4 * d), rnd(4 * d), rnd(4 * d, d), rnd(d)]
    return [
        ("fused_dit_block", lambda *a: kernels.fused_dit_block(*a, 2), blk),
        ("short_seq_attention",
         lambda a: kernels.short_seq_attention(a, 2), [rnd(2, 4, 96)]),
        ("groupnorm_silu", lambda x, s, b: kernels.groupnorm_silu(x, s, b, 4),
         [rnd(2, 4, 4, 8), rnd(8), rnd(8)]),
        ("groupnorm_silu_split",
         lambda x, y, s, b: kernels.groupnorm_silu_split((x, y), s, b, 4),
         [rnd(2, 4, 4, 8), rnd(2, 4, 4, 8), rnd(16), rnd(16)]),
        ("flash_attention", attention.flash_attention,
         [rnd(2, 2, 5, 16), rnd(2, 2, 3, 16), rnd(2, 2, 3, 16)]),
        ("blend_eps", kernels.blend_eps, [rnd(2, 3, 4), rnd(2).abs() + 0.5]),
        ("matmul", kernels.matmul, [rnd(5, 3), rnd(3, 4)]),
    ]


@pytest.mark.parametrize("i", range(7))
def test_kernel_wrappers_refuse_gradients_and_tangents(i):
    """A launch writes a fresh tensor with neither a grad_fn nor a
    tangent, so every wrapper raises, here on the CPU as on the card, for
    an input that requires grad under grad mode, under ``torch.func.jvp``
    and for a ``forward_ad`` dual; with grad mode off, or without any of
    them, it runs its plain version."""
    name, call, inputs = _wrapper_calls()[i]
    plain = call(*inputs)
    for j in range(len(inputs)):
        args = list(inputs)
        args[j] = args[j].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(*args)
        with torch.no_grad():
            out = call(*args)
        assert torch.equal(out if not isinstance(out, list) else out[0],
                           plain if not isinstance(plain, list)
                           else plain[0])
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            torch.func.jvp(lambda v, j=j: call(*(inputs[:j] + [v]
                                                 + inputs[j + 1:])),
                           (inputs[j],), (torch.ones_like(inputs[j]),))
        with fwAD.dual_level():
            args = list(inputs)
            args[j] = fwAD.make_dual(inputs[j], torch.ones_like(inputs[j]))
            with pytest.raises(RuntimeError,
                               match=f"{name} has no backward"):
                call(*args)


def test_fused_gn_unet_refuses_training():
    """The UNet trained with ``fused_gn=True`` would lose every gradient
    through GroupNorm; it raises instead. ``fused_gn=False`` trains."""
    cfg = UNet(**SMALL_UNET, fused_gn=True)
    params = _torch_unet_tree(convert.init_params(cfg, seed=1))
    x0, lab = _unet_inputs(3)
    loss_fn = train.make_loss_fn(cfg.apply, VPSchedule())
    args = (1, torch.from_numpy(x0), (torch.from_numpy(lab).long(),))
    with pytest.raises(RuntimeError, match="groupnorm_silu"):
        train.value_and_grad(loss_fn, params, *args)
    loss, _ = train.value_and_grad(
        train.make_loss_fn(UNet(**SMALL_UNET).apply, VPSchedule()), params,
        *args)
    assert math.isfinite(float(loss))


# ------------------------------------------------------------- the gate
@pytest.fixture(scope="module")
def sanity_reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("gate")
    return out, entry.quality_gate_shapes(sanity=True, device="cpu",
                                          out=str(out))


def test_shapes_gate_runs_at_sanity_sizes(sanity_reports):
    """Both configurations at the script's --sanity sizes on the CPU (the
    full-width unet64 and dit_p8_d256_l8 at 16 x 16, 40 training steps at
    batch 16, a 200-step probe, 8 samples of 4 steps in each of the 9
    cells): reports written as the script names them, the baseline
    labelled, every cell scored, finite statistics."""
    out, reps = sanity_reports
    assert set(reps) == set(entry.SHAPES_GATE_CONFIGS)
    for cfg, rep in reps.items():
        path = out / f"quality_shapes_{cfg}_s40.json"
        assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
        assert rep["workload"] == "shapes64_2expert_ddim50"
        assert rep["baseline_config"] == "unet64" and rep["n_samples"] == 8
        assert set(rep["cells"]) == {f"{s},{c}" for s in range(3)
                                     for c in range(3)}
        assert set(rep["criteria"]) == {c[0] for c in gate.SHAPES_CRITERIA}
        comp = rep["composed"]
        assert 0.0 <= comp["joint_min"] <= comp["joint_mean"] <= 1.0
        assert all(math.isfinite(comp[k]) for k in comp)
        assert set(rep["probe_heldin"]) == {"factor_0_acc", "factor_1_acc"}
    assert reps["unet64"]["verdict"] == "BASELINE"
    assert reps["dit_p8_d256_l8"]["verdict"] in ("PASS", "FAIL")


def test_shapes_judge_matches_the_script(sanity_reports, tmp_path):
    """``gate.judge`` under ``SHAPES_CRITERIA`` against the script's judge
    and criteria on the sanity reports and on copies moved across each
    threshold or near it, with and without the noise rows; a baseline
    given as a report path is read as the script reads it."""
    script = _script()
    assert [c[0] for c in gate.SHAPES_CRITERIA] == \
        [c[0] for c in script.SHAPES_CRITERIA]
    _, reps = sanity_reports
    base = reps["unet64"]
    for rep in reps.values():
        worse = json.loads(json.dumps(rep))
        worse["composed"]["joint_min"] -= 0.05
        worse["composed"]["fid_probe"] *= 1.6
        near = json.loads(json.dumps(rep))
        near["composed"]["diversity_mean"] = \
            0.51 * base["composed"]["diversity_mean"]
        for cand in (rep, worse, near):
            for n in (None, 8, 256):
                args = (cand, base, 0.02, 0.5, 1.5)
                got = gate.judge(*args, criteria=gate.SHAPES_CRITERIA,
                                 n_samples=n)
                assert got == script.judge(
                    *args, criteria=script.SHAPES_CRITERIA, n_samples=n)
    path = tmp_path / "quality_shapes_unet64.json"
    path.write_text(json.dumps(base))
    assert entry.shapes_baseline(str(path), {}) == json.loads(
        json.dumps(base))
    assert entry.shapes_baseline("unet64", reps) is base
    with pytest.raises(ValueError, match="baseline 'dit' not found"):
        entry.shapes_baseline("dit", reps)


@pytest.mark.parametrize("img", [36, 64])
def test_shapes_gate_serves_dit_p4(img, tmp_path, monkeypatch):
    """``quality_gate_shapes`` with the reference's dit_p4_d256_l8 at full
    width (D 256, depth 8, 8 heads) on images of 81 and 256 tokens, the
    other sizes at their least, against a baseline report read from a
    file: it trains the experts, serves every cell through
    ``fused_dit_block`` (8 blocks x 2 experts a step, on its images of T
    tokens) and returns a report with a verdict. The baseline's numbers
    lie far from every threshold, so no pass is escalated."""
    from composable_diffusion_models_tpu_torch.models import dit
    base = tmp_path / "quality_shapes_unet64.json"
    base.write_text(json.dumps({"config": "unet64", "composed": {
        "joint_mean": 3.0, "joint_min": 3.0, "diversity_mean": 1e-9,
        "diversity_min": 1e-9, "fid_probe": 1e-9}}))
    shapes, orig = [], dit.fused_dit_block

    def record(tok, *args):
        shapes.append(tuple(tok.shape))
        return orig(tok, *args)
    monkeypatch.setattr(dit, "fused_dit_block", record)
    reps = entry.quality_gate_shapes(
        configs="dit_p4_d256_l8", baseline=str(base), train_steps=1,
        batch_size=2, probe_steps=1, samples_per_cell=2, n_steps=1, img=img,
        data_n=16, out=str(tmp_path), device="cpu")
    rep = reps["dit_p4_d256_l8"]
    assert rep["verdict"] in ("PASS", "FAIL")
    assert rep["baseline_config"] == "unet64" and "escalation" not in rep
    assert set(rep["cells"]) == {f"{s},{c}" for s in range(3)
                                 for c in range(3)}
    assert all(math.isfinite(v) for v in rep["composed"].values())
    assert shapes == [(2, (img // 4) ** 2, 256)] * (9 * 8 * 2)
    assert json.loads((tmp_path / "quality_shapes_dit_p4_d256_l8_s1.json")
                      .read_text()) == json.loads(json.dumps(rep))


def test_shapes_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_shapes_experts(steps=1, data_n=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.quality_gate_shapes(sanity=True)
