"""Port parity for the UNet serving paths as a whole, against the JAX
package's programs on the same weights and noise (small widths: base 8,
16 x 16 images, 3 DDIM steps):

* shapes composition: 2 class-conditional experts behind an expert stack
  with per-expert (2, B) labels, blended by ``compose.weighted``
  (``bench.py`` ``measure_shapes_throughput``);
* cross-attention CFG: one dual-conditioned model, the null slot and two
  conditions folded into the batch axis, blended by ``compose.cfg``
  (``scripts/compose_cfg.py``);
plus ``compose.cfg`` and ``make_cfg_eps_fn`` on their own, and the entry
points' device default."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import (compose, convert, entry,
                                                   experts, samplers)

torch.set_num_threads(1)

N_STEPS = 3
SMALL_SHAPES = dataclasses.replace(entry.SHAPES_UNET, base_dim=8,
                                   channel_mults=(1, 2), time_emb_dim=32)
SMALL_CFG = dataclasses.replace(entry.CFG_UNET, base_dim=8,
                                channel_mults=(1, 2), time_emb_dim=32)


@pytest.fixture(autouse=True)
def _jax_flash_takes_its_pallas_kernel(monkeypatch):
    """``flash_attn=True`` on the JAX side reaches the Pallas flash kernel
    (run in interpret mode on the CPU) instead of its einsum fallback."""
    monkeypatch.setenv("CDX_USE_PALLAS", "1")


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _noise(seed, b=3):
    return np.random.default_rng(seed).standard_normal(
        (b, 16, 16, 3)).astype(np.float32)


def _jax_unet(cfg, dtype=None, **kw):
    fields = {f: getattr(cfg, f) for f in (
        "in_channels", "base_dim", "channel_mults", "time_emb_dim",
        "num_classes", "null_token", "cross_attn", "flash_attn")}
    return JaxUNet(**{**fields, **kw}, dtype=dtype)


# ------------------------------------------------------- the full-width paths
def test_entry_configurations_are_the_unet64_family():
    for m in (entry.SHAPES_UNET, entry.CFG_UNET):
        assert (m.in_channels, m.base_dim, m.channel_mults,
                m.time_emb_dim) == (3, 64, (1, 2, 4), 256)
    assert entry.SHAPES_UNET.num_classes == (3,)
    assert entry.N_SHAPES_EXPERTS == 2
    c = entry.CFG_UNET
    assert (c.num_classes, c.null_token, c.cross_attn, c.flash_attn) == (
        (10, 3), True, True, True)


# --------------------------------------------------------- path A: shapes
@pytest.fixture(scope="module")
def shapes_case():
    trees = [convert.init_params(SMALL_SHAPES, seed=20 + i) for i in range(2)]
    labels = np.array([[0, 1, 2], [2, 0, 1]], np.int32)  # (K, B)
    return trees, _noise(0), labels


def _jax_shapes_run(trees, x_init, labels, dtype):
    """The bench program: params and inputs cast to the serving dtype, the
    blend and the sampler in float32."""
    model = _jax_unet(SMALL_SHAPES, dtype=None if dtype == jnp.float32
                      else dtype)
    stack = jexperts.ExpertStack(model.apply,
                                 [_jax_tree(t, dtype) for t in trees])
    labs = jexperts.per_expert(jnp.asarray(labels))
    w = jnp.ones((2,), jnp.float32)

    def eps_fn(x, t):
        eps = stack(x.astype(dtype), t.astype(dtype), labs)
        return jcompose.weighted(eps.astype(jnp.float32), w)

    return np.asarray(jsamplers.ddim(eps_fn, JaxVP(), jnp.asarray(x_init),
                                     N_STEPS))


@pytest.mark.parametrize("fused_gn", [True, False])
def test_shapes_path_matches_jax_fp32(shapes_case, fused_gn):
    """float32 end to end: 1e-4 per forward; after 3 DDIM steps, whose
    first divides eps by alpha(1) ~ 0.007, the measured max |diff| is 6e-5
    on outputs of magnitude ~2.5. Bar: 1e-3."""
    trees, x_init, labels = shapes_case
    ref = _jax_shapes_run(trees, x_init, labels, jnp.float32)
    got = entry.sample_shapes([convert.from_flax(t) for t in trees], x_init,
                              labels, n_steps=N_STEPS, fused_gn=fused_gn,
                              device="cpu", dtype=torch.float32,
                              model=SMALL_SHAPES).numpy()
    assert got.shape == ref.shape == (3, 16, 16, 3)
    assert np.isfinite(got).all() and float(np.abs(ref).max()) > 0.5
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_shapes_path_matches_jax_bf16(shapes_case):
    """The served dtype: bf16 experts inside the float32 sampler, on both
    sides. Two bf16 forwards differ as independent roundings do (see
    test_torch_unet), and the sampler's early steps amplify that; held on
    the mean: measured 0.006 (max 0.45) on outputs of magnitude ~2.5,
    bar 0.05."""
    trees, x_init, labels = shapes_case
    ref = _jax_shapes_run(trees, x_init, labels, jnp.bfloat16)
    got = entry.sample_shapes([convert.from_flax(t) for t in trees], x_init,
                              labels, n_steps=N_STEPS, device="cpu",
                              model=SMALL_SHAPES).numpy()
    assert np.isfinite(got).all()
    assert float(np.abs(got - ref).mean()) <= 0.05


def test_expert_stack_maps_per_expert_labels_over_unets(shapes_case):
    """(2, B) labels: row i goes to expert i, each a (B,) label vector."""
    trees, x_init, labels = shapes_case
    model = dataclasses.replace(SMALL_SHAPES, fused_gn=True)
    params = entry.load_unets([convert.from_flax(t) for t in trees], "cpu",
                              torch.float32)
    x, t = torch.from_numpy(x_init), torch.tensor(0.5)
    stack = experts.ExpertStack(model.apply, params)
    out = stack(x, t, experts.per_expert(torch.from_numpy(labels)))
    assert tuple(out.shape) == (2, 3, 16, 16, 3)
    for i in range(2):
        want = model.apply(params[i], x, t, torch.from_numpy(labels[i]))
        torch.testing.assert_close(out[i], want, rtol=0, atol=0)
    jstack = jexperts.ExpertStack(_jax_unet(SMALL_SHAPES).apply,
                                  [_jax_tree(t) for t in trees])
    ref = np.asarray(jstack(jnp.asarray(x_init), jnp.float32(0.5),
                            jexperts.per_expert(jnp.asarray(labels))))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="ambiguous"):
        stack(x, t, torch.from_numpy(labels[:, :2]))


# ------------------------------------------------------ path B: CFG
def _jax_cfg_run(tree, x_init, digit, color, guidance, flash_attn):
    """scripts/compose_cfg.py: labels, closure and sampler."""
    model = _jax_unet(SMALL_CFG, flash_attn=flash_attn)
    params = _jax_tree(tree)
    n1, n2 = SMALL_CFG.num_classes
    eps_fn = jsamplers.make_cfg_eps_fn(
        lambda x, t, *labs: model.apply(params, x, t, *labs),
        [(jnp.asarray(digit), jnp.asarray(n2)),
         (jnp.asarray(n1), jnp.asarray(color))],
        (jnp.asarray(n1), jnp.asarray(n2)), jnp.asarray(guidance))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jsamplers.ddim(eps_fn, JaxVP(),
                                         jnp.asarray(x_init), N_STEPS))


@pytest.mark.parametrize("flash_attn", [True, False])
def test_cfg_path_matches_jax(flash_attn):
    """float32, as the preset computes. The JAX side runs its flash kernel
    in interpret mode. The guidance weights (2, 2) add the three slots'
    float32 differences up five-fold: measured max |diff| 3.3e-4 (flash)
    and 4.5e-4 (einsum) on outputs of magnitude ~3 after 3 steps. Bar:
    2e-3."""
    tree = convert.init_params(SMALL_CFG, seed=30)
    x_init = _noise(1, b=2)
    ref = _jax_cfg_run(tree, x_init, 3, 1, [2.0, 2.0], flash_attn)
    got = entry.sample_cfg(convert.from_flax(tree), x_init, 3, 1,
                           guidance=(2.0, 2.0), n_steps=N_STEPS,
                           flash_attn=flash_attn, device="cpu",
                           model=SMALL_CFG).numpy()
    assert got.shape == ref.shape == (2, 16, 16, 3)
    assert np.isfinite(got).all() and float(np.abs(ref).max()) > 0.5
    assert float(np.abs(got - ref).max()) <= 2e-3


def test_cfg_conditions_matter():
    """Another (digit, color) gives another sample: the labels reach the
    model through the cross-attention context."""
    tree = convert.from_flax(convert.init_params(SMALL_CFG, seed=30))
    x_init = _noise(1, b=2)
    a, b = (entry.sample_cfg(tree, x_init, d, c, n_steps=N_STEPS,
                             device="cpu", model=SMALL_CFG)
            for d, c in ((3, 1), (7, 2)))
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("w", [[2.0, 2.0], [0.0, 1.0], [1.5, -0.5]])
def test_cfg_matches_jax(w):
    rng = np.random.default_rng(2)
    unc = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 2, 4, 4, 3)).astype(np.float32)
    ref = np.asarray(jcompose.cfg(jnp.asarray(unc), jnp.asarray(cond),
                                  jnp.asarray(w)))
    got = compose.cfg(torch.from_numpy(unc), torch.from_numpy(cond),
                      torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _toy_apply(x, t, lab_a, lab_b):
    shape = (-1, 1, 1, 1)
    return (x * t.reshape(shape) + lab_a.reshape(shape)
            - 0.5 * lab_b.reshape(shape))


def test_make_cfg_eps_fn_matches_jax():
    """The fan-out: the model sees (K + 1) * B rows, the null slot first,
    scalar and (B,) labels alike, t broadcast to every row."""
    x = np.random.default_rng(3).standard_normal((3, 2, 2, 1)).astype(
        np.float32)
    per_sample = np.array([1, 2, 3], np.int32)
    rows = []

    def spy(x_rep, t_rep, *labs):
        rows.append((x_rep.shape[0], t_rep.shape, [lab.tolist()
                                                   for lab in labs]))
        return _toy_apply(x_rep, t_rep, *labs)

    jfn = jsamplers.make_cfg_eps_fn(
        _toy_apply, [(jnp.asarray(per_sample), jnp.asarray(5)),
                     (jnp.asarray(4), jnp.asarray(2))],
        (jnp.asarray(4), jnp.asarray(5)), jnp.asarray([2.0, 0.5]))
    tfn = samplers.make_cfg_eps_fn(
        spy, [(torch.from_numpy(per_sample), 5), (4, 2)], (4, 5),
        torch.tensor([2.0, 0.5]))
    ref = np.asarray(jfn(jnp.asarray(x), jnp.float32(0.7)))
    for _ in range(2):  # the second call reuses the fanned-out labels
        got = tfn(torch.from_numpy(x), torch.tensor(0.7)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert rows[0] == (9, (9,), [[4, 4, 4, 1, 2, 3, 4, 4, 4],
                                 [5, 5, 5, 5, 5, 5, 2, 2, 2]])


# ------------------------------------------------------------ device default
def test_unet_entry_points_default_to_cuda(monkeypatch):
    """device=None means the card: without one the UNet entry points raise
    and never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = convert.from_flax(convert.init_params(SMALL_CFG, seed=0))
    x = np.zeros((1, 16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.sample_cfg(tree, x, 1, 1, n_steps=1, model=SMALL_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.load_unets([tree])
    trees = [convert.from_flax(convert.init_params(SMALL_SHAPES, seed=i))
             for i in range(2)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.sample_shapes(trees, x, np.zeros((2, 1), np.int64), n_steps=1,
                            model=SMALL_SHAPES)


# ---------------------------------------------------------------- FLOP count
@pytest.mark.parametrize("cfg,hw", [(SMALL_SHAPES, 16), (SMALL_CFG, 12)])
def test_unet_gflop_count_matches_the_flop_counter(cfg, hw):
    """The analytic count (convolutions, projections, upsample and
    attention products) against PyTorch's own FLOP counter over a forward;
    the count leaves out the batch-1 time tower: within 1%."""
    from torch.utils.flop_counter import FlopCounterMode
    tree = convert.unet_torch_layout(convert.from_flax(
        convert.init_params(cfg, seed=0)))
    b = 8
    labels = [torch.zeros(b, dtype=torch.long) for _ in cfg.num_classes]
    with FlopCounterMode(display=False) as counter:
        cfg.apply(tree, torch.zeros(b, hw, hw, 3), torch.tensor(0.5), *labels)
    counted = counter.get_total_flops() / b / 1e9
    assert abs(entry.unet_gflop_per_image(cfg, hw, hw) / counted - 1) < 0.01


def test_unet_gflop_at_full_width():
    assert abs(entry.unet_gflop_per_image(entry.SHAPES_UNET, 64, 64)
               - 4.240) < 1e-3
    assert abs(entry.unet_gflop_per_image(entry.CFG_UNET, 28, 28)
               - 0.872) < 1e-3
