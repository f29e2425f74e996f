"""Port parity for the training path: the unfolded DiT forward (float32,
bf16, both attention layouts, labels and the null token), its folded and
kernel-attention forms, the denoising loss and its gradients, one Adam
step against optax, ``train_expert`` with the JAX draws replayed, and
bitwise resume; against the JAX package on the same numpy inputs and
converted weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from composable_diffusion_models_tpu import train as jtrain
from composable_diffusion_models_tpu.models import DiT as JaxDiT
from composable_diffusion_models_tpu.models import ScoreMLP as JaxMLP
from composable_diffusion_models_tpu.schedules import (
    DDPMSchedule as JaxDDPM, VPSchedule as JaxVP)
from composable_diffusion_models_tpu_torch import convert, entry, train
from composable_diffusion_models_tpu_torch.checkpoint import (
    CheckpointManager)
from composable_diffusion_models_tpu_torch.models.dit import (
    DiT, make_folded_apply)
from composable_diffusion_models_tpu_torch.models.mlp import ScoreMLP
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.schedules import (
    DDPMSchedule, VPSchedule)

torch.set_num_threads(1)
SMALL = dict(patch=7, dim=64, depth=2, n_heads=4)
BF16_ULP = 2.0 ** -8


def _configs(qkv_fused=True, labels=False, dtype=None):
    """(port config, flax module) of the small DiT."""
    extra = dict(num_classes=(3,), null_token=True) if labels else {}
    cfg = DiT(**SMALL, qkv_fused=qkv_fused, dtype=dtype, **extra)
    jm = JaxDiT(**SMALL, qkv_fused=qkv_fused,
                dtype=None if dtype is None else jnp.bfloat16, **extra)
    return cfg, jm


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _inputs(seed=0, b=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 28, 28, 1)).astype(np.float32)
    t = rng.uniform(0.01, 1.0, b).astype(np.float32)
    lab = rng.integers(0, 4, b).astype(np.int32)  # 3 = the null token
    return x, t, lab


def _max_rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


# ------------------------------------------------------------- the forward
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("labels", [False, True])
@pytest.mark.parametrize("qkv_fused", [True, False])
def test_dit_apply_matches_flax(qkv_fused, labels, dtype):
    """float32: summation order only, 1e-5 of the output scale (measured
    ~4e-7). bf16: both compute at flax's cast sites, but the two
    libraries' sin/cos and summation order flip single bf16 roundings
    that the blocks carry on: 4 bf16 ulps of the output scale (measured
    1-3)."""
    cfg, jm = _configs(qkv_fused, labels, dtype)
    tree = convert.init_params(cfg, seed=3)
    x, t, lab = _inputs()
    labs = (lab,) if labels else ()
    ref = np.asarray(jm.apply(_jtree(tree), jnp.asarray(x), jnp.asarray(t),
                              *map(jnp.asarray, labs)), np.float32)
    got = cfg.apply(convert.from_flax(tree), torch.from_numpy(x),
                    torch.from_numpy(t), *map(torch.from_numpy, labs))
    assert got.dtype == torch.float32 and got.shape == (4, 28, 28, 1)
    tol = 1e-5 if dtype is None else 4 * BF16_ULP
    assert _max_rel(got.detach().numpy(), ref) <= tol


@pytest.mark.parametrize("fold", ["fused_block", "unfused", "fold_ln"])
def test_unfolded_matches_folded(fold):
    """Batch-constant t and label: the folded serving forms compute the
    same function; float32, 1e-5 of the output scale."""
    cfg, _ = _configs(labels=True)
    params = convert.from_flax(convert.init_params(cfg, seed=4))
    x, _, _ = _inputs(1)
    t, lab = torch.tensor([0.37]), torch.tensor([2])
    ref = cfg.apply(params, torch.from_numpy(x), t, lab).detach()
    apply = make_folded_apply(cfg, fused_block=fold == "fused_block",
                              fold_ln=fold == "fold_ln")
    got = apply(params, torch.from_numpy(x), t, lab)
    assert _max_rel(got.numpy(), ref.numpy()) <= 1e-5


def test_pallas_attn_matches_einsum_and_refuses_grad():
    """``pallas_attn=True`` runs the attention core through the
    short_seq_attention wrapper (its plain version on the CPU): float32,
    1e-5 of the output scale. Under autograd it raises instead of dropping
    the gradient."""
    cfg, _ = _configs()
    kcfg = dataclasses.replace(cfg, pallas_attn=True)
    params = convert.from_flax(convert.init_params(cfg, seed=5))
    x, t, _ = _inputs(2)
    x, t = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        ref = cfg.apply(params, x, t)
        got = kcfg.apply(params, x, t)
    assert _max_rel(got.numpy(), ref.numpy()) <= 1e-5
    train_params = train.tree_map(lambda p: p.requires_grad_(True),
                                  convert.from_flax(
                                      convert.init_params(cfg, seed=5)))
    with pytest.raises(RuntimeError, match="inference-only"):
        kcfg.apply(train_params, x, t)


# ------------------------------------------------------------------- loss
def _jax_loss_draws(key, bs, x_shape, discrete, t_min=1e-3, drop=False,
                    num_timesteps=1000):
    """The draws ``train.make_loss_fn``'s JAX loss takes from ``key``, in
    the port's draw order: t, the noise, the dropout uniforms."""
    kt, ke, kd = jax.random.split(key, 3)
    if discrete:
        t = jax.random.randint(kt, (bs,), 0, num_timesteps)
    else:
        t = jax.random.uniform(kt, (bs,), minval=t_min, maxval=1.0)
    out = [t, jax.random.normal(ke, x_shape, jnp.float32)]
    if drop:
        out.append(jax.random.uniform(kd, (bs,)))
    return [np.asarray(a) for a in out]


LOSS_CASES = [("eps", None, "vp", 0.0), ("eps", 5.0, "vp", 0.0),
              ("x0", None, "vp", 0.0), ("x0", 5.0, "vp", 0.0),
              ("v", None, "vp", 0.0), ("v", 5.0, "vp", 0.0),
              ("eps", None, "vp", 0.5), ("eps", None, "ddpm", 0.0),
              ("eps", 5.0, "ddpm", 0.0), ("x0", 5.0, "ddpm", 0.5)]


@pytest.mark.parametrize("predict,snr_gamma,sched,uncond", LOSS_CASES)
def test_loss_and_grads_match_jax(predict, snr_gamma, sched, uncond):
    """make_loss_fn on the same (x0, t, eps, drop): the loss to 1e-6
    relative, every gradient leaf to 1e-5 of its scale (float32; the
    summation order of the backward pass differs). On the DDPM schedule the
    model sees the integer timestep over 1000, on both sides: at t up to
    999 the sinusoid's arguments reach 999, where an ulp of a frequency
    (XLA's float32 exp misrounds some of them, torch's does not) moves
    sin(t * freq) by 4e-5, which the gradients carry."""
    cfg, jm = _configs(labels=True)
    tree = convert.init_params(cfg, seed=6)
    x0, _, lab = _inputs(3)
    key = jax.random.PRNGKey(11)
    discrete = sched == "ddpm"
    jsch, tsch = ((JaxDDPM(), DDPMSchedule()) if discrete
                  else (JaxVP(), VPSchedule()))
    kw = dict(predict=predict, snr_gamma=snr_gamma, uncond_prob=uncond,
              null_labels=(3,))
    div = 1000.0 if discrete else 1.0
    jloss = jtrain.make_loss_fn(
        lambda p, x, t, *lab: jm.apply(p, x, t / div, *lab), jsch, **kw)
    ref_loss, ref_grads = jax.value_and_grad(jloss)(
        _jtree(tree), key, jnp.asarray(x0), (jnp.asarray(lab),))
    draws = _jax_loss_draws(key, 4, x0.shape, discrete, drop=uncond > 0)
    if uncond:  # the case must drop some labels and keep others
        assert 0 < (draws[-1] < uncond).sum() < 4
    loss, grads = train.value_and_grad(
        train.make_loss_fn(
            lambda p, x, t, *lab: cfg.apply(p, x, t / div, *lab), tsch, **kw),
        convert.from_flax(tree), Replay(draws), torch.from_numpy(x0),
        (torch.from_numpy(lab).long(),))
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * abs(float(ref_loss))
    paths, got = train.flatten(grads)
    ref = jax.tree_util.tree_leaves(ref_grads["params"])
    assert len(got) == len(ref)
    for path, g, r in zip(paths, got, ref):
        r = np.asarray(r)
        scale = float(np.abs(r).max())
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-5 * max(scale, 1e-30), (path, err, scale)


def test_time_first_loss_matches_jax():
    """``time_first`` calls apply_fn(params, t, x): the ScoreMLP
    convention, on 2-D data."""
    mlp = ScoreMLP(hidden=32, depth=2, out_dim=2)
    tree = convert.init_params(mlp, seed=7)
    x0 = np.random.default_rng(4).standard_normal((8, 2)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jm = JaxMLP(hidden=32, depth=2, out_dim=2)
    ref = jtrain.make_loss_fn(jm.apply, JaxVP(), time_first=True)(
        _jtree(tree), key, jnp.asarray(x0))
    got = train.make_loss_fn(mlp.apply, VPSchedule(), time_first=True)(
        convert.from_flax(tree),
        Replay(_jax_loss_draws(key, 8, x0.shape, False)),
        torch.from_numpy(x0))
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip_norm", [None, 0.5, 1e3])
def test_adam_step_matches_optax(clip_norm):
    """One step from a non-zero optax state (count 7), adam_eps 1e-5, the
    global-norm clip binding (0.5), not binding (1e3) or off: params and
    both moments to 1e-6 relative."""
    rng = np.random.default_rng(8)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    params = {"params": {"a": {"kernel": 0.1 * rnd(64, 32),
                               "bias": 0.02 * rnd(32)},
                         "b": {"embedding": rnd(7, 16)}, "c": rnd(1, 4, 16)}}
    like = jax.tree_util.tree_map(lambda a: rnd(*a.shape), params)
    grads = jax.tree_util.tree_map(lambda a: 0.05 * a, like)
    mu = jax.tree_util.tree_map(lambda a: 0.01 * a[::-1].copy(), like)
    nu = jax.tree_util.tree_map(lambda a: 1e-4 * a * a + 1e-6, like)
    adam = optax.adam(1e-3, eps=1e-5)
    tx = optax.chain(optax.clip_by_global_norm(clip_norm), adam) \
        if clip_norm else adam
    adam_state = (optax.ScaleByAdamState(
        count=jnp.asarray(7, jnp.int32), mu=_jtree(mu), nu=_jtree(nu)),
        optax.EmptyState())
    state = ((optax.EmptyState(), adam_state) if clip_norm else adam_state)
    upd, new_state = tx.update(_jtree(grads), state, _jtree(params))
    ref_params = optax.apply_updates(_jtree(params), upd)
    ref_adam = new_state[1][0] if clip_norm else new_state[0]

    got_params, got_state = train.Adam(1e-3, eps=1e-5, clip_norm=clip_norm) \
        .update(convert.from_flax(grads), convert.adam_from_optax(7, mu, nu),
                convert.from_flax(params))
    assert int(got_state["count"]) == 8
    for got, ref in ((got_params, ref_params), (got_state["mu"], ref_adam.mu),
                     (got_state["nu"], ref_adam.nu)):
        for g, r in zip(train.flatten(got)[1],
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-9)
    if clip_norm == 0.5:  # the bound binds: the step differs from no clip
        unclipped, _ = train.Adam(1e-3, eps=1e-5).update(
            convert.from_flax(grads), convert.adam_from_optax(7, mu, nu),
            convert.from_flax(params))
        assert not torch.equal(train.flatten(unclipped)[1][0],
                               train.flatten(got_params)[1][0])


def test_ema_update_and_one_step_denoise_match_jax():
    """The EMA to 1e-6 relative. The one-step x0 estimate divides eps_hat
    by alpha(0.9) = 0.0154: the forward's float32 summation noise (~3e-7)
    grows by sigma / alpha = 65, so 1e-4 absolute on values clipped to
    [-1, 1]."""
    cfg, jm = _configs()
    tree = convert.init_params(cfg, seed=9)
    rng = np.random.default_rng(10)
    a = {"w": rng.standard_normal((8, 5)).astype(np.float32),
         "b": {"v": rng.standard_normal(5).astype(np.float32)}}
    b = jax.tree_util.tree_map(lambda x: x[::-1].copy() * 2, a)
    ref = jtrain.ema_update(_jtree(a), _jtree(b), 0.99)
    got = train.ema_update(convert.from_flax(a), convert.from_flax(b), 0.99)
    for g, r in zip(train.flatten(got)[1], jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-9)
    key = jax.random.PRNGKey(4)
    shape = (4, 28, 28, 1)
    ref = jtrain.one_step_denoise_val(jm.apply, _jtree(tree), JaxVP(), key,
                                      shape)
    k1, k2 = jax.random.split(key)
    draws = [jax.random.normal(k1, shape), jax.random.normal(k2, shape)]
    got = train.one_step_denoise_val(
        cfg.apply, convert.from_flax(tree), VPSchedule(),
        Replay([np.asarray(d) for d in draws]), shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-4)


# ------------------------------------------------------------ train loops
def _jax_step_draws(key, chunk_lengths, n, bs, x_shape):
    """The draws of ``train_expert``'s JAX chunks, step by step: the batch
    indices from fold_in(fold_in(key, c), i)'s first half, then the loss's
    t and noise from its second."""
    out = []
    for c, length in enumerate(chunk_lengths):
        ck = jax.random.fold_in(key, c)
        for i in range(length):
            kb, kl = jax.random.split(jax.random.fold_in(ck, i))
            out.append(np.asarray(jax.random.randint(kb, (bs,), 0, n)))
            out += _jax_loss_draws(kl, bs, x_shape, False)
    return out


def test_train_expert_matches_jax():
    """2 chunks x 3 steps at lr 1e-3 with EMA 0.9 and the global-norm
    clip, every JAX draw replayed: the EMA tree to 1e-5 of each leaf's
    scale, the losses to 1e-5.

    Adam's epsilon is 1e-4 here, not 1e-8: the key bias's gradient is zero
    in exact arithmetic (the softmax ignores a shift that all keys share),
    so each framework's is float32 noise of ~1e-9. Adam at eps 1e-8 turns
    that noise into steps of about 0.1 lr whose signs the noise decides; at
    1e-4 into nothing. The real gradients are far above either."""
    cfg, jm = _configs()
    tree = convert.init_params(cfg, seed=12)
    images = np.random.default_rng(5).uniform(
        -1, 1, (16, 28, 28, 1)).astype(np.float32)
    key = jax.random.PRNGKey(21)
    kw = dict(steps=6, batch_size=4, steps_per_scan=3, lr=1e-3,
              ema_decay=0.9, clip_norm=1.0, adam_eps=1e-4)
    ref_ema, ref_losses = jtrain.train_expert(
        key, jm.apply, _jtree(tree), JaxVP(), jnp.asarray(images), **kw)
    draws = Replay(_jax_step_draws(key, [3, 3], 16, 4, (4, 28, 28, 1)))
    ema, losses = train.train_expert(
        draws, cfg.apply, convert.from_flax(tree), VPSchedule(),
        torch.from_numpy(images), **kw)
    assert not draws.queue  # every recorded draw was taken
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=0, atol=1e-5)
    moved = 0
    for path, g, r, p0 in zip(train.flatten(ema)[0], train.flatten(ema)[1],
                              jax.tree_util.tree_leaves(ref_ema["params"]),
                              train.flatten(convert.from_flax(tree))[1]):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-5 * float(np.abs(r).max()), (path, err)
        moved += not torch.equal(g, p0)
    assert moved  # the EMA moved away from the initial tree


def test_train_expert_resumable_is_bitwise(tmp_path):
    """Killed after chunk 1 and resumed (from a fresh init, which the
    checkpoint overrides): the EMA tree and the resumed losses are bitwise
    an uninterrupted port run's. The step files follow the contract."""
    cfg, _ = _configs()
    images = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (16, 28, 28, 1)).astype(np.float32))
    p0 = convert.flax_init(cfg, 1)
    kw = dict(steps=6, batch_size=4, steps_per_scan=3, lr=1e-3,
              ema_decay=0.9)
    full_ema, full_losses = train.train_expert_resumable(
        7, cfg.apply, p0, VPSchedule(), images,
        CheckpointManager(str(tmp_path / "a"), "exp"), "dit", **kw)
    mgr = CheckpointManager(str(tmp_path / "b"), "exp")
    train.train_expert_resumable(7, cfg.apply, p0, VPSchedule(), images,
                                 mgr, "dit", **dict(kw, steps=3))
    assert mgr.step_list("dit") == [3]
    ema, losses = train.train_expert_resumable(
        7, cfg.apply, convert.flax_init(cfg, 99), VPSchedule(), images, mgr,
        "dit", **kw)
    assert mgr.step_list("dit") == [3, 6]
    for a, b in zip(train.flatten(full_ema)[1], train.flatten(ema)[1]):
        assert torch.equal(a, b)
    assert torch.equal(losses, full_losses[3:])
    # the uninterrupted run is train_expert's, bitwise
    ema2, losses2 = train.train_expert(7, cfg.apply, p0, VPSchedule(),
                                       images, **kw)
    assert torch.equal(losses2, full_losses)
    assert all(torch.equal(a, b) for a, b in zip(
        train.flatten(full_ema)[1], train.flatten(ema2)[1]))
    with pytest.raises(ValueError, match="key"):
        train.train_expert_resumable(8, cfg.apply, p0, VPSchedule(), images,
                                     mgr, "dit", **kw)


def test_flax_init_is_the_zero_function():
    """The adaLN-Zero init: a DiT drawn by ``flax_init`` outputs zeros,
    with lecun-normal kernels elsewhere (within two of their standard
    deviations)."""
    cfg, _ = _configs(labels=True)
    params = convert.flax_init(cfg, 3)
    x, t, lab = _inputs(7)
    out = cfg.apply(params, torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(lab))
    assert float(out.abs().max()) == 0.0
    k = params["params"]["block_0"]["Dense_1"]["kernel"]
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert float(k.abs().max()) <= 2 * std and float(k.std()) > 0.5 * std


def test_training_entry_points_default_to_cuda(monkeypatch):
    """device=None means the card: without one the training entry points
    raise and never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_experts(steps=1, data_n=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.quality_gate(sanity=True)
