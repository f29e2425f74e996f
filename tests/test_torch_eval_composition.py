"""Port parity for ``eval_composition`` (``scripts/eval_composition.py``):
each operator's sampler against the script's ``_sample`` written out with
the JAX package on the same converted expert and probe trees and the JAX
draws replayed; the experts' training against the script's
``train_experts`` with every draw replayed; the scores, the report's
accuracies and the sweep's aggregate against the script's code on the same
samples; the argument checks; the cache; the entry point end to end on the
CPU, and that ``ito`` reaches no kernel wrapper.

Sizes: the ``shapes_ddim`` preset at base 8, widths (1, 2), 16 x 16, 4
samples, 6 steps (the script's ``--sanity`` cuts and smaller); training at
base 16 (every GroupNorm group holds two channels or more). The JAX UNet
runs XLA's GroupNorm (``use_pallas=False``), the port the kernel's plain
version on CPU tensors (``fused_gn=True``).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import eval as jeval
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu import train as jtrain
from composable_diffusion_models_tpu.models import DiT as JaxDiT
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.ops import divergence as jdiv
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import convert, train
from composable_diffusion_models_tpu_torch import eval as ceval
from composable_diffusion_models_tpu_torch import eval_composition as ec
from composable_diffusion_models_tpu_torch.models import unet as tunet
from composable_diffusion_models_tpu_torch.models.dit import DiT
from composable_diffusion_models_tpu_torch.models.probe import ProbeClassifier
from composable_diffusion_models_tpu_torch.ops import attention, kernels
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.utils.config import get_config

torch.set_num_threads(1)
OV = ["--model.base_dim=8", "--model.channel_mults=(1,2)",
      "--data.img_size=16"]
SIZE, BS, N_STEPS, N_CLASSES = 16, 4, 6, (3, 3)
KEY = jax.random.PRNGKey(11)


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _close(got, ref, tol):
    """max |got - ref| <= tol * max(1, |ref|max)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _jax_unet(m):
    return JaxUNet(in_channels=m.in_channels, base_dim=m.base_dim,
                   channel_mults=m.channel_mults, num_classes=m.num_classes,
                   null_token=True, use_pallas=False)


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ttree(t, model):
    t = convert.from_flax(t)
    return convert.unet_torch_layout(t) if isinstance(model, tunet.UNet) \
        else t


@pytest.fixture(scope="module")
def experts():
    """Randomised trees of the script's two experts (a gray and an RGB
    factor-0 expert, the RGB color expert) and of the guidance probe."""
    cfg = get_config("shapes_ddim", OV)
    out = {"cfg": cfg}
    for name, ch in (("gray", 1), ("rgb", 3), ("color", 3)):
        m = ec.expert_model(cfg, ch, 3, SIZE, fused_gn=True)
        out[name] = (m, convert.init_params(m, seed=len(out) + 3))
    gm = ProbeClassifier(N_CLASSES, in_channels=3)
    out["gprobe"] = (gm, convert.init_params(gm, seed=9))
    return out


def _ito_probes(key, n_steps, shape):
    """``ito_kappa_ode``'s Rademacher probes: k, k1, k2 = split(k, 3)."""
    out = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        out.append(np.stack([
            _np(jdiv._probe(k, shape, jnp.float32, "rademacher"))
            for k in (k1, k2)]))
    return np.stack(out)


def _jax_sample(op, shape_model, color_model, jsp, jcp, jgpp, sl, cl,
                weights, k, *, f0_ch, gray_norm=False, gray_w=None,
                t_switch=None, corrector_steps=0, corrector_t_max=1.0,
                gprobe_model=None):
    """The script's ``_sample`` (``scripts/eval_composition.py:379-494``)
    with its closure variables as arguments."""
    schedule, bs = JaxVP(), sl.shape[0]
    null_s = jnp.full((bs,), N_CLASSES[0], jnp.int32)
    null_c = jnp.full((bs,), N_CLASSES[1], jnp.int32)
    weights = jnp.asarray(weights, jnp.float32)

    def apply_f0(params, x, t, labels):
        if f0_ch == 1:
            return jexperts.gray_to_rgb(
                shape_model.apply(params, jexperts.rgb_to_gray(
                    x, normalized=gray_norm, weights=gray_w), t, labels),
                normalized=gray_norm, weights=gray_w)
        return shape_model.apply(params, x, t, labels)

    if op == "ito":
        x_init = jax.random.normal(k, (bs, SIZE, SIZE, 3))
        return jsamplers.ito_kappa_ode(
            (lambda x, t: -apply_f0(jsp, x, t, sl),
             lambda x, t: -color_model.apply(jcp, x, t, cl)), schedule,
            jax.random.fold_in(k, 1), x_init, N_STEPS)

    def proj_strength(t):
        if t_switch is None:
            return weights[0]
        return weights[0] * (t >= t_switch)

    def eps_fn(x, t):
        if op in ("proj", "proj_cg"):
            e_c = color_model.apply(jcp, x, t, cl)
            e_s = shape_model.apply(jsp, jexperts.rgb_to_gray(
                x, normalized=True, weights=gray_w), t, sl)
            return jcompose.projected(e_c, e_s, proj_strength(t),
                                      proj=gray_w or jcompose.LUMA_W)
        if op == "proj_cfg":
            xg = jexperts.rgb_to_gray(x, normalized=True, weights=gray_w)
            e_s2 = shape_model.apply(jsp, jnp.concatenate([xg, xg]), t,
                                     jnp.concatenate([sl, null_s]))
            e_c2 = color_model.apply(jcp, jnp.concatenate([x, x]), t,
                                     jnp.concatenate([cl, null_c]))
            e_s = e_s2[bs:] + weights[0] * (e_s2[:bs] - e_s2[bs:])
            e_c = e_c2[bs:] + weights[1] * (e_c2[:bs] - e_c2[bs:])
            return jcompose.projected(e_c, e_s, 1.0,
                                      proj=gray_w or jcompose.LUMA_W)
        if op == "cfg":
            x2 = jnp.concatenate([x, x])
            e_s2 = apply_f0(jsp, x2, t, jnp.concatenate([sl, null_s]))
            e_c2 = color_model.apply(jcp, x2, t,
                                     jnp.concatenate([cl, null_c]))
            eps_u = 0.5 * (e_s2[bs:] + e_c2[bs:])
            return jcompose.cfg(eps_u, jnp.stack([e_s2[:bs], e_c2[:bs]]),
                                weights)
        e_shape = apply_f0(jsp, x, t, sl)
        e_color = color_model.apply(jcp, x, t, cl)
        if op == "cg":
            return jcompose.weighted(jnp.stack([e_shape, e_color]),
                                     jnp.ones((2,)))
        return jcompose.weighted(jnp.stack([e_shape, e_color]), weights)

    if op in ("cg", "proj_cg"):
        def logp_fn(x, t):
            lg_s, lg_c = gprobe_model.apply(jgpp, x)
            rows = jnp.arange(bs)
            return (jax.nn.log_softmax(lg_s, axis=-1)[rows, sl]
                    + jax.nn.log_softmax(lg_c, axis=-1)[rows, cl])

        if op == "proj_cg" and t_switch is not None:
            def scale(t):
                return weights[1] * (t < t_switch)
        else:
            scale = weights[0] if op == "cg" else weights[1]
        eps_fn = jsamplers.make_classifier_guided_eps_fn(
            eps_fn, schedule, logp_fn, scale=scale)
    x_init = jax.random.normal(k, (bs, SIZE, SIZE, 3))
    return jsamplers.ddim(eps_fn, schedule, x_init, N_STEPS,
                          key=jax.random.fold_in(k, 999),
                          corrector_steps=corrector_steps,
                          corrector_t_max=corrector_t_max)


def _port_draws(k, op, corrector_steps=0, corrector_t_max=1.0):
    """The JAX draws in the order the port's ``Composer`` makes them: the
    initial noise, then the corrector's where it is not gated off; and
    ``ito``'s probes."""
    shape = (BS, SIZE, SIZE, 3)
    draws = [_np(jax.random.normal(k, shape))]
    probes = None
    if op == "ito":
        probes = torch.from_numpy(_ito_probes(jax.random.fold_in(k, 1),
                                              N_STEPS, shape))
    grid = np.asarray(JaxVP().ddim_grid(N_STEPS, 1.0, 1e-3, "linear"))
    ck = jax.random.fold_in(k, 999)
    for i in range(N_STEPS):
        if corrector_steps and grid[i + 1] <= np.float32(corrector_t_max):
            draws += [_np(jax.random.normal(jax.random.fold_in(
                ck, N_STEPS + 1 + i * corrector_steps + j), shape))
                for j in range(corrector_steps)]
    return Replay(draws), probes


# Bar: the same arithmetic in both frameworks over 6 steps, float32; the
# first DDIM step divides by alpha(1) ~ 7e-3 and the ito step by sigma.
# Measured at most ~2e-6 of the scale. 1e-4 of the scale.
@pytest.mark.parametrize("op,kw", [
    ("avg", {"weights": (1.0, 2.0)}),
    ("avg", {"f0": "rgb", "corrector_steps": 1, "corrector_t_max": 0.5}),
    ("cfg", {"weights": (2.0, 1.5)}),
    ("cfg", {"f0": "rgb", "weights": (1.5, 1.0)}),
    ("proj", {"weights": (2.0, 1.0), "gray_norm": True}),
    ("proj", {"weights": (1.5, 1.0), "gray_norm": True, "t_switch": 0.5,
              "gray_w": (1.0, 1.0, 1.0)}),
    ("proj_cfg", {"weights": (2.0, 1.5), "gray_norm": True}),
    ("ito", {"gray_norm": True}),
    ("cg", {"weights": (2.0, 1.0)}),
    ("proj_cg", {"weights": (1.0, 3.0), "gray_norm": True,
                 "t_switch": 0.5}),
], ids=lambda v: v if isinstance(v, str) else ",".join(
    f"{k}={w}" for k, w in v.items()))
def test_composer_matches_the_script(experts, op, kw):
    """Each operator of the script's ``_sample`` at combination (2, 1)."""
    kw = dict(kw)
    f0 = kw.pop("f0", "gray")
    weights = kw.pop("weights", (1.0, 1.0))
    f0_ch = 1 if f0 == "gray" else 3
    (sm, st), (cm, ct) = experts[f0], experts["color"]
    gm, gt = experts["gprobe"]
    sl, cl = np.full((BS,), 2, np.int32), np.full((BS,), 1, np.int32)
    k = jax.random.fold_in(KEY, 17)
    ref = _jax_sample(op, _jax_unet(sm), _jax_unet(cm), _jtree(st),
                      _jtree(ct), _jtree(gt), jnp.asarray(sl),
                      jnp.asarray(cl), weights, k, f0_ch=f0_ch,
                      gprobe_model=jeval.ProbeClassifier(N_CLASSES), **kw)
    key, probes = _port_draws(k, op, kw.get("corrector_steps", 0),
                              kw.get("corrector_t_max", 1.0))
    models = [dataclasses.replace(m, fused_gn=op != "ito") for m in (sm, cm)]
    comp = ec.Composer(op, *models, VPSchedule(), N_CLASSES, SIZE, N_STEPS,
                       f0_ch=f0_ch, gprobe_model=gm, **kw)
    got = comp(_ttree(st, sm), _ttree(ct, cm), convert.from_flax(gt),
               torch.from_numpy(sl).long(), torch.from_numpy(cl).long(),
               weights, key, probes=probes)
    assert not key.queue
    _close(got, ref, 1e-4)


def test_composer_dit_backbone_matches_the_script():
    """``--model.kind=dit``: the unfolded DiT (patch 4, width 32, depth 2,
    2 heads, the null token) under avg and cfg."""
    cfg = get_config("shapes_ddim", OV + [
        "--model.kind=dit", "--model.hidden=32", "--model.depth=2",
        "--model.n_heads=2"])
    models = [ec.expert_model(cfg, ch, 3, SIZE) for ch in (3, 3)]
    assert all(isinstance(m, DiT) and m.null_token for m in models)
    trees = [convert.init_params(m, seed=20 + i)
             for i, m in enumerate(models)]
    jm = JaxDiT(patch=4, dim=32, depth=2, n_heads=2, in_channels=3,
                num_classes=(3,), null_token=True)
    sl, cl = np.full((BS,), 0, np.int32), np.full((BS,), 2, np.int32)
    for op in ("avg", "cfg"):
        k = jax.random.fold_in(KEY, 3)
        ref = _jax_sample(op, jm, jm, _jtree(trees[0]), _jtree(trees[1]),
                          None, jnp.asarray(sl), jnp.asarray(cl), (1.0, 2.0),
                          k, f0_ch=3)
        key, _ = _port_draws(k, op)
        got = ec.Composer(op, *models, VPSchedule(), N_CLASSES, SIZE,
                          N_STEPS)(
            *(convert.from_flax(t) for t in trees), None,
            torch.from_numpy(sl).long(), torch.from_numpy(cl).long(),
            (1.0, 2.0), key)
        _close(got, ref, 1e-4)


# --------------------------------------------------------------- training
TRAIN_OV = ["--model.base_dim=16", "--model.channel_mults=(1,2)",
            "--data.img_size=16", "--train.steps=12",
            "--train.batch_size=8"]


def _vp_step_draws(key, steps, n, bs, shape, dropout):
    """The JAX training loop's draws in the port's order, one chunk: step
    i's batch indices, then its loss's t, noise and dropout uniforms."""
    out = []
    ck = jax.random.fold_in(key, 0)
    for i in range(steps):
        kb, kl = jax.random.split(jax.random.fold_in(ck, i))
        out.append(_np(jax.random.randint(kb, (bs,), 0, n)))
        kt, ke, kd = jax.random.split(kl, 3)
        out.append(_np(jax.random.uniform(kt, (bs,), minval=1e-3,
                                          maxval=1.0)))
        out.append(_np(jax.random.normal(ke, (bs,) + shape)))
        if dropout:
            out.append(_np(jax.random.uniform(kd, (bs,))))
    return out


@pytest.fixture(scope="module")
def cell_run():
    """The script's ``train_experts`` for holdout (2, 2) with
    ``--factor0_grayscale --gray_norm --hue_aug 0.25`` at base 16 on 64
    shapes of 16 x 16, 12 steps of batch 8, and the port's on the same
    flax inits with every draw replayed."""
    cfg = get_config("shapes_ddim", TRAIN_OV)
    from composable_diffusion_models_tpu.utils import get_config as jget
    jcfg = jget("shapes_ddim", TRAIN_OV)
    models = [ec.expert_model(cfg, ch, 3, SIZE) for ch in (1, 3)]
    jmodels = [_jax_unet(m) for m in models]
    key = jax.random.PRNGKey(0)
    kc = jax.random.fold_in(key, 50)
    held = jdata.make_shapes_dataset(64, SIZE, holdout=[(2, 2)])
    imgs, hs, hc = held
    lab0 = jnp.zeros((1,), jnp.int32)
    inits = [jax.tree_util.tree_map(np.asarray, jm.init(
        key, jnp.zeros((1, SIZE, SIZE, m.in_channels)), jnp.ones((1,)),
        lab0)) for jm, m in zip(jmodels, models)]
    gains = jax.random.uniform(jax.random.fold_in(kc, 5),
                               (imgs.shape[0], 1, 1, 3), minval=0.25,
                               maxval=1.0)
    f0_imgs = jexperts.rgb_to_gray(((imgs + 1.0) * 0.5 * gains) * 2.0 - 1.0,
                                   normalized=True)
    t = jcfg.train
    refs, draws = [], [_np(gains)]
    for i, (jm, x, lab, init) in enumerate(
            ((jmodels[0], f0_imgs, hs, inits[0]),
             (jmodels[1], imgs, hc, inits[1]))):
        p, losses = jtrain.train_expert(
            jax.random.fold_in(kc, 2 + i), jm.apply, _jtree(init), JaxVP(),
            x, (lab,), steps=t.steps, batch_size=t.batch_size, lr=t.lr,
            uncond_prob=0.1, null_labels=(3,))
        refs.append((p, losses))
        draws += _vp_step_draws(jax.random.fold_in(kc, 2 + i), t.steps,
                                imgs.shape[0], t.batch_size,
                                tuple(x.shape[1:]), True)
    replay = Replay(draws)
    got = ec.train_cell_experts(
        replay, cfg, *models, VPSchedule(), tuple(torch.from_numpy(
            np.array(a)).to(torch.float32 if a.dtype == jnp.float32
                            else torch.long) for a in held),
        N_CLASSES, [convert.from_flax(i) for i in inits],
        factor0_grayscale=True, gray_norm=True, hue_aug=0.25)
    assert not replay.queue and got[2] is None
    return dict(models=models, inits=inits, refs=refs, got=got, draws=draws)


def test_train_cell_experts_matches_the_script(cell_run):
    """Each leaf of both trained trees within 1e-5 of its scale or 1e-2
    of the distance it moved from its init (Adam at epsilon 1e-8 moves a
    small-gradient leaf by a learning rate a step whatever the gradient's
    float32 rounding; see ``tests/test_torch_config_cli.py``); the run
    dropped some labels to the null token."""
    r = cell_run
    for m, (ref, _), got, init in zip(r["models"], r["refs"], r["got"],
                                      r["inits"]):
        ref, init = (_ttree(jax.tree_util.tree_map(np.asarray, t), m)
                     for t in (ref, init))
        paths, leaves = train.flatten(got)
        assert paths == train.flatten(ref)[0]
        for p, g, rr, i0 in zip(paths, leaves, train.flatten(ref)[1],
                                train.flatten(init)[1]):
            err = float((g - rr).abs().max())
            bar = max(1e-5 * float(rr.abs().max()),
                      1e-2 * float((rr - i0).abs().max()))
            assert err <= bar, (p, err, bar)
    drops = [d for d in r["draws"][1:] if d.shape == (8,)
             and d.dtype == np.float32]
    assert any((d < 0.1).any() for d in drops[1::2])


def test_gray_expert_loss_and_grads_match_jax(cell_run):
    """One step of the gray factor-0 expert's loss (VP, label dropout 0.5
    to the null label 3) on the same x0, t, noise and dropout uniforms: the
    loss to 1e-6 relative, every gradient leaf to 1e-5 of its scale."""
    m, init = cell_run["models"][0], cell_run["inits"][0]
    jm = _jax_unet(m)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, (8, SIZE, SIZE, 1)).astype(np.float32)
    lab = rng.integers(0, 3, 8).astype(np.int32)
    key = jax.random.PRNGKey(4)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jtrain.make_loss_fn(
        jm.apply, JaxVP(), uncond_prob=0.5, null_labels=(3,))))(
        _jtree(init), key, jnp.asarray(x0), (jnp.asarray(lab),))
    kt, ke, kd = jax.random.split(key, 3)
    draws = [_np(jax.random.uniform(kt, (8,), minval=1e-3, maxval=1.0)),
             _np(jax.random.normal(ke, x0.shape)),
             _np(jax.random.uniform(kd, (8,)))]
    assert 0 < (draws[2] < 0.5).sum() < 8
    loss, grads = train.value_and_grad(
        train.make_loss_fn(m.apply, VPSchedule(), uncond_prob=0.5,
                           null_labels=(3,)),
        _ttree(init, m), Replay(draws), torch.from_numpy(x0),
        (torch.from_numpy(lab).long(),))
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)
    ref = _ttree(jax.tree_util.tree_map(np.asarray, ref_grads), m)
    for p, g, r in zip(*train.flatten(grads), train.flatten(ref)[1]):
        err = float((g - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), (p, err)


# ------------------------------------------------------- scores, report
def test_combo_scores_match_the_script(experts):
    """Two float32 probes on the same samples: the logits to 1e-5 of
    their scale, and the score row (accuracies, margins, cross-probe
    agreement) as the script's scoring loop computes it from them: the
    accuracies exactly, the margins to 1e-6."""
    rng = np.random.default_rng(7)
    x = (rng.uniform(-1, 1, (16, SIZE, SIZE, 3))
         * rng.uniform(0, 1, (16, 1, 1, 1))).astype(np.float32)
    pms = [ProbeClassifier(N_CLASSES, 8, in_channels=3) for _ in range(2)]
    trees = [convert.init_params(pm, seed=40 + i) for i, pm in
             enumerate(pms)]
    jpm = jeval.ProbeClassifier(N_CLASSES, 8)
    for t, pm in zip(trees, pms):
        for g, r in zip(pm.apply(convert.from_flax(t), torch.from_numpy(x)),
                        jpm.apply(_jtree(t), jnp.asarray(x))):
            _close(g, r, 1e-5)
    target, holdout = (1, 2), [(1, 2)]
    ref = jeval.compositional_scores(jpm, _jtree(trees[0]), jnp.asarray(x),
                                     target)
    s2 = jeval.compositional_scores(jpm, _jtree(trees[1]), jnp.asarray(x),
                                    target)
    ref["probe2_joint_acc"] = s2["joint_acc"]
    ref["probe2_joint_target_prob"] = s2["joint_target_prob"]
    ref["joint_acc_agree_p2"] = float(jnp.mean(
        jeval.joint_hits(jpm, _jtree(trees[0]), jnp.asarray(x), target)
        & jeval.joint_hits(jpm, _jtree(trees[1]), jnp.asarray(x), target)))
    ref["held_out"] = target in holdout
    got = ec.combo_scores([(pm, convert.from_flax(t))
                           for pm, t in zip(pms, trees)],
                          torch.from_numpy(x), target, holdout)
    assert got.keys() == ref.keys() and got["held_out"] is True
    for k, v in ref.items():
        if k.endswith("acc") or "agree" in k:
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, abs=1e-6), k


def test_aggregate_matches_the_script():
    """The sweep's per-operator aggregate (``eval_composition.py:651-662``)
    on two cells, one of which lacks an operator."""
    cells = {"2-2": {"avg": {"heldout_joint_acc": 0.25,
                             "seen_joint_acc": 0.5},
                     "ito": {"heldout_joint_acc": 0.75,
                             "seen_joint_acc": 0.125}},
             "0-1": {"avg": {"heldout_joint_acc": 0.5,
                             "seen_joint_acc": 0.375}}}
    ref = {}
    for wtag in next(iter(cells.values())):
        held = [c[wtag]["heldout_joint_acc"] for c in cells.values()
                if wtag in c]
        seen = [c[wtag]["seen_joint_acc"] for c in cells.values()
                if wtag in c]
        ref[wtag] = {"heldout_joint_acc_mean": sum(held) / len(held),
                     "heldout_joint_acc_min": min(held),
                     "heldout_joint_acc_max": max(held),
                     "seen_joint_acc_mean": sum(seen) / len(seen),
                     "n_cells": len(held)}
    assert ec.aggregate(cells) == ref


@pytest.mark.parametrize("kw,match", [
    ({"op": "avg,sum"}, "unknown op"),
    ({"op": "cfg", "uncond_prob": 0.0}, "uncond_prob"),
    ({"op": "proj", "factor0_grayscale": True}, "gray_norm"),
    ({"op": "avg", "hue_aug": 0.25}, "factor0_grayscale"),
    ({"op": "avg", "weight_grid": [[1.0, -1.0]]}, "sum to 0"),
])
def test_argument_checks_match_the_script(kw, match):
    """The script's ``ap.error`` cases raise before any work."""
    args = dict(op="avg", uncond_prob=0.1, factor0_grayscale=False,
                gray_norm=False, hue_aug=0.0, weight_grid=[[1.0, 1.0]])
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        ec.check_ops(**args)
    with pytest.raises(ValueError, match=match):
        ec.eval_composition(device="cpu", **{k: v for k, v in kw.items()})


def test_canonical_and_hash():
    assert ec.canonical("ito", (1, 2)) == ("ito",)
    assert ec.canonical("avg", (1, 3)) == ec.canonical("avg", (2, 6))
    assert ec.canonical("proj", (2, 1)) == ec.canonical("proj", (2, 5))
    assert ec.canonical("cfg", (2, 1)) != ec.canonical("cfg", (2, 5))
    assert ec.cfg_hash({"a": 1, "b": [2]}) == ec.cfg_hash({"b": [2], "a": 1})
    assert len(ec.cfg_hash({"a": 1})) == 10


# ------------------------------------------------------------ end to end
E2E = dict(samples_per_combo=2, probe_steps=2, n_steps=2,
           overrides=OV + ["--train.steps=2", "--train.batch_size=4",
                           "--data.n=27"], device="cpu")


def _no_kernel(monkeypatch):
    """Every kernel wrapper the experts' forwards or the blend could reach
    raises."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was reached")
    for mod, name in ((tunet, "groupnorm_silu"), (tunet,
                                                  "groupnorm_silu_split"),
                      (tunet, "flash_attention"), (ec, "blend_eps"),
                      (kernels, "blend_eps"), (attention, "flash_attention")):
        monkeypatch.setattr(mod, name, boom)


def test_ito_route_reaches_no_kernel_wrapper(tmp_path, monkeypatch):
    """The whole protocol under ``op="ito"`` with every wrapper replaced
    by one that raises: the experts' jvps run in PyTorch ops alone."""
    _no_kernel(monkeypatch)
    rep = ec.eval_composition(op="ito", factor0_grayscale=True,
                              gray_norm=True, out=str(tmp_path), **E2E)
    assert set(rep["ops"]) == {"ito"}
    with pytest.raises(AssertionError, match="kernel wrapper"):
        ec.eval_composition(op="avg", out=str(tmp_path), **E2E)


@pytest.mark.parametrize("op", ec.KNOWN_OPS)
def test_build_composer_routes(op):
    """Each operator's experts: GroupNorm + SiLU through the kernel except
    under ``ito`` (its jvps) or with ``fused_gn=False``; the guidance
    probe's model for ``cg`` / ``proj_cg`` alone."""
    cfg = get_config("shapes_ddim", OV)
    comp = ec.build_composer(op, cfg, N_CLASSES, SIZE, 3, f0_ch=1)
    assert [m.fused_gn for m in (comp.shape_model, comp.color_model)] == [
        op != "ito"] * 2
    assert (comp.shape_model.in_channels, comp.color_model.in_channels) == (
        1, 3)
    assert (comp.gprobe_model is not None) == (op in ("cg", "proj_cg"))
    plain = ec.build_composer(op, cfg, N_CLASSES, SIZE, 3, fused_gn=False)
    assert not plain.shape_model.fused_gn and not plain.color_model.fused_gn


def test_eval_composition_end_to_end(tmp_path, monkeypatch):
    """The protocol on the CPU: the report's keys and layout as the
    script writes them, its file, the grid, the cache (a second run
    trains nothing; a corrupt cache file is rebuilt)."""
    rep = ec.eval_composition(op="avg,cfg", weight_grid=[[1, 1], [2, 2],
                                                         [2, 1]],
                              out=str(tmp_path), **E2E)
    res = tmp_path / "eval_composition" / "run_0" / "results"
    with open(res / "compositional_eval_shapes_avg-cfg.json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert rep["holdout"] == [[2, 2]] and rep["dataset"] == "shapes"
    assert rep["weight_grid"] == [[1, 1], [2, 2], [2, 1]]
    # avg at (2, 2) is avg at (1, 1): skipped, as the script skips it
    assert set(rep["ops"]) == {"avg_w1x1", "avg_w2x1", "cfg_w1x1",
                               "cfg_w2x2", "cfg_w2x1"}
    r = rep["ops"]["avg_w2x1"]
    assert r["weights"] == [2, 1] and len(r["combos"]) == 9
    assert r["combos"]["2,2"]["held_out"] and not r["combos"]["0,0"][
        "held_out"]
    held = r["combos"]["2,2"]["joint_acc"]
    seen = np.mean([v["joint_acc"] for k, v in r["combos"].items()
                    if k != "2,2"])
    assert r["heldout_joint_acc"] == held
    assert r["seen_joint_acc"] == pytest.approx(seen)
    assert (res / "eval_samples_grid_shapes_avg-cfg_avg_w2x1.png").exists()
    caches = sorted(p.name for p in res.glob("cache_*.pt"))
    assert len(caches) == 2
    with open(res / caches[1], "wb") as f:    # the probe's, truncated
        f.write(b"\x00\x01")

    def no_training(*a, **k):
        raise AssertionError("trained again")
    monkeypatch.setattr(train, "train_expert", no_training)
    rep2 = ec.eval_composition(op="avg,cfg", weight_grid=[[1, 1], [2, 2],
                                                          [2, 1]],
                               out=str(tmp_path), **E2E)
    assert rep2["ops"]["avg_w2x1"]["combos"] == r["combos"]


def test_holdout_sweep_resumes(tmp_path):
    """A sweep over two cells with two probes writes ``cells`` (each row
    with the second probe's accuracy, margin and agreement) and
    ``aggregate``; run again it loads both cells from its
    ``.partial.json``."""
    kw = dict(op="avg", holdout_sweep=[[2, 2], [0, 1]], probe_seeds=2,
              out=str(tmp_path), **E2E)
    rep = ec.eval_composition(**kw)
    assert set(rep["cells"]) == {"2-2", "0-1"}
    row = rep["cells"]["0-1"]["avg"]["combos"]["0,1"]
    assert row["held_out"] and {"probe2_joint_acc",
                                "probe2_joint_target_prob",
                                "joint_acc_agree_p2"} <= set(row)
    assert rep["sweep_cells"] == [[[2, 2]], [[0, 1]]]
    assert rep["aggregate"] == ec.aggregate(rep["cells"])
    assert rep["aggregate"]["avg"]["n_cells"] == 2
    res = tmp_path / "eval_composition" / "run_0" / "results"
    assert (res / "compositional_sweep_shapes_avg.partial.json").exists()
    for p in res.glob("cache_*.pt"):
        p.unlink()
    rep2 = ec.eval_composition(**kw)
    assert rep2["cells"] == rep["cells"]
    # the probe comes before the cells, as in the script; no expert trained
    assert sorted(p.name[:12] for p in res.glob("cache_*.pt")) == [
        "cache_probe0", "cache_probe1"]


def test_dit_backbone_end_to_end(tmp_path):
    """``--model.kind=dit``: the protocol trains and samples the unfolded
    DiT experts (width 32, depth 2, the null token) under avg and cfg."""
    rep = ec.eval_composition(op="avg,cfg", out=str(tmp_path), **dict(
        E2E, overrides=E2E["overrides"] + [
            "--model.kind=dit", "--model.hidden=32", "--model.depth=2",
            "--model.n_heads=2"]))
    assert set(rep["ops"]) == {"avg", "cfg"}
    assert all(len(r["combos"]) == 9 for r in rep["ops"].values())


def test_colored_mnist_cells(tmp_path):
    """``dataset="colored_mnist"``: 10 x 3 combinations at 28 x 28."""
    rep = ec.eval_composition(op="avg", dataset="colored_mnist",
                              holdout=((7, 2),), out=str(tmp_path),
                              **dict(E2E, overrides=OV + [
                                  "--train.steps=1", "--data.n=40"]))
    combos = rep["ops"]["avg"]["combos"]
    assert len(combos) == 30 and combos["7,2"]["held_out"]


def test_sanity_cuts(monkeypatch, tmp_path):
    """``sanity=True`` makes the script's cuts: the probe's 200 steps, 8
    samples a combination, at most 20 steps, the config's sanity sizes."""
    seen = {}
    orig = ceval.train_probe

    def probe(*a, **k):
        seen["probe_steps"] = k["steps"]
        return orig(*a, **dict(k, steps=1))
    monkeypatch.setattr(ceval, "train_probe", probe)
    monkeypatch.setattr(ec.Composer, "__call__",
                        lambda self, sp, cp, gpp, sl, cl, w, key, **kw:
                        seen.update(bs=sl.shape[0], n=self.n_steps)
                        or torch.zeros((sl.shape[0], SIZE, SIZE, 3)))
    orig_train = train.train_expert

    def train_expert(*a, **k):
        seen["steps"], seen["batch"] = k["steps"], k["batch_size"]
        return orig_train(*a, **dict(k, steps=1))
    monkeypatch.setattr(train, "train_expert", train_expert)
    ec.eval_composition(op="avg", sanity=True, n_steps=50, out=str(tmp_path),
                        overrides=OV, device="cpu")
    assert seen == {"probe_steps": 200, "bs": 8, "n": 20, "steps": 20,
                    "batch": 8}


def test_eval_composition_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec.eval_composition(out=str(tmp_path))
    assert not os.listdir(tmp_path)
