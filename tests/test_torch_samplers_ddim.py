"""Port parity for the rest of the DDIM family and the mixed-channel
experts, against the JAX package on the same inputs:

* ``samplers.ddim`` with eta in {0.5, 1} (the JAX ``fold_in`` draws
  replayed through ``rng.Replay``), x0 and v prediction, and the Langevin
  corrector with and without ``corrector_t_max``; the eta = 0, eps path
  bit for bit what it was; ``dpm_solver_pp_2m`` on both spacings. The
  closures are fixed maps of (x, t) in float32, the same in both
  frameworks, so the samplers' own arithmetic is what is compared;
* ``experts.rgb_to_gray`` / ``gray_to_rgb`` (both forms, custom weights)
  and ``experts.grouped_eps_fn`` (with its refusal of mismatched adapters
  and lifts);
* ``entry.sample_gray_color`` whole at ``device="cpu"`` on narrow UNets
  (base 8, mults (1, 2), 16 x 16 images, 8 DDIM steps), against
  ``scripts/compose_images_ddim.py``'s computation with the JAX ``UNet`` on
  XLA's GroupNorm (``use_pallas=False``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import (convert, entry, experts,
                                                   rng, samplers)
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

torch.set_num_threads(1)

SHAPE = (3, 6, 6, 2)
N_STEPS = 20
KEY = jax.random.PRNGKey(11)
MU = np.random.default_rng(2).uniform(-0.5, 0.5, SHAPE[1:]).astype(
    np.float32)


@pytest.fixture(scope="module")
def x_init():
    return np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)


def _closures(predict):
    """(jax, torch) closures of (x, t): fixed float32 maps, an eps, x0 or v
    estimate pulled toward MU, with t entering as a polynomial."""
    jmu, tmu = jnp.asarray(MU), torch.from_numpy(MU)

    def jfn(x, t):
        if predict == "eps":
            return (x - jmu) * (0.5 + 0.4 * t)
        if predict == "x0":
            return jmu + (x - jmu) * (0.3 * t)
        return (x - jmu) * (0.6 * t) - 0.2 * jmu

    def tfn(x, t):
        if predict == "eps":
            return (x - tmu) * (0.5 + 0.4 * t)
        if predict == "x0":
            return tmu + (x - tmu) * (0.3 * t)
        return (x - tmu) * (0.6 * t) - 0.2 * tmu

    return jfn, tfn


def _ddim_draws(key, n_steps, eta, corrector_steps, t_next_ok):
    """The JAX sampler's normals in the order the port makes them: step
    i's eta noise from fold_in(key, i), then its corrector draws from
    fold_in(key, n_steps + 1 + i * corrector_steps + j), where the
    corrector is not gated off."""
    out = []
    for i in range(n_steps):
        if eta > 0:
            out.append(jax.random.normal(jax.random.fold_in(key, i), SHAPE))
        if corrector_steps and t_next_ok[i]:
            out += [jax.random.normal(jax.random.fold_in(
                key, n_steps + 1 + i * corrector_steps + j), SHAPE)
                for j in range(corrector_steps)]
    return out


def _close(got, ref, tol):
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert err <= tol * scale, (err, scale)


# Bar: the sampler's arithmetic alone over 20 steps, float32 both sides on
# the same (float32) tables; XLA may fuse a multiply-add where torch rounds
# twice. Measured below 1e-6 of the scale. 1e-5 of the scale.
TOL = 1e-5


@pytest.mark.parametrize("kw", [
    {"eta": 0.5}, {"eta": 1.0}, {"predict": "x0"}, {"predict": "v"},
    {"predict": "x0", "eta": 1.0, "spacing": "karras"},
    {"corrector_steps": 1},
    {"corrector_steps": 2, "corrector_t_max": 0.5, "eta": 0.5}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_ddim_matches_jax(x_init, kw):
    jfn, tfn = _closures(kw.get("predict", "eps"))
    cs = kw.get("corrector_steps", 0)
    needs_key = kw.get("eta", 0.0) > 0 or cs
    ref = np.asarray(jsamplers.ddim(jfn, JaxVP(), jnp.asarray(x_init),
                                    N_STEPS, key=KEY if needs_key else None,
                                    **kw))
    grid = np.asarray(JaxVP().ddim_grid(N_STEPS, 1.0, 1e-3,
                                        kw.get("spacing", "linear")))
    t_ok = grid[1:] <= np.float32(kw.get("corrector_t_max", 1.0))
    key = rng.Replay(_ddim_draws(KEY, N_STEPS, kw.get("eta", 0.0), cs, t_ok))
    got = samplers.ddim(tfn, VPSchedule(), torch.from_numpy(x_init), N_STEPS,
                        key=key if needs_key else None, **kw).numpy()
    assert not key.queue                      # every draw was used
    _close(got, ref, TOL)


def _ddim_before(eps_fn, schedule, x, n_steps, clip=(-1.0, 1.0),
                 clip_min_alpha=0.3):
    """``samplers.ddim`` as it was (eta 0, eps prediction only)."""
    table = schedule.ddim_table(n_steps).tolist()
    ts = schedule.ddim_grid(n_steps)[:-1]
    gate = torch.tensor(clip_min_alpha, dtype=torch.float32).item()
    for i, (a_now, s_now, a_next, s_next) in enumerate(table):
        out = eps_fn(x, ts[i])
        x0 = (x - s_now * out) / a_now
        if clip is not None and a_now >= gate:
            x0 = x0.clamp(clip[0], clip[1])
        x = a_next * x0 + s_next * out
    return x


@pytest.mark.parametrize("clip", [(-1.0, 1.0), None])
def test_ddim_eta0_eps_path_keeps_its_bits(x_init, clip):
    """The path that serves A, B, the DiT and the latent ddim: the same
    operations as before, so the same bits."""
    _, tfn = _closures("eps")
    x = torch.from_numpy(x_init)
    got = samplers.ddim(tfn, VPSchedule(), x, N_STEPS, clip=clip)
    assert torch.equal(got, _ddim_before(tfn, VPSchedule(), x, N_STEPS, clip))


def test_corrector_gate_skips_the_forward(x_init):
    """With corrector_t_max = 0.5 the corrector runs only at the levels at
    or below 0.5: one more forward each, none above."""
    calls = []
    _, tfn = _closures("eps")

    def counted(x, t):
        calls.append(float(t))
        return tfn(x, t)
    samplers.ddim(counted, VPSchedule(), torch.from_numpy(x_init), N_STEPS,
                  key=0, corrector_steps=1, corrector_t_max=0.5)
    grid = VPSchedule().ddim_grid(N_STEPS)
    n_gated_in = int((grid[1:] <= 0.5).sum())
    assert 0 < n_gated_in < N_STEPS
    assert len(calls) == N_STEPS + n_gated_in


def test_ddim_checks_its_arguments():
    x = torch.zeros(1, 4, 4, 1)
    sched = VPSchedule()
    with pytest.raises(ValueError, match="key"):
        samplers.ddim(lambda x, t: x, sched, x, 2, eta=0.5)
    with pytest.raises(ValueError, match="key"):
        samplers.ddim(lambda x, t: x, sched, x, 2, corrector_steps=1)
    with pytest.raises(ValueError, match="stable"):
        samplers.ddim(lambda x, t: x, VPSchedule(kind="cosine"), x, 2,
                      predict="v")
    with pytest.raises(ValueError, match="predict"):
        samplers.ddim(lambda x, t: x, sched, x, 2, predict="score")


def test_ddim_int_key_is_reproducible(x_init):
    _, tfn = _closures("eps")
    x = torch.from_numpy(x_init)

    def run(key):
        return samplers.ddim(tfn, VPSchedule(), x, 5, eta=1.0, key=key)
    assert torch.equal(run(4), run(4)) and not torch.equal(run(4), run(5))


@pytest.mark.parametrize("spacing", ["logsnr", "time"])
@pytest.mark.parametrize("n_steps", [5, 20])
def test_dpm_solver_pp_2m_matches_jax(x_init, spacing, n_steps):
    """The logsnr grid is jnp.interp over a 4096-point float32 lambda
    table; the port computes it on the host in float32 in jnp's order, on
    lambda values whose log and exp (torch's and XLA's) part by an ulp or
    two: the grids agree to 1e-6 and the samples to 1e-5 of the scale."""
    jfn, tfn = _closures("eps")
    ref = np.asarray(jsamplers.dpm_solver_pp_2m(
        jfn, JaxVP(), jnp.asarray(x_init), n_steps, spacing=spacing))
    ts = []
    got = samplers.dpm_solver_pp_2m(
        lambda x, t: (ts.append(float(t)), tfn(x, t))[1], VPSchedule(),
        torch.from_numpy(x_init), n_steps, spacing=spacing).numpy()
    # the JAX sampler's model-input grid, as it builds it
    sched = JaxVP()
    if spacing == "logsnr":
        dense = jnp.linspace(1.0, 1e-3, 4096)
        lam = jnp.log(sched.alpha(dense)) - jnp.log(sched.sigma(dense))
        jts = jnp.interp(jnp.linspace(lam[0], lam[-1], n_steps + 1), lam,
                         dense)
    else:
        jts = jnp.linspace(1.0, 1e-3, n_steps + 1)
    np.testing.assert_allclose(ts, np.asarray(jts)[:-1], rtol=0, atol=1e-6)
    _close(got, ref, TOL)
    with pytest.raises(ValueError, match="spacing"):
        samplers.dpm_solver_pp_2m(tfn, VPSchedule(), torch.zeros(1, 2), 2,
                                  spacing="karras")


def test_interp_matches_jnp():
    rng_ = np.random.default_rng(3)
    xp = np.sort(rng_.standard_normal(64)).astype(np.float32)
    xp[10] = xp[9]                                # a zero-width interval
    fp = rng_.standard_normal(64).astype(np.float32)
    x = np.concatenate([rng_.uniform(xp[0] - 1, xp[-1] + 1, 200),
                        xp[:5]]).astype(np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                jnp.asarray(fp)))
    got = samplers._interp(torch.from_numpy(x), torch.from_numpy(xp),
                           torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ------------------------------------------------------ mixed-channel experts
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("weights", [None, (1.0, 1.0, 1.0), (0.2, 0.5, 0.3)])
def test_gray_projection_and_lift_match_jax(normalized, weights):
    x = np.random.default_rng(4).standard_normal((2, 5, 5, 3)).astype(
        np.float32)
    g = np.random.default_rng(5).standard_normal((2, 5, 5, 1)).astype(
        np.float32)
    ref = np.asarray(jexperts.rgb_to_gray(jnp.asarray(x), normalized,
                                          weights))
    got = experts.rgb_to_gray(torch.from_numpy(x), normalized, weights)
    assert tuple(got.shape) == (2, 5, 5, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    ref = np.asarray(jexperts.gray_to_rgb(jnp.asarray(g), normalized,
                                          weights))
    got = experts.gray_to_rgb(torch.from_numpy(g), normalized, weights)
    assert tuple(got.shape) == (2, 5, 5, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_grouped_eps_fn_matches_jax():
    """A 1-channel group of two experts seen through the gray projection
    and lifted back, beside a 3-channel group of one: a (3, B, H, W, 3)
    stack; the lift applies per expert."""
    x = np.random.default_rng(6).standard_normal((2, 4, 4, 3)).astype(
        np.float32)
    ws = (0.5, -1.5, 2.0)

    def group(lib, stack, ks):
        return lambda v, t: stack([k * v + t for k in ks])
    jfn = jexperts.grouped_eps_fn(
        [group(jnp, jnp.stack, ws[:2]), group(jnp, jnp.stack, ws[2:])],
        [lambda v: jexperts.rgb_to_gray(v, True), lambda v: v],
        [lambda e: jexperts.gray_to_rgb(e, True), lambda e: e])
    tfn = experts.grouped_eps_fn(
        [group(torch, torch.stack, ws[:2]), group(torch, torch.stack, ws[2:])],
        [lambda v: experts.rgb_to_gray(v, True), lambda v: v],
        [lambda e: experts.gray_to_rgb(e, True), lambda e: e])
    ref = np.asarray(jfn(jnp.asarray(x), jnp.float32(0.3)))
    got = tfn(torch.from_numpy(x), torch.tensor(0.3)).numpy()
    assert got.shape == (3, 2, 4, 4, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # pass-through groups: empty adapters and lifts are identities
    same = experts.grouped_eps_fn([group(torch, torch.stack, ws)])
    assert tuple(same(torch.from_numpy(x), torch.tensor(0.0)).shape) == (
        3, 2, 4, 4, 3)
    with pytest.raises(ValueError, match="must match"):
        experts.grouped_eps_fn([group(torch, torch.stack, ws)] * 2,
                               [lambda v: v])
    with pytest.raises(ValueError, match="must match"):
        experts.grouped_eps_fn([group(torch, torch.stack, ws)] * 2,
                               lifts=[lambda e: e] * 3)


# ------------------------------------------------------ sample_gray_color
GRAY_STEPS, GB, GHW = 8, 2, 16
SMALL_COLOR = dataclasses.replace(entry.SHAPES_UNET, base_dim=8,
                                  channel_mults=(1, 2), time_emb_dim=32)
SMALL_GRAY = dataclasses.replace(SMALL_COLOR, in_channels=1)


def _jax_unet(cfg):
    return JaxUNet(**{f: getattr(cfg, f) for f in (
        "in_channels", "base_dim", "channel_mults", "time_emb_dim",
        "num_classes")}, use_pallas=False)


@pytest.fixture(scope="module")
def gray_color():
    sp = convert.init_params(SMALL_GRAY, seed=50)
    cp = convert.init_params(SMALL_COLOR, seed=51)
    x = np.random.default_rng(9).standard_normal(
        (GB, GHW, GHW, 3)).astype(np.float32)
    return sp, cp, x, np.array([0, 2], np.int32), np.array([1, 1], np.int32)


@pytest.mark.parametrize("op,protocol", [
    ("avg", "white"), ("avg", "luma_norm"), ("proj", "luma_norm")])
def test_sample_gray_color_matches_the_script(gray_color, op, protocol):
    """scripts/compose_images_ddim.py's eps_fn and DDIM, weights (1, 1):
    measured max |diff| ~1e-6 of outputs of scale ~1-3 after 8 steps whose
    first divides eps by alpha(1) ~ 0.007. Bar: 1e-4 of the scale."""
    sp, cp, x, sl, cl = gray_color
    normalized = protocol == "luma_norm"
    shape_model, color_model = _jax_unet(SMALL_GRAY), _jax_unet(SMALL_COLOR)
    jsp, jcp = (jax.tree_util.tree_map(jnp.asarray, t) for t in (sp, cp))
    weights = jnp.array([1.0, 1.0])

    def eps_fn(xx, t):
        e_gray = shape_model.apply(
            jsp, jexperts.rgb_to_gray(xx, normalized=normalized), t,
            jnp.asarray(sl))
        e_color = color_model.apply(jcp, xx, t, jnp.asarray(cl))
        if op == "proj":
            return jcompose.projected(e_color, e_gray, 1.0)
        return jcompose.weighted(jnp.stack(
            [jexperts.gray_to_rgb(e_gray, normalized=normalized), e_color]),
            weights)

    ref = np.asarray(jsamplers.ddim(eps_fn, JaxVP(), jnp.asarray(x),
                                    GRAY_STEPS))
    got = entry.sample_gray_color(
        convert.from_flax(sp), convert.from_flax(cp), x, sl, cl, op=op,
        gray_protocol=protocol, n_steps=GRAY_STEPS, device="cpu",
        shape_model=SMALL_GRAY, color_model=SMALL_COLOR).numpy()
    _close(got, ref, 1e-4)


def test_sample_gray_color_checks_its_arguments(gray_color):
    sp, cp, x, sl, cl = gray_color
    trees = (convert.from_flax(sp), convert.from_flax(cp))
    for kw, match in (({"op": "proj"}, "luma_norm"),
                      ({"op": "sum"}, "op"),
                      ({"gray_protocol": "rgb"}, "gray_protocol")):
        with pytest.raises(ValueError, match=match):
            entry.sample_gray_color(*trees, x, sl, cl, device="cpu",
                                    shape_model=SMALL_GRAY,
                                    color_model=SMALL_COLOR, **kw)


def test_gray_unet_is_the_scripts_shape_expert():
    assert entry.GRAY_UNET == dataclasses.replace(entry.SHAPES_UNET,
                                                  in_channels=1)


def test_sample_gray_color_defaults_to_cuda(monkeypatch, gray_color):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp, cp, x, sl, cl = gray_color
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.sample_gray_color(convert.from_flax(sp), convert.from_flax(cp),
                                x, sl, cl, shape_model=SMALL_GRAY,
                                color_model=SMALL_COLOR)
