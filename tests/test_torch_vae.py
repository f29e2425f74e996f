"""Port parity for the beta-VAE path: ``models.vae.BetaVAE`` (encode,
decode, apply) and ``vae_loss`` against flax at 28 x 28 and 16 x 16, the
pieces where a translation would read the weights differently (flax's
"SAME" padding with stride 2, the NHWC flatten, the nearest 2x resize),
the weight bridge (``convert.param_shapes`` / ``init_params`` /
``flax_init``), and the entry points of ``scripts/train_vae.py`` (every
JAX draw replayed) and ``scripts/compose_latent_vae.py`` (both modes, the
blend on and off the kernel's wrapper) against the scripts'
computation."""

import math
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu import train as jtrain
from composable_diffusion_models_tpu.models import BetaVAE as JaxVAE
from composable_diffusion_models_tpu.models import vae_loss as jvae_loss
from composable_diffusion_models_tpu.models.mlp import \
    LatentDiffusionMLP as JaxLatentMLP
from composable_diffusion_models_tpu.schedules import DDPMSchedule as JaxDDPM
from composable_diffusion_models_tpu_torch import convert, entry, train
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.models import vae as vae_mod
from composable_diffusion_models_tpu_torch.models.vae import BetaVAE, vae_loss
from composable_diffusion_models_tpu_torch.ops import kernels
from composable_diffusion_models_tpu_torch.rng import Replay

torch.set_num_threads(1)
TOL = 1e-5


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, ref, tol=TOL):
    """max |got - ref| <= tol * max(1, |ref|max)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


# ----------------------------------------------------------------- model
@pytest.fixture(scope="module", params=[(28, 1, 10), (16, 3, 4)],
                ids=["28x28x1", "16x16x3"])
def vae_case(request):
    """A configuration, its random tree (nothing zero) and a batch in
    [0, 1]."""
    size, ch, latent = request.param
    cfg = BetaVAE(img_size=size, in_channels=ch, latent_dim=latent)
    jm = JaxVAE(img_size=size, in_channels=ch, latent_dim=latent)
    tree = convert.init_params(cfg, seed=size)
    x = np.random.default_rng(size).uniform(0, 1, (5, size, size, ch)).astype(
        np.float32)
    return cfg, jm, tree, x


def test_param_shapes_match_flax(vae_case):
    cfg, jm, tree, x = vae_case
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x[:1]), k),
                            jax.random.PRNGKey(0))
    ref = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf in
           jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert ref == {("params",) + p: s for p, (s, _) in
                   convert.param_shapes(cfg).items()}


def test_encode_decode_apply_match_flax(vae_case):
    """mu, logvar, the decoded images and the whole apply (the noise
    replayed) to 1e-5."""
    cfg, jm, tree, x = vae_case
    params = convert.from_flax(tree)
    ref_mu, ref_lv = jm.apply(_j(tree), jnp.asarray(x),
                              method=JaxVAE.encode)
    mu, lv = cfg.encode(params, torch.from_numpy(x))
    _close(mu.numpy(), ref_mu)
    _close(lv.numpy(), ref_lv)
    z = np.random.default_rng(1).standard_normal(
        (4, cfg.latent_dim)).astype(np.float32)
    _close(cfg.decode(params, torch.from_numpy(z)).numpy(),
           jm.apply(_j(tree), jnp.asarray(z), method=JaxVAE.decode))
    key = jax.random.PRNGKey(3)
    ref = jm.apply(_j(tree), jnp.asarray(x), key)
    noise = jax.random.normal(key, ref[1].shape)
    got = cfg.apply(params, torch.from_numpy(x),
                    noise=torch.from_numpy(np.array(noise)))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    assert got[0].shape == x.shape and float(got[0].min()) > 0


def test_reparameterize_draws(vae_case):
    cfg, _, tree, x = vae_case
    mu, lv = torch.zeros(3, 2), torch.full((3, 2), math.log(4.0))
    noise = torch.randn(3, 2)
    assert torch.equal(cfg.reparameterize(mu, lv, noise=noise), 2.0 * noise)
    draws = [cfg.reparameterize(mu, lv, torch.Generator().manual_seed(5))
             for _ in range(2)]
    assert torch.equal(*draws)


@pytest.mark.parametrize("n,stride", [(15, 2), (14, 2), (7, 2), (9, 1),
                                      (4, 3)])
def test_same_padding_matches_flax(n, stride):
    """flax ``nn.Conv(padding="SAME")`` on odd and even inputs: (0, 1) at
    stride 2 on an even edge, where ``padding=1`` would pad (1, 1)."""
    conv = nn.Conv(4, (3, 3), strides=(stride, stride), padding="SAME")
    x = np.random.default_rng(n).standard_normal((2, n, n, 3)).astype(
        np.float32)
    p = conv.init(jax.random.PRNGKey(n), jnp.asarray(x))
    ref = conv.apply(p, jnp.asarray(x))
    pt = convert.from_flax(jax.tree_util.tree_map(np.asarray, p))["params"]
    got = vae_mod._conv(torch.from_numpy(x).permute(0, 3, 1, 2), pt,
                        stride).permute(0, 2, 3, 1)
    _close(got.numpy(), ref)
    if stride == 2 and n % 2 == 0:
        assert vae_mod._same_pads(n, 3, 2) == (0, 1)


@pytest.mark.parametrize("hw", [7, 14, 5])
def test_nearest_resize_is_a_repeat(hw):
    """``jax.image.resize(..., "nearest")`` at exactly 2x reads row i // 2,
    as the decoder's ``repeat_interleave`` does."""
    h = np.random.default_rng(hw).standard_normal((2, hw, hw, 3)).astype(
        np.float32)
    ref = jax.image.resize(jnp.asarray(h), (2, 2 * hw, 2 * hw, 3), "nearest")
    got = torch.from_numpy(h).repeat_interleave(2, 1).repeat_interleave(2, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_vae_loss_matches_jax():
    """BCE (with the clip to [1e-6, 1 - 1e-6], hit here by exact 0s and
    1s) plus beta KL, summed per example and meaned."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (6, 7, 7, 2)).astype(np.float32)
    recon = rng.uniform(0, 1, x.shape).astype(np.float32)
    recon[0, 0, 0] = (0.0, 1.0)
    mu, lv = (rng.standard_normal((6, 5)).astype(np.float32)
              for _ in range(2))
    for beta in (1.0, 4.0):
        got = vae_loss(*(torch.from_numpy(a) for a in (recon, x, mu, lv)),
                       beta)
        ref = jvae_loss(*(jnp.asarray(a) for a in (recon, x, mu, lv)), beta)
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


def test_flax_init_for_vae_and_latent_mlp():
    """Key paths and shapes of the flax init, zero biases, lecun-normal
    kernels (std within 5% of 1/sqrt(fan_in) on the larger leaves),
    N(0, 1/width) embeddings; drawn on the draws' device, reproducibly."""
    for cfg in (BetaVAE(), entry.vae_latent_mlp(10)):
        tree = convert.flax_init(cfg, 7)
        again = convert.flax_init(cfg, 7)
        shapes = convert.param_shapes(cfg)
        flat = dict(zip(*train.flatten(tree["params"])))
        assert {p: tuple(v.shape) for p, v in flat.items()} == {
            p: s for p, (s, _) in shapes.items()}
        for p, v in flat.items():
            assert torch.equal(v, dict(zip(*train.flatten(
                again["params"])))[p])
            if p[-1] == "bias":
                assert not v.any()
            elif v.numel() >= 2000:
                want = (1.0 / math.sqrt(shapes[p][0][-1])
                        if p[-1] == "embedding"
                        else 1.0 / math.sqrt(shapes[p][1]))
                assert abs(float(v.std()) / want - 1.0) < 0.05, p


# ------------------------------------------------------------ train_vae
def _synthetic_draws(key, n):
    """The JAX procedural digits' draws, all ten classes."""
    bucket = 256
    while bucket < n:
        bucket *= 2
    kl, kr = jax.random.split(key)
    pick = jax.random.randint(kl, (bucket,), 0, 10)

    def one(k):
        ks, kx, ky = jax.random.split(k, 3)
        return (jax.random.uniform(ks, (), minval=2.2, maxval=3.2),
                jax.random.uniform(kx, (), minval=-2.5, maxval=2.5),
                jax.random.uniform(ky, (), minval=-2.5, maxval=2.5))
    scale, tx, ty = jax.vmap(one)(jax.random.split(kr, bucket))
    return [np.asarray(a) for a in (pick, scale, tx, ty)]


STEPS, N_DATA, LATENT = 30, 256, 10  # the script's --sanity sizes


def _jax_data():
    """The script's dataset: (images in [0, 1], labels, the draws)."""
    key = jax.random.PRNGKey(42)
    images, labels = jdata.get_dataset("mnist", key, N_DATA, classes=None,
                                       data_dir=None)
    return (images + 1.0) / 2.0, labels, _synthetic_draws(key, N_DATA)


def _jax_vae_phase(vinit, images01):
    """The script's VAE training (Adam 1e-3, 128 images a step drawn with
    ``fold_in(key, i)``), ``vinit`` in place of its init, the loss of
    every step recorded. Returns (tree, losses, the draws)."""
    key = jax.random.PRNGKey(42)
    vae = JaxVAE(img_size=28, in_channels=1, latent_dim=LATENT)
    tx = optax.adam(1e-3)
    params, opt_state = _j(vinit), tx.init(_j(vinit))

    @jax.jit
    def vae_step(params, opt_state, k):
        kb, kr = jax.random.split(k)
        idx = jax.random.randint(kb, (128,), 0, N_DATA)
        batch = jnp.take(images01, idx, axis=0)

        def loss_fn(p):
            recon, mu, lv = vae.apply(p, batch, kr)
            return jvae_loss(recon, batch, mu, lv, 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state2, loss

    losses, draws = [], []
    for i in range(STEPS):
        k = jax.random.fold_in(key, i)
        params, opt_state, loss = vae_step(params, opt_state, k)
        losses.append(float(loss))
        kb, kr = jax.random.split(k)
        draws += [np.asarray(jax.random.randint(kb, (128,), 0, N_DATA)),
                  np.asarray(jax.random.normal(kr, (128, LATENT)))]
    return params, np.array(losses), draws


def _diff_draws():
    """The draws of the script's latent-expert training (key fold_in(key,
    1), one chunk): per step the batch indices, t, the noise and the
    dropout uniforms."""
    ck = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(42), 1), 0)
    draws = []
    for i in range(STEPS):
        kb, kl = jax.random.split(jax.random.fold_in(ck, i))
        kt, ke, kd = jax.random.split(kl, 3)
        draws += [np.asarray(jax.random.randint(kb, (256,), 0, N_DATA)),
                  np.asarray(jax.random.randint(kt, (256,), 0, 300)),
                  np.asarray(jax.random.normal(ke, (256, LATENT))),
                  np.asarray(jax.random.uniform(kd, (256,)))]
    return draws


def _jax_diff_phase(minit, mu, labels):
    """The script's latent-expert training on the cached encodings
    ``mu``, ``minit`` in place of its init."""
    mlp = JaxLatentMLP(latent_dim=LATENT, hidden=256, depth=3,
                       num_classes=(10,), null_token=True)
    return jtrain.train_expert(
        jax.random.fold_in(jax.random.PRNGKey(42), 1), mlp.apply,
        _j(minit), JaxDDPM(num_timesteps=300), jnp.asarray(mu),
        labels=(labels,), steps=STEPS, batch_size=256, lr=1e-3,
        uncond_prob=0.1, null_labels=(10,), time_first=True,
        steps_per_scan=min(100, STEPS))


def _ulp_up(tree):
    """Every leaf times 1 + 2^-23: one rounding away."""
    return jax.tree_util.tree_map(
        lambda a: (a * np.float32(1 + 2 ** -23)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def vae_run(tmp_path_factory):
    """``train_vae(sanity=True)`` from the flax inits with every JAX draw
    replayed, again from a VAE init one rounding away (the computation's
    own sensitivity), and the script's two phases: its VAE training, and
    its latent-expert training on the port's cached encodings."""
    out = str(tmp_path_factory.mktemp("vae"))
    key = jax.random.PRNGKey(42)
    vinit = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: JaxVAE(latent_dim=LATENT).init(
            k, jnp.zeros((1, 28, 28, 1)), k))(key))
    minit = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: JaxLatentMLP(latent_dim=LATENT, hidden=256, depth=3,
                               num_classes=(10,), null_token=True).init(
            k, jnp.ones((1,)), jnp.zeros((1, LATENT)),
            jnp.zeros((1,), jnp.int32)))(key))
    images01, labels, data_draws = _jax_data()
    ref_vae, ref_losses, vae_draws = _jax_vae_phase(vinit, images01)
    draws = data_draws + vae_draws + _diff_draws()
    runs = []
    for v, where in ((vinit, out), (_ulp_up(vinit), out + "_ulp")):
        replay = Replay(draws)
        runs.append(entry.train_vae(
            sanity=True, out=where, device="cpu", key=replay,
            init={"vae": convert.from_flax(v),
                  "mlp": convert.from_flax(minit)}))
        assert not replay.queue
    with torch.no_grad():
        mu, _ = BetaVAE().encode(runs[0]["vae"],
                                 torch.from_numpy(np.array(images01)))
    ref_mlp, ref_diff = _jax_diff_phase(minit, mu.numpy(), labels)
    return dict(out=out, got=runs[0], ulp=runs[1], ref_vae=ref_vae,
                ref_losses=ref_losses, ref_mlp=ref_mlp, ref_diff=ref_diff,
                minit=minit)


def test_train_vae_matches_the_script(vae_run):
    """The VAE phase: the first loss (before any update) to 1e-6
    relative. After it the run is chaotic at float32's resolution: from a
    VAE init one rounding away the port's losses (sums over 784 pixels,
    ~200-550) move by up to 8e-5 of themselves by step 30, JAX's by 9e-5.
    So each later loss is held to 10x the port's own such distance so far
    (at least 1e-5 of it), and each leaf of the VAE to 10x its own (at
    least 1e-5 of its scale); measured against the script, 2.2e-4 at
    most, 2.7x the port's own. The latent expert, trained by the script
    on the port's encodings: its 30 losses to 1e-5, and each leaf within
    1e-5 of its scale or 1e-2 of the distance it moved, whichever is
    larger (Adam's steps, as in
    ``test_torch_config_cli.test_train_image_matches_the_script``)."""
    r = vae_run
    got, ulp = r["got"], r["ulp"]
    g, u, ref = (got["vae_losses"].numpy(), ulp["vae_losses"].numpy(),
                 r["ref_losses"])
    assert abs(g[0] - ref[0]) <= 1e-6 * ref[0]
    sens = np.maximum.accumulate(np.abs(g - u) / g)
    assert (np.abs(g - ref) / ref <= np.maximum(10 * sens, 1e-5)).all()
    ref_vae = train.flatten(convert.from_flax(jax.tree_util.tree_map(
        np.asarray, r["ref_vae"])))[1]
    for p, a, b, c in zip(*train.flatten(got["vae"]), ref_vae,
                          train.flatten(ulp["vae"])[1]):
        err = float((a - b).abs().max())
        bar = max(1e-5 * float(b.abs().max()),
                  10 * float((a - c).abs().max()))
        assert err <= bar, (p, err, bar)
    np.testing.assert_allclose(got["diff_losses"].numpy(),
                               np.asarray(r["ref_diff"]), rtol=0, atol=1e-5)
    ref_mlp, init = (train.flatten(convert.from_flax(jax.tree_util.tree_map(
        np.asarray, t)))[1] for t in (r["ref_mlp"], r["minit"]))
    for p, a, b, i0 in zip(*train.flatten(got["mlp"]), ref_mlp, init):
        err = float((a - b).abs().max())
        bar = max(1e-5 * float(b.abs().max()),
                  1e-2 * float((b - i0).abs().max()))
        assert err <= bar, (p, err, bar)


def test_train_vae_checkpoint_feeds_compose(vae_run):
    """The checkpoint holds {"vae", "mlp", "latent_dim"} bit for bit, and
    ``compose_latent_vae`` reads it by name (both modes, their grids)."""
    got = vae_run["got"]
    mgr = CheckpointManager(vae_run["out"], "mnist_image_vae")
    state = mgr.load("vae")
    assert state["latent_dim"] == 10
    for k in ("vae", "mlp"):
        for a, b in zip(train.flatten(state[k])[1], train.flatten(got[k])[1]):
            assert torch.equal(a, b)
    for mode in entry.VAE_MODES:
        imgs = entry.compose_latent_vae(mode=mode, out=vae_run["out"],
                                        device="cpu")
        assert imgs.shape == (16, 28, 28, 1) and bool(
            torch.isfinite(imgs).all())
        assert Path(mgr.results_dir, f"vae_composed_{mode}.png").exists()
    with pytest.raises(ValueError, match="mode"):
        entry.compose_latent_vae(mode="avg", out=vae_run["out"],
                                 device="cpu")


# --------------------------------------------------- compose_latent_vae
BS = 6


@pytest.fixture(scope="module")
def latent_ckpt(tmp_path_factory):
    """A random VAE and latent expert (nothing zero) saved as train_vae
    saves them; the script's draws (one key for the initial latents and
    the sampler)."""
    out = str(tmp_path_factory.mktemp("latent"))
    vtree = convert.init_params(BetaVAE(), seed=3)
    mtree = convert.init_params(entry.vae_latent_mlp(10), seed=4)
    CheckpointManager(out, "mnist_image_vae").save(
        "vae", {"vae": convert.from_flax(vtree),
                "mlp": convert.from_flax(mtree), "latent_dim": 10})
    key = jax.random.PRNGKey(42)
    z0 = jax.random.normal(key, (BS, 10))

    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.normal(sub, (BS, 10))
    noise = np.array(jax.lax.scan(body, key, None, length=300)[1])
    return out, vtree, mtree, np.array(z0), noise


def _jax_compose(vtree, mtree, mode, digits=(3, 5), guidance=2.0):
    """scripts/compose_latent_vae.py's computation."""
    key = jax.random.PRNGKey(42)
    vae = JaxVAE(img_size=28, in_channels=1, latent_dim=10)
    mlp = JaxLatentMLP(latent_dim=10, hidden=256, depth=3, num_classes=(10,),
                       null_token=True)
    mparams = _j(mtree)
    sde = JaxDDPM(num_timesteps=300)
    if mode == "cfg":
        eps_fn = jsamplers.make_cfg_eps_fn(
            lambda z, t, lab: mlp.apply(mparams, t, z, lab),
            [(jnp.asarray(d),) for d in digits], (jnp.asarray(10),),
            jnp.full((len(digits),), guidance))

        def fn(z, ti):
            return eps_fn(z, ti.astype(jnp.float32))
    else:
        labels = [jnp.full((BS,), d, jnp.int32) for d in digits]

        def fn(z, ti):
            stack = jnp.stack([mlp.apply(mparams, ti.astype(jnp.float32), z,
                                         lab) for lab in labels])
            return jcompose.weighted(stack, jnp.ones((len(digits),)))
    z = jsamplers.ddpm_ancestral(fn, sde, key,
                                 jax.random.normal(key, (BS, 10)), clip=None)
    return np.asarray(vae.apply(_j(vtree), z, method=JaxVAE.decode))


@pytest.mark.parametrize("mode,fused_blend", [("cfg", True),
                                              ("weighted", True),
                                              ("weighted", False)])
def test_compose_latent_vae_matches_the_script(latent_ckpt, mode,
                                               fused_blend, monkeypatch):
    """300 ancestral steps without the clip, then the decoder: the images
    to 1e-4 (the latent MLP's float32 sinusoids of t up to 299 part by
    ~1e-5 between XLA and torch). ``weighted`` blends through
    ``blend_eps``'s wrapper once a step (its plain version on the CPU);
    ``cfg`` and ``fused_blend=False`` never reach it."""
    out, vtree, mtree, z0, noise = latent_ckpt
    ref = _jax_compose(vtree, mtree, mode)
    calls = []
    monkeypatch.setattr(entry, "blend_eps", lambda s, w: calls.append(
        tuple(s.shape)) or kernels.blend_eps(s, w))
    got = entry.compose_latent_vae(mode=mode, bs=BS, out=out,
                                   fused_blend=fused_blend, z_init=z0,
                                   noise=torch.from_numpy(noise),
                                   device="cpu")
    _close(got.numpy(), ref, 1e-4)
    want = 300 if mode == "weighted" and fused_blend else 0
    assert len(calls) == want and set(calls) <= {(2, BS, 10)}


def test_compose_latent_vae_own_draws(latent_ckpt):
    """Without replayed draws the seed decides: the same seed gives the
    same images, another seed others."""
    out = latent_ckpt[0]
    a, b, c = (entry.compose_latent_vae(mode="weighted", bs=BS, out=out,
                                        seed=s, device="cpu")
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
