"""Port parity for the latent and 2-D scripts' entry points, each against
its script's computation with the JAX package on the same inputs and the
JAX draws replayed: ``entry.fit_pca`` (``scripts/fit_pca.py``: the three
``.npy`` files), ``entry.train_latent_2d`` (``scripts/train_latent_2d.py``:
the trained tree, its losses and checkpoint), ``entry.superposition_2d``
(``scripts/superposition_2d.py``: both experts' training and the composed
points with their log-likelihoods) and ``entry.compose_images_ito``
(``scripts/compose_images_ito.py``: the 3 x 3 grid, no kernel wrapper
reached). Sizes are cut (a few hundred images, tens of steps, narrow
UNets); float32 throughout."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu import train as jtrain
from composable_diffusion_models_tpu.models import ScoreMLP as JaxScoreMLP
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.ops import divergence as jdiv
from composable_diffusion_models_tpu.ops import pca as jpca
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu.utils import config as jconfig
from composable_diffusion_models_tpu_torch import (convert, entry, samplers,
                                                   train)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.models import unet as tunet
from composable_diffusion_models_tpu_torch.ops import kernels
from composable_diffusion_models_tpu_torch.rng import Replay

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _common():
    """``scripts/_common.py`` (its builders), imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "_common", ROOT / "scripts" / "_common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


C = _common()


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


def _synthetic_draws(key, n, n_classes):
    """The JAX procedural digits' draws (a bucket of 256 or more)."""
    bucket = 256
    while bucket < n:
        bucket *= 2
    kl, kr = jax.random.split(key)
    pick = jax.random.randint(kl, (bucket,), 0, n_classes)

    def one(k):
        ks, kx, ky = jax.random.split(k, 3)
        return (jax.random.uniform(ks, (), minval=2.2, maxval=3.2),
                jax.random.uniform(kx, (), minval=-2.5, maxval=2.5),
                jax.random.uniform(ky, (), minval=-2.5, maxval=2.5))
    scale, tx, ty = jax.vmap(one)(jax.random.split(kr, bucket))
    return [_np(a) for a in (pick, scale, tx, ty)]


def _step_draws(key, steps, n, bs, shape, per_chunk):
    """The JAX training loop's draws in the port's order: chunk c's key
    fold_in(key, c); step i's batch indices, then its loss's t and noise
    (no labels)."""
    out = []
    for i in range(steps):
        ck = jax.random.fold_in(key, i // per_chunk)
        kb, kl = jax.random.split(jax.random.fold_in(ck, i % per_chunk))
        out.append(_np(jax.random.randint(kb, (bs,), 0, n)))
        kt, ke, _ = jax.random.split(kl, 3)
        out.append(_np(jax.random.uniform(kt, (bs,), minval=1e-3,
                                          maxval=1.0)))
        out.append(_np(jax.random.normal(ke, (bs,) + shape)))
    return out


def _leaves_close(got, ref, init):
    """Each leaf within 1e-5 of its scale or 1e-2 of the distance it moved
    from its init (Adam at epsilon 1e-8 moves a small-gradient leaf by a
    learning rate a step whatever its gradient's float32 rounding)."""
    paths, leaves = train.flatten(got)
    assert paths == train.flatten(ref)[0]
    for p, g, r, i0 in zip(paths, leaves, train.flatten(ref)[1],
                           train.flatten(init)[1]):
        err = float((g - r).abs().max())
        bar = max(1e-5 * float(r.abs().max()),
                  1e-2 * float((r - i0).abs().max()))
        assert err <= bar, (p, err, bar)


# ---------------------------------------------------------------- fit_pca
@pytest.mark.parametrize("preset,ov,k", [
    ("mnist_latent2d", ["--data.n=256"], 2),
    ("shapes_latent", ["--data.n=200", "--data.img_size=16"], 2)])
def test_fit_pca_files_match_the_script(tmp_path, capsys, preset, ov, k):
    """The three files against ``jpca.save_pca``'s of the script's fit on
    the same data (the procedural digits' draws replayed): the mean to
    1e-6, the explained variance to 1e-4 relative, each component to 1e-4
    up to its sign (the float32 solver's and the port's float64 one's
    eigenvectors of one float32 covariance). The shapes_latent preset
    holds three distinct images: its covariance has rank 2, on which the
    float32 solver of the port's library does not converge (a third
    component would be any axis of the null space)."""
    jcfg = jconfig.get_config(preset, ov)
    key = jax.random.PRNGKey(jcfg.train.seed)
    images, _ = C.build_dataset(jcfg, key)
    ref = jpca.fit_pca(images, k)
    jpca.save_pca(str(tmp_path / "ref"), ref)
    draws = (_synthetic_draws(key, jcfg.data.n, 10)
             if preset == "mnist_latent2d" else [])
    got = entry.fit_pca(preset, components=k, out=str(tmp_path / "port"),
                        name="codec", overrides=ov, key=Replay(draws),
                        device="cpu")
    assert f"PCA({k}) fit on {jcfg.data.n} examples" in capsys.readouterr().out
    load = {p: {n: np.load(tmp_path / p / f"{q}_{n}.npy") for n in
                ("mean", "components", "explained_variance")}
            for p, q in (("port", "codec"), (".", "ref"))}
    a, r = load["port"], load["."]
    np.testing.assert_allclose(a["mean"], r["mean"], atol=1e-6)
    np.testing.assert_allclose(a["explained_variance"],
                               r["explained_variance"], rtol=1e-4)
    signs = np.sign((a["components"] * r["components"]).sum(1))[:, None]
    np.testing.assert_allclose(a["components"] * signs, r["components"],
                               atol=1e-4)
    assert all(v.dtype == np.float32 for v in a.values())
    np.testing.assert_array_equal(got.components.numpy(), a["components"])


# ---------------------------------------------------------- train_latent_2d
LAT_OV = ["--data.n=256", "--train.steps=30", "--train.batch_size=64"]


def test_train_latent_2d_matches_the_script(tmp_path):
    """``mnist_latent2d`` on digits {1, 4, 7}, 30 steps of batch 64, the
    JAX codec's files: the losses to 1e-5, the trained tree per leaf as
    ``_leaves_close``; the checkpoint and the losses' file hold them."""
    jcfg = jconfig.get_config("mnist_latent2d", LAT_OV)
    jcfg.data.classes = (1, 4, 7)
    key = jax.random.PRNGKey(jcfg.train.seed)
    images, _ = C.build_dataset(jcfg, key)
    jpca.save_pca(str(tmp_path / "pca"), jpca.fit_pca(images, 2))
    z = jpca.load_pca(str(tmp_path / "pca")).encode(images)
    model = C.build_model(jcfg)
    init = model.init(key, jnp.ones((1, 1)), jnp.zeros((1, 2)))
    t = jcfg.train
    ref, ref_losses = jtrain.train_expert(
        jax.random.fold_in(key, 1), model.apply, init, JaxVP(), z,
        steps=t.steps, batch_size=t.batch_size, lr=t.lr, time_first=True,
        steps_per_scan=min(200, t.steps))
    replay = Replay(_synthetic_draws(key, jcfg.data.n, 3) + _step_draws(
        jax.random.fold_in(key, 1), t.steps, jcfg.data.n, t.batch_size,
        (2,), 200))
    init_t = convert.from_flax(jax.tree_util.tree_map(np.asarray, init))
    params, losses, path = entry.train_latent_2d(
        "mnist_latent2d", classes=(1, 4, 7), name="lat", out=str(tmp_path),
        overrides=LAT_OV, key=replay, init=init_t, device="cpu")
    assert not replay.queue
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=0, atol=1e-5)
    _leaves_close(params, convert.from_flax(
        jax.tree_util.tree_map(np.asarray, ref)), init_t)
    mgr = CheckpointManager(str(tmp_path), "mnist_latent2d")
    saved = mgr.load("lat")
    assert path == mgr._path("lat", None) and saved["step"] == 30
    for a, b in zip(train.flatten(saved["params"])[1],
                    train.flatten(params)[1]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        np.load(Path(mgr.results_dir) / "lat_loss.npy"), losses.numpy())


# ---------------------------------------------------------- superposition
SP = dict(steps=30, hidden=64, bs=64, n_sample_steps=20)


def _superposition_probes(key, n_steps, shape):
    """``superposition_2d``: k, kp = split(k); ONE probe for both experts."""
    out = []
    for _ in range(n_steps):
        key, kp = jax.random.split(key)
        out.append(_np(jdiv._probe(kp, shape, jnp.float32, "rademacher")))
    return np.stack(out)


def test_superposition_2d_matches_the_script(tmp_path, capsys):
    """The script's computation at 30 training steps of batch 64 and
    width 64 (depth 4), 20 sampling steps over its 512 points, the draws
    replayed: each expert's losses to 1e-5 and tree per leaf as
    ``_leaves_close``; the composed points and both log-likelihoods to
    1e-4 of their scale (measured ~1e-6: the trees differ by Adam's
    float32 steps)."""
    key = jax.random.PRNGKey(0)
    sch = JaxVP(kind="jax_faithful")
    m = JaxScoreMLP(hidden=64, depth=4, out_dim=2)
    refs, inits, draws = [], [], []
    for i, up in ((1, True), (2, False)):
        k = jax.random.fold_in(key, i)
        pts = jdata.toy2d(k, 65536, up=up)
        p0 = m.init(k, jnp.ones((4, 1)), jnp.zeros((4, 2)))
        refs.append(jtrain.train_expert(
            k, lambda pp, t, x: -m.apply(pp, t, x), p0, sch, pts,
            steps=30, batch_size=64, lr=2e-4, time_first=True,
            steps_per_scan=30))
        inits.append(convert.from_flax(jax.tree_util.tree_map(np.asarray,
                                                              p0)))
        k1, k2 = jax.random.split(k)
        lo, hi = ((0, 1), (2, 2)) if up else ((0, 0), (2, 1))
        draws += [_np(jax.random.randint(k1, (65536, 2), jnp.array(lo),
                                         jnp.array(hi))),
                  _np(jax.random.normal(k2, (65536, 2)))]
        draws += _step_draws(k, 30, 65536, 64, (2,), 30)

    def score_fn(p):
        return lambda x, t: m.apply(p, jnp.full((x.shape[0],), t), x)

    x_init = jax.random.normal(key, (512, 2))
    x_ref, ll_ref = jsamplers.superposition_2d(
        tuple(score_fn(p) for p, _ in refs), sch, key, x_init, 20)
    replay = Replay(draws + [_np(x_init)])
    got = entry.superposition_2d(
        **SP, out=str(tmp_path), key=replay, init=inits,
        probes=torch.from_numpy(_superposition_probes(key, 20, (512, 2))),
        device="cpu")
    assert not replay.queue
    for (ref, ref_losses), p, loss, i0 in zip(refs, got["experts"],
                                              got["losses"], inits):
        np.testing.assert_allclose(loss.numpy(), np.asarray(ref_losses),
                                   rtol=0, atol=1e-5)
        _leaves_close(p, convert.from_flax(jax.tree_util.tree_map(
            np.asarray, ref)), i0)
    _close(got["samples"], x_ref, 1e-4)
    _close(got["ll"], ll_ref, 1e-4)
    np.testing.assert_array_equal(np.load(tmp_path / "composed_and.npy"),
                                  got["samples"].numpy())
    mean = float(np.abs(np.asarray(ll_ref[0] - ll_ref[1])).mean())
    assert f"|ll1 - ll2| mean = {mean:.3f}" in capsys.readouterr().out


def test_superposition_2d_sanity_cuts(tmp_path, monkeypatch):
    """``sanity=True``: the script's 500 training and 100 sampling
    steps."""
    seen = {}
    orig_train, orig_sp = train.train_expert, samplers.superposition_2d

    def train_expert(*a, **k):
        seen.setdefault("steps", k["steps"])
        return orig_train(*a, **dict(k, steps=1, steps_per_scan=1))

    def superposition(fns, sch, gen, x, n, **k):
        seen["n"] = n
        return orig_sp(fns, sch, gen, x, 1, **k)
    monkeypatch.setattr(train, "train_expert", train_expert)
    monkeypatch.setattr(samplers, "superposition_2d", superposition)
    entry.superposition_2d(hidden=8, bs=4, sanity=True, out=str(tmp_path),
                           device="cpu")
    assert seen == {"steps": 500, "n": 100}


# -------------------------------------------------------- compose_images_ito
ITO_OV = ["--model.base_dim=8", "--model.channel_mults=(1,2)",
          "--data.img_size=16"]
ITO_STEPS = 4


def _ito_probes(key, n_steps, shape, kind):
    out = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        out.append(np.stack([_np(jdiv._probe(k, shape, jnp.float32, kind))
                             for k in (k1, k2)]))
    return np.stack(out)


@pytest.mark.parametrize("protocol", ["white", "luma_norm"])
def test_compose_images_ito_matches_the_script(tmp_path, monkeypatch,
                                               protocol):
    """The script's 9 combinations (bs 2, 4 steps, gaussian probes) on
    narrow experts read back by name, with every kernel wrapper replaced
    by one that raises (the jvps run in PyTorch ops): 1e-4 of the scale
    (measured ~1e-6); the grid's PNG written."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was reached")
    for name in ("groupnorm_silu", "groupnorm_silu_split",
                 "flash_attention"):
        monkeypatch.setattr(tunet, name, boom)
    monkeypatch.setattr(kernels, "blend_eps", boom)
    models = [tunet.UNet(in_channels=ch, base_dim=8, channel_mults=(1, 2),
                         num_classes=(3,)) for ch in (1, 3)]
    trees = [convert.init_params(m, seed=5 + i) for i, m in
             enumerate(models)]
    mgr = CheckpointManager(str(tmp_path), "shapes_ddim")
    for name, tree in zip(("shape_expert", "color_expert"), trees):
        mgr.save(name, {"params": convert.unet_torch_layout(
            convert.from_flax(tree)), "step": 0})
    jm = [JaxUNet(in_channels=ch, base_dim=8, channel_mults=(1, 2),
                  num_classes=(3,)) for ch in (1, 3)]
    jsp, jcp = (jax.tree_util.tree_map(jnp.asarray, t) for t in trees)
    key, normalized, bs = jax.random.PRNGKey(42), protocol == "luma_norm", 2
    @jax.jit
    def sample_combo(sl, cl, k_init, k_probe):
        # the script's: labels traced, one compile for the 9 combinations
        def shape_score(x, t):
            return -jexperts.gray_to_rgb(jm[0].apply(
                jsp, jexperts.rgb_to_gray(x, normalized=normalized), t, sl),
                normalized=normalized)

        def color_score(x, t):
            return -jm[1].apply(jcp, x, t, cl)
        x0 = jax.random.normal(k_init, (bs, 16, 16, 3))
        return x0, jsamplers.ito_kappa_ode(
            (shape_score, color_score), JaxVP(), k_probe, x0, ITO_STEPS,
            probe="gaussian")

    refs, xs, probes = [], [], []
    for s in range(3):
        for c in range(3):
            k_probe = jax.random.fold_in(key, 100 + s * 3 + c)
            x0, ref = sample_combo(jnp.full((bs,), s, jnp.int32),
                                   jnp.full((bs,), c, jnp.int32),
                                   jax.random.fold_in(key, s * 3 + c),
                                   k_probe)
            refs.append(ref)
            xs.append(_np(x0))
            probes.append(_ito_probes(k_probe, ITO_STEPS, (bs, 16, 16, 3),
                                      "gaussian"))
    got = entry.compose_images_ito(
        n_steps=ITO_STEPS, bs=bs, gray_protocol=protocol, out=str(tmp_path),
        overrides=ITO_OV, x_init=np.stack(xs),
        probes=torch.from_numpy(np.stack(probes)), device="cpu")
    _close(got, np.concatenate([_np(r) for r in refs]), 1e-4)
    assert (Path(mgr.results_dir) / "ito_composition_grid.png").exists()
    with pytest.raises(ValueError, match="gray_protocol"):
        entry.compose_images_ito(gray_protocol="rgb", device="cpu")


def test_compose_images_ito_own_draws(tmp_path):
    """Without replayed draws: the script's keys through ``rng.Draws``,
    the same grid on a second call."""
    models = [tunet.UNet(in_channels=ch, base_dim=8, channel_mults=(1, 2),
                         num_classes=(3,)) for ch in (1, 3)]
    mgr = CheckpointManager(str(tmp_path), "shapes_ddim")
    for i, (name, m) in enumerate(zip(("shape_expert", "color_expert"),
                                      models)):
        mgr.save(name, {"params": convert.unet_torch_layout(
            convert.from_flax(convert.init_params(m, seed=i))), "step": 0})
    kw = dict(n_steps=2, out=str(tmp_path), overrides=ITO_OV, device="cpu")
    a, b = (entry.compose_images_ito(**kw) for _ in range(2))
    assert tuple(a.shape) == (9, 16, 16, 3) and torch.equal(a, b)


def test_new_entry_points_need_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, kw in ((entry.fit_pca, {}), (entry.train_latent_2d, {}),
                   (entry.superposition_2d, {}),
                   (entry.compose_images_ito, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(out=str(tmp_path), **kw)
    assert not any(tmp_path.iterdir())
    assert "jax" not in sys.modules.get(entry.__name__).__dict__
