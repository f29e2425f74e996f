"""The port's command lines run on the CPU (``--cpu``) at narrow widths:

* each against the entry point it drives, called directly on the same
  inputs: the same bits (``torch.equal`` of the outputs, trained trees and
  losses; the same PNG bytes), the files the script writes, exit code 0.
  The command line's call is recorded by wrapping the entry point;
* the six glue command lines (``superdiff``, ``layout_compose``,
  ``compose_bbox``, ``compose_images_ddim``, ``sample_latent``,
  ``latent_shape_experts``) against the JAX scripts' computation written
  out with the JAX package on the same trees (``convert.init_params``,
  saved by name through the port's ``CheckpointManager``), the JAX draws
  replayed into the entry points the command lines call (the initial noise,
  ``noise=``, ``probes=``). The JAX UNets run XLA's GroupNorm
  (``use_pallas=False``), the port the kernels' plain versions on CPU
  tensors. Tolerances, per element, of the reference's scale (at least
  1): the DDPM samplers 1e-4 (``test_torch_superdiff.py``'s bar for these
  paths), gray + color DDIM 1e-4 (``test_torch_samplers_ddim.py``'s), the
  latent samplers 1e-3 (``test_torch_latent_slice.py``'s).

No file under ``scripts/`` is run or changed; everything is written under
``tmp_path``.
"""

import dataclasses
import importlib
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import ScoreMLP as JaxScoreMLP
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.ops import divergence as jdiv
from composable_diffusion_models_tpu.ops import pca as jpca
from composable_diffusion_models_tpu.schedules import DDPMSchedule as JaxDDPM
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import (builders, convert, entry,
                                                   train)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.models import UNet
from composable_diffusion_models_tpu_torch.rng import Draws, fold_in
from composable_diffusion_models_tpu_torch.utils.config import get_config

torch.set_num_threads(1)
PKG = "composable_diffusion_models_tpu_torch.scripts"
NARROW = ["--model.base_dim=8", "--model.channel_mults=[1,2]",
          "--model.time_emb_dim=32", "--data.img_size=8"]


def cli(name):
    return importlib.import_module(f"{PKG}.{name}")


class Record:
    """Wraps ``entry.<attr>``: records each call's arguments and result;
    ``replace(i, args, kwargs)`` may swap inputs (replayed draws) first."""

    def __init__(self, monkeypatch, attr, replace=None, mod=entry):
        self.real, self.calls, self.replace = getattr(mod, attr), [], replace
        monkeypatch.setattr(mod, attr, self)

    def __call__(self, *args, **kwargs):
        if self.replace is not None:
            args, kwargs = self.replace(len(self.calls), list(args), kwargs)
        out = self.real(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


def _same(a, b):
    """Bit for bit: tensors, or nested dicts / tuples / lists of them."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _save(out, preset, name, model, seed, overrides=()):
    """A random narrow tree of ``model`` saved as the checkpoint ``name``
    of ``preset``; returns the flax tree (numpy)."""
    tree = convert.init_params(model, seed)
    exp = get_config(preset, list(overrides)).name
    CheckpointManager(str(out), exp).save(
        name, {"params": convert.from_flax(tree), "step": 0})
    return tree


def _results(out, exp):
    return Path(out) / exp / "run_0" / "results"


# --------------------------------------------- against the entry points
@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """expert_a and expert_b of mnist_image trained by the command line
    (--sanity, narrow), and the recorded entry-point results."""
    out = str(tmp_path_factory.mktemp("mnist"))
    mp = pytest.MonkeyPatch()
    rec = Record(mp, "train_image")
    try:
        for name, classes in (("expert_a", "[0,1,2]"), ("expert_b", "[5,6]")):
            assert cli("train_image").main(
                ["--cpu", "--name", name, "--classes", classes, "--sanity",
                 "--out", out] + NARROW) == 0
    finally:
        mp.undo()
    return out, rec.calls


def test_train_image_is_the_entry_point(mnist, tmp_path):
    out, calls = mnist
    got = calls[0][2]
    ref = entry.train_image("mnist_image", "expert_a", classes=[0, 1, 2],
                            sanity=True, out=str(tmp_path),
                            overrides=NARROW, device="cpu")
    _same(got[:2], ref[:2])
    files = {p.relative_to(Path(out) / "mnist_image" / "run_0").as_posix()
             for p in (Path(out) / "mnist_image").rglob("*") if p.is_file()}
    assert {"checkpoints/expert_a_final", "logs/expert_a_config.yaml",
            "results/expert_a_loss.npy", "results/expert_a_loss.png",
            "results/expert_a_onestep.png"} <= files


@pytest.mark.parametrize("name,argv,call", [
    ("sample_image", ["--name", "expert_a", "--sampler", "ddim", "--eta",
                      "0.5", "--seed", "7", "--sample.n_steps=3",
                      "--sample.batch_size=2"],
     lambda out: entry.sample_image(
         "mnist_image", "expert_a", sampler="ddim", eta=0.5, seed=7, out=out,
         overrides=NARROW + ["--sample.n_steps=3", "--sample.batch_size=2"],
         device="cpu")),
    ("sample_image", ["--name", "expert_b", "--sampler", "em",
                      "--sample.n_steps=3", "--sample.batch_size=2"],
     lambda out: entry.sample_image(
         "mnist_image", "expert_b", sampler="em", out=out,
         overrides=NARROW + ["--sample.n_steps=3", "--sample.batch_size=2"],
         device="cpu")),
    ("compose_scores", ["--weights", "[2.0,0.5]", "--sample.n_steps=3",
                        "--sample.batch_size=2"],
     lambda out: entry.compose_scores(
         "mnist_image", ["expert_a", "expert_b"], weights=[2.0, 0.5],
         out=out,
         overrides=NARROW + ["--sample.n_steps=3", "--sample.batch_size=2"],
         device="cpu")),
])
def test_mnist_command_lines_are_their_entry_points(mnist, name, argv, call,
                                                    monkeypatch, capsys):
    out, _ = mnist
    rec = Record(monkeypatch, name)
    assert cli(name).main(["--cpu", "--out", out] + argv + NARROW) == 0
    png = capsys.readouterr().out.split("saved to ")[-1].strip()
    written = Path(png).read_bytes()
    monkeypatch.undo()
    _same(rec.calls[0][2], call(out))  # rewrites the same PNG
    assert Path(png).read_bytes() == written


def test_eval_nll_is_the_entry_point(mnist):
    out, _ = mnist
    assert cli("eval_nll").main(
        ["--cpu", "--out", out, "--name", "expert_a", "--n_data", "3",
         "--n_steps", "2", "--n_probes", "1"] + NARROW) == 0
    path = _results(out, "mnist_image") / "nll_expert_a.json"
    import json
    report = json.loads(path.read_text())
    cfg = get_config("mnist_image", NARROW)
    ref = entry.eval_nll(
        entry.load_named("mnist_image", ["expert_a"], out, NARROW, "cpu")[0],
        model=builders.build_model(cfg), dataset="mnist",
        dataset_kw=builders.dataset_kwargs(cfg), n_data=3, n_steps=2,
        n_probes=1, device="cpu")
    assert list(report) == ["expert", "preset", "n_data", "n_steps",
                            "n_probes", "probe", "exact", "t_max",
                            "schedule_kind", "nll_nats_mean",
                            "bits_per_dim_mean", "bits_per_dim_sem"]
    assert report["expert"] == "expert_a" and report["n_data"] == 3
    for k in ("nll_nats_mean", "bits_per_dim_mean", "bits_per_dim_sem"):
        assert report[k] == ref[k]


GUIDED = builders.build_model(get_config("colored_mnist_guided", NARROW))


@pytest.fixture(scope="module")
def guided(tmp_path_factory):
    """Two narrow colored_mnist_guided experts saved by name."""
    out = tmp_path_factory.mktemp("guided")
    trees = [_save(out, "colored_mnist_guided", n, GUIDED, 30 + i)
             for i, n in enumerate(("expert_a", "expert_b"))]
    return str(out), trees


SD_ARGS = ["--schedule.num_timesteps=3", "--sample.batch_size=2"]


@pytest.mark.parametrize("argv,kw", [
    (["--labels", "[[3,10],[7,2]]", "--temp", "0.5", "--bias", "0.5,-0.5"],
     dict(labels=[[3, 10], [7, 2]], operation="OR", temp=0.5,
          bias=(0.5, -0.5))),
    (["--operation", "AND", "--rigorous_and", "--seed", "5"],
     dict(operation="AND", rigorous_and=True)),
    (["--operation", "FIXED", "--kappa", "[0.7,0.3]"],
     dict(operation="FIXED", kappa=[0.7, 0.3]))])
def test_superdiff_is_its_entry_points(guided, argv, kw, monkeypatch,
                                       capsys):
    out, _ = guided
    rec = Record(monkeypatch, "sample_superdiff")
    assert cli("superdiff").main(["--cpu", "--out", out] + argv + NARROW
                                 + SD_ARGS) == 0
    op = kw["operation"]
    png = _results(out, "colored_mnist_guided") / f"superdiff_{op}.png"
    assert f"SUPERDIFF {op} samples saved to {png}" in capsys.readouterr().out
    monkeypatch.undo()
    seed = 5 if "--seed" in argv else 42
    trees = entry.load_named("colored_mnist_guided",
                             ["expert_a", "expert_b"], out, NARROW, "cpu")
    ref = entry.sample_superdiff(
        trees, Draws(seed).normal((2, 8, 8, 3)), kw.pop("labels", None),
        num_timesteps=3, seed=seed, device="cpu", model=GUIDED, **kw)
    _same(rec.calls[0][2], ref)
    assert png.exists()


def test_layout_compose_is_its_entry_points(guided, monkeypatch):
    out, _ = guided
    rec = Record(monkeypatch, "sample_layout")
    assert cli("layout_compose").main(["--cpu", "--out", out, "--radius",
                                       "3"] + NARROW + SD_ARGS) == 0
    monkeypatch.undo()
    trees = entry.load_named("colored_mnist_guided",
                             ["expert_a", "expert_b"], out, NARROW, "cpu")
    ref = entry.sample_layout(trees, Draws(42).normal((2, 8, 8, 3)),
                              radius=3, num_timesteps=3, seed=42,
                              device="cpu", model=GUIDED)
    _same(rec.calls[0][2], ref)
    assert (_results(out, "colored_mnist_guided")
            / "layout_composed.png").exists()


def test_compose_cfg_is_the_entry_point(tmp_path, monkeypatch):
    ov = ["--model.base_dim=8", "--model.channel_mults=[1,2]",
          "--model.time_emb_dim=32", "--sample.n_steps=2",
          "--sample.batch_size=2"]
    model = builders.build_model(get_config("ito_cross_attention", ov))
    _save(tmp_path, "ito_cross_attention", "guided", model, 3)
    rec = Record(monkeypatch, "compose_cfg")
    assert cli("compose_cfg").main(
        ["--cpu", "--preset", "ito_cross_attention", "--out", str(tmp_path),
         "--digit", "4", "--color", "1", "--guidance", "[1.5,3.0]"]
        + ov) == 0
    monkeypatch.undo()
    ref = entry.compose_cfg("ito_cross_attention", "guided", digit=4,
                            color=1, guidance=[1.5, 3.0], out=str(tmp_path),
                            overrides=ov, device="cpu")
    _same(rec.calls[0][2], ref)
    assert (_results(tmp_path, "ito_cross_attention")
            / "cfg_d4_c1.png").exists()


SHAPE_GRAY = UNet(in_channels=1, base_dim=8, channel_mults=(1, 2),
                  num_classes=(3,))
SHAPE_RGB = dataclasses.replace(SHAPE_GRAY, in_channels=3)
SHAPES_OV = ["--model.base_dim=8", "--model.channel_mults=[1,2]",
             "--data.img_size=8"]


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    """A gray shape expert and an RGB color expert of shapes_ddim."""
    out = tmp_path_factory.mktemp("shapes")
    trees = [_save(out, "shapes_ddim", n, m, 50 + i) for i, (n, m) in
             enumerate((("shape_expert", SHAPE_GRAY),
                        ("color_expert", SHAPE_RGB)))]
    return str(out), trees


def test_compose_images_ito_is_the_entry_point(shapes, monkeypatch, capsys):
    out, _ = shapes
    rec = Record(monkeypatch, "compose_images_ito")
    assert cli("compose_images_ito").main(
        ["--cpu", "--out", out, "--n_steps", "2", "--probe", "rademacher",
         "--gray_protocol", "luma_norm"] + SHAPES_OV) == 0
    assert "Ito-kappa composition grid saved to" in capsys.readouterr().out
    monkeypatch.undo()
    ref = entry.compose_images_ito(
        "shapes_ddim", n_steps=2, probe="rademacher",
        gray_protocol="luma_norm", out=out, overrides=SHAPES_OV,
        device="cpu")
    _same(rec.calls[0][2], ref)


# ----------------------------------------------------- latent and VAE
@pytest.fixture(scope="module")
def latent(tmp_path_factory):
    """fit_pca and train_latent_2d by their command lines on
    mnist_latent2d (200 images of 8 x 8, 6 training steps), recorded."""
    out = str(tmp_path_factory.mktemp("latent"))
    ov = ["--data.n=200", "--data.img_size=8", "--train.steps=6",
          "--train.batch_size=16"]
    mp = pytest.MonkeyPatch()
    recs = [Record(mp, "fit_pca"), Record(mp, "train_latent_2d")]
    try:
        assert cli("fit_pca").main(["--cpu", "--out", out] + ov) == 0
        assert cli("train_latent_2d").main(["--cpu", "--out", out] + ov) == 0
    finally:
        mp.undo()
    return out, ov, [r.calls[0][2] for r in recs]


def test_latent_training_is_its_entry_points(latent, tmp_path):
    out, ov, (pca, trained) = latent
    ref = entry.fit_pca("mnist_latent2d", out=str(tmp_path),
                        overrides=ov, device="cpu")
    _same([pca.mean, pca.components], [ref.mean, ref.components])
    for f in ("mean", "components", "explained_variance"):
        assert (Path(out) / f"pca_{f}.npy").read_bytes() == \
            (tmp_path / f"pca_{f}.npy").read_bytes()
    ref = entry.train_latent_2d("mnist_latent2d", out=str(tmp_path),
                                overrides=ov, device="cpu")
    _same(trained[:2], ref[:2])
    assert {"latent_expert_loss.npy", "latent_expert_loss.png",
            "latent_expert_latents.png"} <= {
        p.name for p in _results(out, "mnist_latent2d").iterdir()}


def test_sample_latent_is_the_entry_point(latent, monkeypatch):
    out, ov, _ = latent
    rec = Record(monkeypatch, "sample_latent")
    args = ["--sample.n_steps=4", "--sample.batch_size=5",
            "--sample.xi=0.5", "--data.img_size=8"]
    assert cli("sample_latent").main(["--cpu", "--out", out, "--seed", "3"]
                                     + args) == 0
    monkeypatch.undo()
    tree = CheckpointManager(out, "mnist_latent2d").load(
        "latent_expert")["params"]
    ref = entry.sample_latent(
        [tree], entry.load_pca(os.path.join(out, "pca"), "cpu"),
        Draws(3).normal((5, 2)), op="em", n_steps=4, xi=0.5, seed=3,
        device="cpu", model=entry.SHAPES_LATENT_MLP)
    _same(rec.calls[0][2], ref)
    assert {"latent_decoded.png", "latent_samples.png"} <= {
        p.name for p in _results(out, "mnist_latent2d").iterdir()}


@pytest.mark.parametrize("name,argv", [
    ("visualize_forward", ["--n", "32", "--toy2d"]),
    ("visualize_forward", ["--data.n=40", "--data.img_size=8"]),
    ("visualize_composition_latent", ["--n_steps", "5", "--data.n=40",
                                      "--data.img_size=8"]),
    ("visualize_composition_latent", ["--n_steps", "3", "--data.n=40",
                                      "--data.img_size=8", "--sampler",
                                      "ode", "--mode", "avg"])])
def test_visualisations_draw(latent, name, argv, capsys, tmp_path):
    out, _, _ = latent
    if name == "visualize_forward":
        argv = argv + ["--pca", os.path.join(out, "pca"), "--out",
                       str(tmp_path / "fwd.png")]
    else:
        argv = argv + ["--out", out]
    assert cli(name).main(["--cpu"] + argv) == 0
    path = capsys.readouterr().out.split("saved to ")[-1].strip()
    assert Path(path).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_vae_command_lines_are_their_entry_points(tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    rec = Record(monkeypatch, "train_vae")
    rec_c = Record(monkeypatch, "compose_latent_vae")
    assert cli("train_vae").main(["--cpu", "--vae_steps", "2",
                                  "--diff_steps", "3", "--latent_dim", "4",
                                  "--out", str(a), "--data.n=64"]) == 0
    assert cli("compose_latent_vae").main(
        ["--cpu", "--mode", "weighted", "--bs", "3", "--latent_dim", "4",
         "--digits", "[1,7]", "--out", str(a)]) == 0
    monkeypatch.undo()
    ref = entry.train_vae(latent_dim=4, vae_steps=2, diff_steps=3,
                          out=str(b), overrides=["--data.n=64"],
                          device="cpu")
    got = rec.calls[0][2]
    _same({k: got[k] for k in ("vae", "mlp", "vae_losses", "diff_losses")},
          {k: ref[k] for k in ("vae", "mlp", "vae_losses", "diff_losses")})
    _same(rec_c.calls[0][2], entry.compose_latent_vae(
        digits=[1, 7], mode="weighted", bs=3, latent_dim=4, out=str(b),
        device="cpu"))
    assert (a / "mnist_image_vae" / "run_0" / "results"
            / "vae_composed_weighted.png").exists()


def test_superposition_2d_is_the_entry_point(tmp_path, monkeypatch):
    rec = Record(monkeypatch, "superposition_2d")
    assert cli("superposition_2d").main(
        ["--cpu", "--steps", "20", "--n_sample_steps", "10", "--hidden", "8",
         "--bs", "32", "--seed", "3", "--out", str(tmp_path / "a")]) == 0
    monkeypatch.undo()
    ref = entry.superposition_2d(steps=20, hidden=8, bs=32,
                                 n_sample_steps=10, seed=3,
                                 out=str(tmp_path / "b"), device="cpu")
    _same([rec.calls[0][2][k] for k in ("samples", "ll")],
          [ref[k] for k in ("samples", "ll")])
    assert {"composed_and.npy", "log_likelihoods.npy", "composed_and.png",
            "log_likelihoods.png", "ground_truth_up.png"} <= {
        p.name for p in (tmp_path / "a").iterdir()}


# --------------------------------------- the glue against the JAX scripts
def _jax_unet(model):
    return JaxUNet(**{f: getattr(model, f) for f in (
        "in_channels", "base_dim", "channel_mults", "time_emb_dim",
        "num_classes", "null_token", "cross_attn")}, use_pallas=False)


def _jax_draws(key, n, shape, per_step=1):
    """The normals a JAX DDPM sampler draws: it splits its carried key
    before each draw, ``per_step`` times a step."""
    def body(k, _):
        zs = []
        for _ in range(per_step):
            k, sub = jax.random.split(k)
            zs.append(jax.random.normal(sub, shape, jnp.float32))
        return k, zs[0] if per_step == 1 else jnp.stack(zs)
    return np.asarray(jax.lax.scan(body, key, None, length=n)[1])


def _replay(xs, x_pos, extra):
    """A ``Record.replace`` that puts ``xs[i]`` at position ``x_pos`` of
    call i and adds ``extra[i]`` to its keywords."""
    def replace(i, args, kwargs):
        args[x_pos] = torch.from_numpy(np.asarray(xs[i]))
        kwargs.update({k: torch.from_numpy(np.asarray(v))
                       for k, v in extra[i].items()})
        return args, kwargs
    return replace


T_SD = 3


@pytest.mark.parametrize("op,rigorous", [("OR", False), ("AND", True)])
def test_superdiff_matches_the_script(guided, op, rigorous, monkeypatch):
    """scripts/superdiff.py: per-expert labels, the stack fed
    ``ti.astype(float32)``, x_init and every step's draws from the key."""
    out, trees = guided
    key = jax.random.PRNGKey(42)
    shape = (2, 8, 8, 3)
    labels = np.array([[3, 10], [7, 2]], np.int32)
    stack = jexperts.ExpertStack(
        _jax_unet(GUIDED).apply,
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    label_args = [jexperts.per_expert(jnp.broadcast_to(
        jnp.asarray(labels)[:, s:s + 1], (2, 2))) for s in range(2)]

    def fn(x, ti):
        return stack(x, ti.astype(jnp.float32), *label_args)

    x0 = jax.random.normal(key, shape)
    sde = JaxDDPM(num_timesteps=T_SD)
    if rigorous:
        ref = jsamplers.superdiff_and_solve(fn, sde, key, x0, mode=op,
                                            k_experts=2)
    else:
        ref = jsamplers.superdiff(fn, sde, key, x0, operation=op)
    noise = _jax_draws(key, T_SD, shape, per_step=2 if rigorous else 1)
    rec = Record(monkeypatch, "sample_superdiff",
                 _replay([x0], 1, [{"noise": noise}]))
    argv = ["--cpu", "--out", out, "--operation", op, "--labels",
            "[[3,10],[7,2]]"] + (["--rigorous_and"] if rigorous else [])
    assert cli("superdiff").main(argv + NARROW + SD_ARGS) == 0
    _close(rec.calls[0][2].numpy(), ref, 1e-4)


def test_layout_compose_matches_the_script(guided, monkeypatch):
    out, trees = guided
    key = jax.random.PRNGKey(42)
    shape = (2, 8, 8, 3)
    stack = jexperts.ExpertStack(
        _jax_unet(GUIDED).apply,
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    zeros = [jexperts.per_expert(jnp.zeros((2, 2), jnp.int32))] * 2
    masks = jnp.stack([jnp.ones((8, 8)),
                       jnp.asarray(entry.circular_mask(8, 8, radius=3))])
    x0 = jax.random.normal(key, shape)
    ref = jsamplers.layout(
        lambda x, ti: stack(x, ti.astype(jnp.float32), *zeros),
        JaxDDPM(num_timesteps=T_SD), key, x0, masks)
    rec = Record(monkeypatch, "sample_layout",
                 _replay([x0], 1, [{"noise": _jax_draws(key, T_SD, shape)}]))
    assert cli("layout_compose").main(["--cpu", "--out", out, "--radius",
                                       "3"] + NARROW + SD_ARGS) == 0
    _close(rec.calls[0][2].numpy(), ref, 1e-4)


BBOX_OV = ["--model.base_dim=8", "--model.channel_mults=[1,2]",
           "--data.img_size=8", "--schedule.num_timesteps=3",
           "--data.n=60"]
BBOX_UNET = UNet(in_channels=3, base_dim=8, channel_mults=(1, 2),
                 num_classes=(3,))


def test_compose_bbox_trains_as_the_script(tmp_path, monkeypatch, capsys):
    """The training keys fold_in(seed, i) (initial tree) and
    fold_in(seed, 10 + i) (training), the checkpoints, and each
    combination through entry.sample_ancestral from fold_in(seed,
    100 + n): the same bits as those calls made directly."""
    rec = Record(monkeypatch, "sample_ancestral")
    assert cli("compose_bbox").main(["--cpu", "--sanity", "--out",
                                     str(tmp_path)] + BBOX_OV) == 0
    out = capsys.readouterr().out
    assert out.count("training ") == 3
    assert "held-out combo (shape=2, color=2, bbox=0) sampled" in out
    monkeypatch.undo()
    cfg = get_config("shapes_bbox", BBOX_OV)
    cfg.train.sanity = True
    cfg.apply_sanity()
    imgs, *labels = entry.data.make_shapes_bbox_dataset(
        cfg.data.n, 8, holdout=[(2, 2)])
    mgr = CheckpointManager(str(tmp_path), "shapes_bbox")
    trees = []
    for i, fac in enumerate(("shape", "color", "bbox")):
        p, _ = train.train_expert(
            fold_in(42, 10 + i), BBOX_UNET.apply,
            convert.unet_torch_layout(convert.flax_init(
                BBOX_UNET, fold_in(42, i), "cpu")),
            builders.build_schedule(cfg), imgs, (labels[i],),
            steps=cfg.train.steps, batch_size=cfg.train.batch_size,
            lr=cfg.train.lr)
        _same(mgr.load(f"{fac}_expert")["params"], p)
        trees.append(p)
    assert len(rec.calls) == 27
    for n in (0, 26):
        k = fold_in(42, 100 + n)
        s, c, b = n // 9, n // 3 % 3, n % 3
        lab = torch.tensor([[s] * 2, [c] * 2, [b] * 2])
        ref = entry.sample_ancestral(
            trees, Draws(k).normal((2, 8, 8, 3)), lab, weights=[1, 1, 1],
            num_timesteps=3, seed=k, device="cpu", model=BBOX_UNET)
        _same(rec.calls[n][2], ref)
    assert (_results(tmp_path, "shapes_bbox")
            / "bbox_composition_grid.png").exists()
    assert (tmp_path / "shapes_bbox" / "run_0" / "logs"
            / "compose_bbox_config.yaml").exists()


def test_compose_bbox_matches_the_script(tmp_path, monkeypatch):
    """--no_train on three saved trees: combinations 0, 13 and 26 against
    scripts/compose_bbox.py's sampler, their x_init and draws replayed (the
    others sample from the port's own draws)."""
    trees = [_save(tmp_path, "shapes_bbox", f"{f}_expert", BBOX_UNET, 60 + i)
             for i, f in enumerate(("shape", "color", "bbox"))]
    model = _jax_unet(BBOX_UNET)
    jp = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    w = jnp.asarray([1.0, 0.5, 2.0], jnp.float32)
    sched = JaxDDPM(num_timesteps=3)
    key = jax.random.PRNGKey(42)

    @jax.jit
    def combo(sl, cl, bl, k):
        def eps_fn(x, ti):
            t_in = jnp.full((x.shape[0],), ti, jnp.float32)
            return jcompose.weighted(jnp.stack([
                model.apply(jp[0], x, t_in, sl),
                model.apply(jp[1], x, t_in, cl),
                model.apply(jp[2], x, t_in, bl)]), w)
        return jsamplers.ddpm_ancestral(eps_fn, sched, k,
                                        jax.random.normal(k, (2, 8, 8, 3)))

    checked = (0, 13, 26)
    keys = {n: jax.random.fold_in(key, 100 + n) for n in checked}
    refs = {n: combo(*(jnp.full((2,), v, jnp.int32)
                       for v in (n // 9, n // 3 % 3, n % 3)), keys[n])
            for n in checked}
    replay = _replay([jax.random.normal(keys[n], (2, 8, 8, 3))
                      for n in checked], 1,
                     [{"noise": _jax_draws(keys[n], 3, (2, 8, 8, 3))}
                      for n in checked])

    def replace(i, args, kwargs):
        return (replay(checked.index(i), args, kwargs) if i in checked
                else (args, kwargs))

    rec = Record(monkeypatch, "sample_ancestral", replace)
    assert cli("compose_bbox").main(
        ["--cpu", "--sanity", "--no_train", "--weights", "[1.0,0.5,2.0]",
         "--out", str(tmp_path)] + BBOX_OV) == 0
    assert len(rec.calls) == 27
    for n in checked:
        assert rec.calls[n][0][2].tolist() == [[n // 9] * 2,
                                              [n // 3 % 3] * 2, [n % 3] * 2]
        _close(rec.calls[n][2].numpy(), refs[n], 1e-4)


@pytest.mark.parametrize("op,proto", [("avg", "white"),
                                      ("proj", "luma_norm")])
def test_compose_images_ddim_matches_the_script(shapes, op, proto,
                                                monkeypatch):
    """scripts/compose_images_ddim.py: combination (s, c) from
    fold_in(seed, 3 s + c), DDIM, the gray adapter and its lift; against
    the same calls of the entry point, bit for bit, and the script."""
    out, trees = shapes
    sp, cp = (jax.tree_util.tree_map(jnp.asarray, t) for t in trees)
    gm, cm = _jax_unet(SHAPE_GRAY), _jax_unet(SHAPE_RGB)
    norm = proto == "luma_norm"
    key = jax.random.PRNGKey(42)

    @jax.jit
    def combo(sl, cl, k):
        def eps_fn(x, t):
            e_gray = gm.apply(sp, jexperts.rgb_to_gray(x, normalized=norm),
                              t, sl)
            e_color = cm.apply(cp, x, t, cl)
            if op == "proj":
                return jcompose.projected(e_color, e_gray, 1.5)
            return jcompose.weighted(jnp.stack([
                jexperts.gray_to_rgb(e_gray, normalized=norm), e_color]),
                jnp.array([1.5, 0.5]))
        return jsamplers.ddim(eps_fn, JaxVP(),
                              jax.random.normal(k, (1, 8, 8, 3)), 3)

    keys = [jax.random.fold_in(key, i) for i in range(9)]
    refs = [combo(jnp.full((1,), i // 3, jnp.int32),
                  jnp.full((1,), i % 3, jnp.int32), k)
            for i, k in enumerate(keys)]
    rec = Record(monkeypatch, "sample_gray_color", _replay(
        [jax.random.normal(k, (1, 8, 8, 3)) for k in keys], 2, [{}] * 9))
    assert cli("compose_images_ddim").main(
        ["--cpu", "--out", out, "--op", op, "--gray_protocol", proto,
         "--w_shape", "1.5", "--w_color", "0.5", "--sample.n_steps=3"]
        + SHAPES_OV) == 0
    for (_, _, got), ref in zip(rec.calls, refs):
        _close(got.numpy(), ref, 1e-4)
    monkeypatch.undo()
    # the same calls made directly, from the port's own draws
    rec = Record(monkeypatch, "sample_gray_color")
    assert cli("compose_images_ddim").main(
        ["--cpu", "--out", out, "--op", op, "--gray_protocol", proto,
         "--sample.n_steps=3"] + SHAPES_OV) == 0
    monkeypatch.undo()
    tt = [CheckpointManager(out, "shapes_ddim").load(n)["params"]
          for n in ("shape_expert", "color_expert")]
    for i in (0, 8):
        ref = entry.sample_gray_color(
            *tt, Draws(fold_in(42, i)).normal((1, 8, 8, 3)),
            torch.full((1,), i // 3), torch.full((1,), i % 3), op=op,
            gray_protocol=proto, n_steps=3, device="cpu",
            shape_model=SHAPE_GRAY, color_model=SHAPE_RGB)
        _same(rec.calls[i][2], ref)
    assert (_results(out, "shapes_ddim")
            / "ddim_composition_grid.png").exists()


JM = JaxScoreMLP(hidden=256, depth=3, out_dim=2)


def _em_noise(key, n_steps, shape):
    """jsamplers.euler_maruyama's draws: k, sub = split(k); normal(sub)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _ito_probes(key, n_steps, shape):
    """ito_kappa_ode: k, k1, k2 = split(k, 3); a Rademacher probe each."""
    out = []
    for _ in range(n_steps):
        key, k1, k2 = jax.random.split(key, 3)
        out.append(np.stack([np.asarray(jdiv._probe(
            k, shape, jnp.float32, "rademacher")) for k in (k1, k2)]))
    return np.stack(out)


def test_sample_latent_matches_the_script(tmp_path, monkeypatch):
    """scripts/sample_latent.py: two experts weighted (2, 0.5), E-M with
    the key of x_init, decoded by the codec's files."""
    rs = np.random.default_rng(9)
    mean = rs.standard_normal(64).astype(np.float32)
    comps = np.linalg.qr(rs.standard_normal((64, 2)))[0].T.astype(
        np.float32)
    for f, v in (("mean", mean), ("components", comps),
                 ("explained_variance", np.array([2.0, 1.0], np.float32))):
        np.save(tmp_path / f"pca_{f}.npy", v)
    trees = [_save(tmp_path, "mnist_latent2d", n, entry.SHAPES_LATENT_MLP,
                   20 + i) for i, n in enumerate(("e0", "e1"))]
    jt = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    key = jax.random.PRNGKey(42)
    w = jnp.asarray([2.0, 0.5])

    def eps_fn(x, t):
        return jcompose.weighted(jnp.stack([
            JM.apply(p, jnp.full((x.shape[0],), t), x) for p in jt]), w)

    n, bs = 8, 6
    z0 = jax.random.normal(key, (bs, 2))
    z_ref = jsamplers.euler_maruyama(eps_fn, JaxVP(), key, z0, n, 1.0)
    img_ref = jpca.load_pca(str(tmp_path / "pca")).decode(z_ref, (8, 8, 1))
    rec = Record(monkeypatch, "sample_latent", _replay(
        [z0], 2, [{"noise": _em_noise(key, n, (bs, 2))}]))
    assert cli("sample_latent").main(
        ["--cpu", "--out", str(tmp_path), "--experts", '["e0","e1"]',
         "--weights", "[2.0,0.5]", f"--sample.n_steps={n}",
         f"--sample.batch_size={bs}", "--data.img_size=8"]) == 0
    z, imgs = rec.calls[0][2]
    _close(z.numpy(), z_ref, 1e-3)
    # the port clips the decoded images to [-1, 1], which the grid does
    # too; the script writes them unclipped
    _close(imgs.numpy(), jnp.clip(img_ref, -1.0, 1.0),
           1e-3 * max(1.0, float(jnp.abs(z_ref).max())))


def test_latent_shape_experts_matches_the_script(tmp_path, monkeypatch):
    """--no_train on three saved class experts and the PCA the script
    fits: each operator from fold_in(seed, 77)'s latents (ito's probes
    from fold_in(seed, 88)) against the script's computation."""
    size, n_data, n, steps = 16, 60, 10, 6
    imgs, _, _ = jdata.make_shapes_dataset(n_data, size, grayscale=True)
    pj = jpca.fit_pca(imgs, 2)
    ckpt = tmp_path / "shapes_latent" / "run_0" / "checkpoints"
    ckpt.mkdir(parents=True)
    jpca.save_pca(str(ckpt / "pca_grayscale"), pj)
    trees = [_save(tmp_path, "shapes_latent", f"latent_expert_class{c}",
                   entry.SHAPES_LATENT_MLP, 70 + c) for c in range(3)]
    pa, pb = (jax.tree_util.tree_map(jnp.asarray, trees[i]) for i in (0, 2))
    key = jax.random.PRNGKey(42)
    sched = JaxVP()
    x0 = jax.random.normal(jax.random.fold_in(key, 77), (n, 2))
    sa, sb = ((lambda x, t, p=p: -JM.apply(p, t, x)) for p in (pa, pb))
    refs = {
        "ito": jsamplers.ito_kappa_ode((sa, sb), sched,
                                       jax.random.fold_in(key, 88), x0,
                                       steps),
        "avg": jsamplers.prob_flow_ode(
            lambda x, t: 0.5 * (sa(x, t) + sb(x, t)) / sched.sigma(t),
            sched, x0, steps),
        "ddim": jsamplers.ddim(lambda x, t: jcompose.weighted(jnp.stack(
            [JM.apply(pa, t, x), JM.apply(pb, t, x)]), jnp.ones((2,))),
            sched, x0, steps, clip=None)}
    probes = _ito_probes(jax.random.fold_in(key, 88), steps, (n, 2))
    rec = Record(monkeypatch, "sample_latent", _replay(
        [x0] * 3, 2, [{"probes": probes}, {}, {}]))
    assert cli("latent_shape_experts").main(
        ["--cpu", "--no_train", "--pair", "0,2", "--n_samples", str(n),
         "--out", str(tmp_path), f"--data.img_size={size}",
         f"--data.n={n_data}", f"--sample.n_steps={steps}"]) == 0
    for (args, kw, (z, dec)), op in zip(rec.calls, ("ito", "avg", "ddim")):
        assert kw["op"] == op
        _close(z.numpy(), refs[op], 1e-3)
        _close(dec.numpy(), jnp.clip(pj.decode(refs[op], (size, size, 1)),
                                     -1.0, 1.0),
               1e-3 * max(1.0, float(jnp.abs(refs[op]).max())))
    assert {f"latent_composed_{op}.png" for op in refs} <= {
        p.name for p in _results(tmp_path, "shapes_latent").iterdir()}


def test_latent_shape_experts_trains_as_the_script(tmp_path, monkeypatch):
    """Training: class c's tree from fold_in(seed, c), trained with
    fold_in(seed, 10 + c) on its latents; then the operators through the
    entry point on those trees, bit for bit."""
    rec = Record(monkeypatch, "sample_latent")
    assert cli("latent_shape_experts").main(
        ["--cpu", "--sanity", "--ops", "ddim", "--out", str(tmp_path),
         "--data.img_size=16", "--sample.n_steps=4"]) == 0
    monkeypatch.undo()
    cfg = get_config("shapes_latent", ["--data.img_size=16"])
    cfg.train.sanity = True
    cfg.apply_sanity()
    imgs, labels, _ = entry.data.make_shapes_dataset(cfg.data.n, 16,
                                                     grayscale=True)
    mgr = CheckpointManager(str(tmp_path), "shapes_latent")
    pca = entry.pca_codec.load_pca(os.path.join(mgr.ckpt_dir,
                                                "pca_grayscale"))
    z_all = pca.encode(imgs)
    model = entry.SHAPES_LATENT_MLP
    trained = []
    for c in range(3):
        z_c = z_all[labels == c]
        p, _ = train.train_expert(
            fold_in(42, 10 + c), model.apply,
            convert.flax_init(model, fold_in(42, c), "cpu"),
            entry.VPSchedule(), z_c, steps=cfg.train.steps,
            batch_size=min(cfg.train.batch_size, z_c.shape[0]),
            lr=cfg.train.lr, time_first=True,
            steps_per_scan=min(200, cfg.train.steps))
        _same(mgr.load(f"latent_expert_class{c}")["params"], p)
        trained.append(p)
    ref = entry.sample_latent(
        trained[:2], pca, Draws(fold_in(42, 77)).normal((64, 2)), op="ddim",
        n_steps=4, seed=fold_in(42, 88), device="cpu", model=model)
    _same(rec.calls[0][2], ref)
