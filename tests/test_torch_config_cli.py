"""Port parity for the config-driven paths: ``utils`` (presets, overrides,
``save_yaml``, the image grid and its PNG, profiling),
``builders`` against ``scripts/_common.py``, and the entry points of
``scripts/train_image.py`` (with every JAX draw replayed),
``scripts/sample_image.py`` (each sampler), ``scripts/compose_scores.py``
(the blend on and off the kernel's wrapper) and ``scripts/superdiff.py``
on experts loaded back by name, each against the script's computation at
narrow width."""

import importlib.util
import json
import struct
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu import train as jtrain
from composable_diffusion_models_tpu.utils import config as jconfig
from composable_diffusion_models_tpu.utils import viz as jviz
from composable_diffusion_models_tpu_torch import (builders, convert, entry,
                                                   train)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.ops import kernels
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.utils import (config, profiling,
                                                         viz)

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
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, ref, tol):
    """max |got - ref| <= tol * max(1, |ref|max)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


# --------------------------------------------------------------- config
@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_presets_match_jax(preset):
    """Every preset's tree, before and after the sanity cut."""
    got, ref = config.get_config(preset), jconfig.get_config(preset)
    assert config.to_dict(got) == jconfig.to_dict(ref)
    got.train.sanity = ref.train.sanity = True
    assert (config.to_dict(got.apply_sanity())
            == jconfig.to_dict(ref.apply_sanity()))


@pytest.mark.parametrize("preset,overrides", [
    ("mnist_image", ["--train.steps=7", "--model.base_dim=8"]),
    ("shapes_ddim", ["--data.holdout=[[2,2],[0,1]]"]),
    ("shapes_ddim", ["--data.holdout=((2,2),)"]),
    ("shapes_bbox", ["--sample.weights=(1.0, 0.5, 2)",
                     "--model.dtype=bfloat16", "--train.ema_decay=0.999"]),
    ("mnist_image", ["--data.classes=[0,1]", "--data.data_dir=none",
                     "--train.sanity=yes", "ignored", "--no_value"]),
    ("colored_mnist_guided", ["--model.num_classes=(10,3)",
                              "--model.null_token=0", "--data.n=100"]),
])
def test_overrides_match_jax(preset, overrides):
    """The cases of tests/test_config.py and more: dotted paths, JSON and
    Python tuple spellings (a trailing comma), bool, int, float and string
    coercion, None, and arguments that are not overrides."""
    got = config.get_config(preset, overrides)
    assert config.to_dict(got) == jconfig.to_dict(
        jconfig.get_config(preset, overrides))


@pytest.mark.parametrize("bad,err", [("--data.holdout=[[2,", ValueError),
                                     ("--train.steps=many", ValueError),
                                     ("--model.nope=1", AttributeError)])
def test_bad_overrides_raise_as_jax(bad, err):
    for lib in (config, jconfig):
        with pytest.raises(err, match="could not parse" if "[[" in bad
                           else None):
            lib.get_config("shapes_ddim", [bad])


@pytest.mark.parametrize("have_yaml", [True, False])
def test_save_yaml_matches_jax(tmp_path, monkeypatch, have_yaml):
    """The same file from both, with the ``yaml`` module and without it
    (the JSON branch, a YAML subset)."""
    if not have_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)  # import fails
    overrides = ["--data.holdout=((2,2),)", "--model.dtype=bfloat16"]
    got = config.save_yaml(config.get_config("shapes_bbox", overrides),
                           str(tmp_path / "a" / "port.yaml"))
    ref = jconfig.save_yaml(jconfig.get_config("shapes_bbox", overrides),
                            str(tmp_path / "b" / "jax.yaml"))
    assert Path(got).read_text() == Path(ref).read_text()
    if not have_yaml:
        assert json.loads(Path(got).read_text())["name"] == "shapes_bbox"


# ------------------------------------------------------------------ viz
def _read_png(path):
    """(width, height, pixels) of an 8-bit RGB PNG with filter-0 rows,
    decoded with zlib."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                        chunks[b"IHDR"])
    assert (depth, color, interlace) == (8, 2, 0) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return w, h, rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("n,hw,c,lo,nrow", [(16, 7, 1, -1.0, 4),
                                            (5, 9, 3, 0.0, 8),
                                            (3, 4, 3, -1.5, 2)])
def test_grid_and_png_match_jax(tmp_path, n, hw, c, lo, nrow):
    """``_to_numpy_grid`` bit for bit against the JAX one ([-1, 1] and
    [0, 1] inputs, out-of-range values, one and three channels, a ragged
    last row), and ``save_grid``'s PNG holds exactly that grid (a torch
    tensor is taken as its array)."""
    imgs = np.random.default_rng(n).uniform(lo, 1.2, (n, hw, hw, c)).astype(
        np.float32)
    grid = viz._to_numpy_grid(imgs, nrow)
    np.testing.assert_array_equal(grid, jviz._to_numpy_grid(imgs, nrow))
    path = viz.save_grid(torch.from_numpy(imgs), str(tmp_path / "g.png"),
                         nrow=nrow, title="ignored")
    w, h, pixels = _read_png(path)
    assert (h, w) == grid.shape[:2]
    np.testing.assert_array_equal(pixels, grid)


def test_matplotlib_helpers_stay_matplotlib(tmp_path):
    """``plot_loss`` and ``scatter2d`` draw through matplotlib, as in JAX
    (they take tensors too)."""
    pytest.importorskip("matplotlib")
    assert Path(viz.plot_loss(torch.linspace(2, 1, 20),
                              str(tmp_path / "l.png"))).stat().st_size
    assert Path(viz.scatter2d(torch.randn(30, 2), str(tmp_path / "s.png"),
                              labels=np.arange(30) % 2)).stat().st_size


def test_metrics_and_profiling(tmp_path):
    """A trace written by ``maybe_profile`` around an annotated region, and
    ``annotate`` a shared null context while no profiler runs."""
    with profiling.maybe_profile(False) as prof:
        assert prof is None
    assert profiling.annotate("region") is profiling.annotate("other")
    with profiling.maybe_profile(True, str(tmp_path / "p")):
        with profiling.annotate("region"):
            torch.ones(8).sum()
    assert "region" in (tmp_path / "p" / "trace.json").read_text()


# ------------------------------------------------------------- builders
def _synthetic_draws(key, n, n_classes):
    """The JAX procedural digits' draws (bucket of 256 or more)."""
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
    return [np.asarray(a) for a in (pick, scale, tx, ty)]


def _data_draws(cfg, key):
    """The JAX draws of ``_common.build_dataset(cfg, key)``, in the port's
    order."""
    d = cfg.data
    n_classes = len(d.classes) if d.classes else 10
    if d.dataset == "mnist":
        return _synthetic_draws(key, d.n, n_classes)
    if d.dataset == "colored_mnist":
        k1, k2 = jax.random.split(key)
        out = _synthetic_draws(k1, d.n, n_classes)
        if d.color_rule == "random":
            out.append(np.asarray(jax.random.randint(k2, (d.n,), 0, 3)))
        return out
    if d.dataset == "toy2d":
        k1, k2 = jax.random.split(key)
        return [np.asarray(jax.random.randint(k1, (d.n, 2),
                                              jnp.array([0, 1]),
                                              jnp.array([2, 2]))),
                np.asarray(jax.random.normal(k2, (d.n, 2)))]
    return []


@pytest.mark.parametrize("preset,overrides", [
    ("mnist_image", ["--data.classes=[1,4,7]"]),
    ("colored_mnist_guided", ["--data.holdout=((3,3),)"]),
    ("ito_cross_attention", []),
    ("shapes_ddim", ["--data.holdout=((2,2),)", "--data.img_size=16"]),
    ("shapes_ddim", ["--data.grayscale=1", "--data.gray_mode=luma_norm",
                     "--data.img_size=16"]),
    ("shapes_latent", ["--data.img_size=16", "--data.gray_mode=luma"]),
    ("shapes_bbox", ["--data.img_size=16"]),
    ("mnist_latent2d", ["--data.dataset=toy2d"]),
])
def test_build_dataset_matches_common(preset, overrides):
    """Each dataset the registry makes without a download, through the
    config's keyword table (the ``shapes_grayscale`` -> ``gray_mode`` rule
    among them), the JAX draws replayed: images 1e-6, labels equal."""
    overrides = overrides + ["--data.n=40"]
    jcfg = jconfig.get_config(preset, overrides)
    key = jax.random.PRNGKey(3)
    ref_x, ref_l = C.build_dataset(jcfg, key)
    got_x, got_l = builders.build_dataset(
        config.get_config(preset, overrides), Replay(_data_draws(jcfg, key)))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0,
                               atol=1e-6)
    assert len(got_l) == len(ref_l)
    for g, r in zip(got_l, ref_l):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_build_dataset_unknown():
    cfg = config.get_config("mnist_image", ["--data.dataset=imagenet"])
    with pytest.raises(ValueError, match="unknown dataset"):
        builders.build_dataset(cfg, 0)


@pytest.mark.parametrize("preset", ["mnist_image", "colored_mnist_guided",
                                    "ito_cross_attention", "shapes_latent"])
def test_build_model_and_init_match_common(preset):
    """The model's configuration and the init tree's key paths and shapes
    against the flax module's ``init`` through ``_common`` (a UNet's in
    ``UNet.apply``'s layout), the schedule's family and tables."""
    ov = ["--model.base_dim=8", "--model.dtype=bfloat16"]
    cfg, jcfg = config.get_config(preset, ov), jconfig.get_config(preset, ov)
    model = builders.build_model(cfg, fused_gn=True)
    jmodel = C.build_model(jcfg)
    if preset != "shapes_latent":
        assert model.dtype == torch.bfloat16 and model.fused_gn
        assert model.num_classes == tuple(jmodel.num_classes)
    ref = jax.eval_shape(lambda k: C.init_params(jcfg, jmodel, k),
                         jax.random.PRNGKey(0))
    ref_shapes = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf
                  in jax.tree_util.tree_flatten_with_path(ref)[0]}
    shapes = {}
    for path, leaf in zip(*train.flatten(builders.init_params(model, 5))):
        if path[-1] == "weight":  # OIHW in UNet.apply's layout
            path, leaf = path[:-1] + ("kernel",), leaf.permute(2, 3, 1, 0)
        shapes[path] = tuple(leaf.shape)
    assert shapes == ref_shapes
    for p in ("ddpm", "vp"):
        ov2 = [f"--schedule.family={p}", "--schedule.num_timesteps=20"]
        s = builders.build_schedule(config.get_config(preset, ov2))
        js = C.build_schedule(jconfig.get_config(preset, ov2))
        assert type(s).__name__ == type(js).__name__
        if p == "ddpm":
            np.testing.assert_allclose(s.alphas_cumprod.numpy(),
                                       np.asarray(js.alphas_cumprod),
                                       rtol=1e-6)
    with pytest.raises(ValueError, match="unknown model kind"):
        builders.build_model(config.get_config(preset, ["--model.kind=gan"]))


# ------------------------------------------------------------ train_image
GUIDED_OV = ["--model.base_dim=16"]


def _ddpm_step_draws(key, steps, n, bs, shape, T, dropout):
    """The JAX training loop's draws in the port's order, one chunk: step
    i's batch indices, then its loss's t, noise and (with label dropout)
    dropout uniforms."""
    out = []
    ck = jax.random.fold_in(key, 0)
    for i in range(steps):
        kb, kl = jax.random.split(jax.random.fold_in(ck, i))
        out.append(np.asarray(jax.random.randint(kb, (bs,), 0, n)))
        kt, ke, kd = jax.random.split(kl, 3)
        out.append(np.asarray(jax.random.randint(kt, (bs,), 0, T)))
        out.append(np.asarray(jax.random.normal(ke, (bs,) + shape)))
        if dropout:
            out.append(np.asarray(jax.random.uniform(kd, (bs,))))
    return out


def _jax_train_image(preset, overrides, classes, init):
    """scripts/train_image.py's computation with ``--conditional
    --sanity``, the flax tree ``init`` in place of its init."""
    cfg = jconfig.get_config(preset, overrides)
    cfg.data.classes = tuple(classes)
    cfg.train.sanity = True
    cfg.apply_sanity()
    key = jax.random.PRNGKey(cfg.train.seed)
    images, labels = C.build_dataset(cfg, jax.random.fold_in(key, 1))
    model = C.build_model(cfg)
    t = cfg.train
    params, losses = jtrain.train_expert(
        jax.random.fold_in(key, 3), model.apply,
        jax.tree_util.tree_map(jnp.asarray, init), C.build_schedule(cfg),
        images, labels[:len(cfg.model.num_classes)], steps=t.steps,
        batch_size=t.batch_size, lr=t.lr, predict=t.predict,
        snr_gamma=t.snr_gamma or None, uncond_prob=t.uncond_prob,
        null_labels=tuple(cfg.model.num_classes),
        steps_per_scan=min(100, t.steps))
    draws = _data_draws(cfg, jax.random.fold_in(key, 1))
    draws += _ddpm_step_draws(jax.random.fold_in(key, 3), t.steps,
                              images.shape[0], t.batch_size,
                              tuple(images.shape[1:]),
                              cfg.schedule.num_timesteps, True)
    return params, losses, draws, cfg


def _guided_init(key):
    """The flax init of the guided UNet (``_common.init_params``) as
    numpy."""
    jcfg = jconfig.get_config("colored_mnist_guided", GUIDED_OV)
    jmodel = C.build_model(jcfg)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: C.init_params(jcfg, jmodel, k))(key))


@pytest.fixture(scope="module")
def guided_run(tmp_path_factory):
    """``train_image("colored_mnist_guided", conditional=True,
    sanity=True)`` at base 16 on digits {1, 4, 7}, every draw replayed,
    from the flax init of the script's key, beside the script's run."""
    out = str(tmp_path_factory.mktemp("guided"))
    init = _guided_init(jax.random.fold_in(jax.random.PRNGKey(42), 2))
    ref_params, ref_losses, draws, cfg = _jax_train_image(
        "colored_mnist_guided", GUIDED_OV, (1, 4, 7), init)
    replay = Replay(draws)
    params, losses, path = entry.train_image(
        "colored_mnist_guided", "guided_a", classes=(1, 4, 7),
        conditional=True, sanity=True, out=out, overrides=GUIDED_OV,
        device="cpu", key=replay, init=convert.from_flax(init))
    assert not replay.queue
    return dict(out=out, init=init, params=params, losses=losses, path=path,
                ref_params=ref_params, ref_losses=ref_losses, draws=draws,
                cfg=cfg)


def test_train_image_matches_the_script(guided_run):
    """20 sanity steps of batch 8 on 64 colored digits under the preset's
    ``DDPMSchedule(1000)``, label dropout 0.1 to the null labels (10, 10)
    with one mask a sample shared by both slots: the losses to 1e-5
    (measured 6.7e-6), and each leaf of the trained tree within 1e-5 of
    its scale or within 1e-2 of the distance it moved from its init,
    whichever is larger. Adam (epsilon 1e-8, the script's) divides each
    step by the root of the squared gradients' average, so a parameter
    whose gradient is small moves by a learning rate a step whatever the
    gradient's size, and a float32 difference between the frameworks'
    gradients there moves it differently: the zero-init biases of the
    first level end 4.7e-4 of their scale apart (2.2e-3 of the distance
    moved at most, among all leaves). At base 16 every GroupNorm group
    holds two channels or more: at base 8 (one channel a group in the
    first level) six leaves have a gradient that is zero in exact
    arithmetic."""
    r = guided_run
    np.testing.assert_allclose(r["losses"].numpy(),
                               np.asarray(r["ref_losses"]), rtol=0,
                               atol=1e-5)
    ref, init = (convert.unet_torch_layout(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, t)))
        for t in (r["ref_params"], r["init"]))
    paths, leaves = train.flatten(r["params"])
    assert paths == train.flatten(ref)[0]
    for p, g, rr, i0 in zip(paths, leaves, train.flatten(ref)[1],
                            train.flatten(init)[1]):
        err = float((g - rr).abs().max())
        bar = max(1e-5 * float(rr.abs().max()),
                  1e-2 * float((rr - i0).abs().max()))
        assert err <= bar, (p, err, bar)
    drops = sum(bool((d < 0.1).any()) for d in r["draws"][-77::4])
    assert drops > 0  # the run exercised the dropout


def test_guided_loss_and_grads_match_jax():
    """One step of the guided UNet's denoising loss at base 16 under the
    preset's ``DDPMSchedule(1000)``, two label slots and dropout to (10,
    10) (rate 0.5, so that the batch drops some samples' labels), on the
    same x0, t, noise and dropout uniforms: the loss to 1e-6 relative,
    every gradient leaf to 1e-5 of its scale (measured 1.6e-6)."""
    from composable_diffusion_models_tpu.train import make_loss_fn
    jcfg = jconfig.get_config("colored_mnist_guided", GUIDED_OV)
    jmodel = C.build_model(jcfg)
    init = _guided_init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (8, 28, 28, 3)).astype(np.float32)
    labs = tuple(rng.integers(0, 10, 8).astype(np.int32) for _ in range(2))
    key = jax.random.PRNGKey(9)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(make_loss_fn(
        jmodel.apply, C.build_schedule(jcfg), uncond_prob=0.5,
        null_labels=(10, 10))))(jax.tree_util.tree_map(jnp.asarray, init),
                               key, jnp.asarray(x0),
                               tuple(map(jnp.asarray, labs)))
    kt, ke, kd = jax.random.split(key, 3)
    draws = [np.asarray(jax.random.randint(kt, (8,), 0, 1000)),
             np.asarray(jax.random.normal(ke, x0.shape)),
             np.asarray(jax.random.uniform(kd, (8,)))]
    assert 0 < (draws[2] < 0.5).sum() < 8
    cfg = config.get_config("colored_mnist_guided", GUIDED_OV)
    model = builders.build_model(cfg)
    loss, grads = train.value_and_grad(
        train.make_loss_fn(model.apply, builders.build_schedule(cfg),
                           uncond_prob=0.5, null_labels=(10, 10)),
        convert.unet_torch_layout(convert.from_flax(init)), Replay(draws),
        torch.from_numpy(x0), tuple(torch.from_numpy(lab).long()
                                    for lab in labs))
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)
    ref = convert.unet_torch_layout(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, ref_grads)))
    for p, g, r in zip(*train.flatten(grads), train.flatten(ref)[1]):
        err = float((g - r).abs().max())
        assert err <= 1e-5 * float(r.abs().max()), (p, err)


def test_train_image_writes_its_files(guided_run):
    """The checkpoint (bitwise through load), the config as the JAX script
    writes it, the losses; no one-step grid for a DDPM preset."""
    r = guided_run
    mgr = CheckpointManager(r["out"], "colored_mnist_guided")
    state = mgr.load("guided_a")
    assert state["step"] == 20
    for a, b in zip(train.flatten(state["params"])[1],
                    train.flatten(r["params"])[1]):
        assert torch.equal(a, b)
    cfg_text = Path(mgr.logs_dir, "guided_a_config.yaml").read_text()
    jcfg = r["cfg"]
    assert cfg_text == Path(jconfig.save_yaml(
        jcfg, str(Path(r["out"]) / "jax.yaml"))).read_text()
    np.testing.assert_array_equal(
        np.load(Path(mgr.results_dir, "guided_a_loss.npy")),
        r["losses"].numpy())
    assert not Path(mgr.results_dir, "guided_a_onestep.png").exists()
    loaded, = entry.load_named("colored_mnist_guided", ["guided_a"],
                               r["out"], GUIDED_OV, device="cpu")
    for a, b in zip(train.flatten(loaded)[1], train.flatten(r["params"])[1]):
        assert torch.equal(a, b)


def test_train_image_label_slots_and_resume(guided_run, tmp_path):
    """``label_slots=(1, 0)`` trains on (color, digit) in that order (the
    colour of digit // 4, so that the slots differ), as a direct
    ``train_expert`` call on those labels does; a resumable run
    gives the plain run's tree bit for bit, and a second call finds it
    complete (no steps, the same tree)."""
    r = guided_run
    ov = GUIDED_OV + ["--data.color_rule=div4"]
    kw = dict(classes=(1, 4, 7), conditional=True, sanity=True,
              overrides=ov, device="cpu", init=convert.from_flax(r["init"]))
    p_slots, l_slots, _ = entry.train_image(
        "colored_mnist_guided", "slots", label_slots=(1, 0),
        out=str(tmp_path), **kw)
    cfg = config.get_config("colored_mnist_guided", ov)
    cfg.data.classes = (1, 4, 7)
    cfg.train.sanity = True
    cfg.apply_sanity()
    imgs, labels = builders.build_dataset(cfg, entry._subkey(42, 1))
    assert not torch.equal(labels[0], labels[1])
    model = builders.build_model(cfg)
    p_ref, l_ref = train.train_expert(
        entry._subkey(42, 3), model.apply,
        entry._float_tree(convert.from_flax(r["init"]), model,
                          torch.device("cpu")),
        builders.build_schedule(cfg), imgs, (labels[1], labels[0]),
        steps=20, batch_size=8, lr=2e-4, uncond_prob=0.1,
        null_labels=(10, 10), steps_per_scan=20)
    assert torch.equal(l_slots, l_ref)
    p_plain, l_plain, _ = entry.train_image(
        "colored_mnist_guided", "plain", out=str(tmp_path), **kw)
    assert not torch.equal(l_plain, l_slots)
    p_res, l_res, _ = entry.train_image(
        "colored_mnist_guided", "res", resumable=True, out=str(tmp_path),
        **kw)
    assert torch.equal(l_res, l_plain)
    mgr = CheckpointManager(str(tmp_path), "colored_mnist_guided")
    assert mgr.step_list("res") == [20]
    p_again, l_again, _ = entry.train_image(
        "colored_mnist_guided", "res", resumable=True, out=str(tmp_path),
        **kw)
    assert l_again.shape == (0,)
    for a, b, c, d in zip(*(train.flatten(p)[1] for p in
                            (p_plain, p_res, p_again, p_ref))):
        assert torch.equal(a, b) and torch.equal(b, c)
    for a, b in zip(train.flatten(p_slots)[1], train.flatten(p_ref)[1]):
        assert torch.equal(a, b)


def test_train_image_one_step_grid(tmp_path):
    """An unconditional VP preset writes the one-step denoise grid (16
    images, 4 a row) through ``viz.save_grid``; the loss plot needs
    ``plot_loss``."""
    _, losses, _ = entry.train_image(
        "mnist_image", "tiny", classes=(0, 1), sanity=True, out=str(tmp_path),
        overrides=["--model.base_dim=8", "--train.steps=3"], device="cpu",
        plot_loss=True)
    res = Path(tmp_path, "mnist_image", "run_0", "results")
    w, h, _ = _read_png(res / "tiny_onestep.png")
    assert (w, h) == (4 * 30 + 2, 4 * 30 + 2)
    assert (res / "tiny_loss.png").exists() and losses.shape == (3,)


# ------------------------------------------------ sampling and composing
HW, BS, N = 8, 3, 4
IMG_OV = ["--model.base_dim=8", f"--data.img_size={HW}",
          f"--sample.batch_size={BS}", f"--sample.n_steps={N}"]
TOL = 1e-4  # a narrow UNet agrees to ~1e-6 a forward in float32


@pytest.fixture(scope="module")
def mnist_experts(tmp_path_factory):
    """Two narrow ``mnist_image`` experts (random flax trees) saved by name
    as ``train_image`` saves them, and the script's closures over them."""
    out = str(tmp_path_factory.mktemp("mnist"))
    jcfg = jconfig.get_config("mnist_image", IMG_OV)
    jmodel = C.build_model(jcfg)
    trees = [convert.init_params(builders.build_model(
        config.get_config("mnist_image", IMG_OV)), seed=60 + i)
        for i in range(2)]
    mgr = CheckpointManager(out, "mnist_image")
    for name, t in zip(("expert_a", "expert_b"), trees):
        mgr.save(name, {"params": convert.unet_torch_layout(
            convert.from_flax(t)), "step": 0})
    jtrees = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    return out, jcfg, jmodel, jtrees


def _jax_sample_image(jcfg, jmodel, params, sampler, eta, corrector_steps):
    """scripts/sample_image.py's computation; returns (samples, x_init,
    replayed draws: E-M's noise or DDIM's rng)."""
    key = jax.random.PRNGKey(42)
    schedule = C.build_schedule(jcfg)
    shape = (BS, HW, HW, 1)
    x_init = jax.random.normal(key, shape)

    def eps_fn(x, t):
        return jmodel.apply(params, x, t)
    noise = None
    if sampler == "em":
        out = jsamplers.euler_maruyama(eps_fn, schedule, key, x_init, N, 1.0)
        noise, k = [], key
        for _ in range(N):
            k, sub = jax.random.split(k)
            noise.append(np.asarray(jax.random.normal(sub, shape)))
        noise = torch.from_numpy(np.stack(noise))
    elif sampler == "ode":
        out = jsamplers.prob_flow_ode(
            lambda x, t: -eps_fn(x, t) / schedule.sigma(t), schedule, x_init,
            N)
    elif sampler == "picard":
        out, _ = jsamplers.parallel_prob_flow(
            lambda x, t: -eps_fn(x, t) / schedule.sigma(t).reshape(
                (-1,) + (1,) * (x.ndim - 1)), schedule, x_init, N,
            n_iters=15)
    elif sampler == "dpmpp":
        out = jsamplers.dpm_solver_pp_2m(eps_fn, schedule, x_init, N)
    else:
        k1 = jax.random.fold_in(key, 1)
        out = jsamplers.ddim(eps_fn, schedule, x_init, N, eta=eta,
                             key=k1 if eta or corrector_steps else None,
                             corrector_steps=corrector_steps)
        replay = []  # the corrector's gate (t <= 1) passes every step
        for i in range(N):
            if eta:
                replay.append(np.asarray(jax.random.normal(
                    jax.random.fold_in(k1, i), shape)))
            if corrector_steps:
                replay += [np.asarray(jax.random.normal(jax.random.fold_in(
                    k1, N + 1 + i * corrector_steps + j), shape))
                    for j in range(corrector_steps)]
        noise = Replay(replay)
    return np.asarray(out), np.array(x_init), noise


@pytest.mark.parametrize("sampler,eta,corrector", [
    ("em", 0.0, 0), ("ode", 0.0, 0), ("picard", 0.0, 0), ("dpmpp", 0.0, 0),
    ("ddim", 0.0, 0), ("ddim", 0.7, 1)])
def test_sample_image_matches_the_script(mnist_experts, sampler, eta,
                                         corrector):
    out, jcfg, jmodel, jtrees = mnist_experts
    ref, x_init, draws = _jax_sample_image(jcfg, jmodel, jtrees[0], sampler,
                                           eta, corrector)
    kw = dict(noise=draws) if sampler == "em" else (
        dict(key=draws) if draws is not None else {})
    got = entry.sample_image("mnist_image", "expert_a", sampler=sampler,
                             eta=eta, corrector_steps=corrector, out=out,
                             overrides=IMG_OV, x_init=x_init, device="cpu",
                             **kw)
    _close(got, ref, TOL)
    if isinstance(draws, Replay):
        assert not draws.queue
    _, _, pixels = _read_png(Path(out, "mnist_image", "run_0", "results",
                                  "expert_a_samples.png"))
    np.testing.assert_array_equal(pixels, viz._to_numpy_grid(got.numpy(),
                                                              8))


def test_sample_image_refusals(mnist_experts, tmp_path):
    """A v-predicting preset samples through DDIM only; a conditional
    preset's model refuses the unconditional sampler's call (the JAX UNet
    asserts there)."""
    out = mnist_experts[0]
    with pytest.raises(ValueError, match="ddim only"):
        entry.sample_image("mnist_image", "expert_a", sampler="em", out=out,
                           overrides=IMG_OV + ["--train.predict=v"],
                           device="cpu")
    ov = ["--model.base_dim=8", "--data.img_size=8",
          "--sample.batch_size=2", "--sample.n_steps=2"]
    cfg = config.get_config("shapes_ddim", ov)
    tree = convert.init_params(builders.build_model(cfg), seed=1)
    CheckpointManager(str(tmp_path), cfg.name).save(
        "s", {"params": convert.from_flax(tree), "step": 0})
    with pytest.raises(ValueError, match="label slots"):
        entry.sample_image("shapes_ddim", "s", out=str(tmp_path),
                           overrides=ov, device="cpu")
    with pytest.raises(AssertionError, match="label slots"):
        C.build_model(jconfig.get_config("shapes_ddim", ov)).apply(
            jax.tree_util.tree_map(jnp.asarray, tree),
            jnp.zeros((2, 8, 8, 3)), jnp.ones((2,)))


@pytest.mark.parametrize("sampler,corrector,weights,fused_blend", [
    ("em", 0, None, True), ("em", 0, (0.3, 1.2), False),
    ("ddim", 1, None, True), ("dpmpp", 0, (2.0, 1.0), True)])
def test_compose_scores_matches_the_script(mnist_experts, sampler,
                                           corrector, weights, fused_blend,
                                           monkeypatch):
    """The weighted blend of two experts, on ``blend_eps``'s wrapper (its
    plain version on the CPU) or ``compose.weighted``, under each
    sampler."""
    out, jcfg, jmodel, jtrees = mnist_experts
    key = jax.random.PRNGKey(42)
    schedule = C.build_schedule(jcfg)
    stack = jexperts.ExpertStack(jmodel.apply, jtrees)
    w = jnp.asarray(weights if weights else [1.0, 1.0])
    from composable_diffusion_models_tpu import compose as jcompose

    def eps_fn(x, t):
        return jcompose.weighted(stack(x, t), w)
    shape = (BS, HW, HW, 1)
    x_init = jax.random.normal(key, shape)
    kw = {}
    if sampler == "dpmpp":
        ref = jsamplers.dpm_solver_pp_2m(eps_fn, schedule, x_init, N)
    elif sampler == "ddim":
        k1 = jax.random.fold_in(key, 1)
        ref = jsamplers.ddim(eps_fn, schedule, x_init, N, key=k1,
                             corrector_steps=corrector)
        kw["key"] = Replay([np.asarray(jax.random.normal(
            jax.random.fold_in(k1, N + 1 + i), shape)) for i in range(N)])
    else:
        ref = jsamplers.euler_maruyama(eps_fn, schedule, key, x_init, N, 1.0)
        noise, k = [], key
        for _ in range(N):
            k, sub = jax.random.split(k)
            noise.append(np.asarray(jax.random.normal(sub, shape)))
        kw["noise"] = torch.from_numpy(np.stack(noise))
    calls = []
    monkeypatch.setattr(entry, "blend_eps", lambda s, w_: calls.append(1)
                        or kernels.blend_eps(s, w_))
    got = entry.compose_scores("mnist_image", ["expert_a", "expert_b"],
                               weights=weights, sampler=sampler,
                               corrector_steps=corrector, out=out,
                               overrides=IMG_OV, fused_blend=fused_blend,
                               x_init=np.array(x_init), device="cpu", **kw)
    _close(got, np.asarray(ref), TOL)
    forwards = N * (1 + corrector) if sampler == "ddim" else N
    assert len(calls) == (forwards if fused_blend else 0)
    assert Path(out, "mnist_image", "run_0", "results",
                "composed_expert_a_expert_b.png").exists()
    with pytest.raises(ValueError, match="sampler"):
        entry.compose_scores("mnist_image", sampler="ode", out=out,
                             device="cpu")


def test_superdiff_on_experts_loaded_by_name(guided_run):
    """``scripts/superdiff.py``'s loading: the trained expert (and its
    init) read back by name from ``train_image``'s checkpoints, two
    experts with per-expert (digit, color) labels, SUPERDIFF OR through
    ``entry.sample_superdiff`` at 12 timesteps against the script's stack
    on the same trees, the JAX draws replayed."""
    from composable_diffusion_models_tpu.schedules import \
        DDPMSchedule as JaxDDPM
    r = guided_run
    CheckpointManager(r["out"], "colored_mnist_guided").save(
        "guided_init", {"params": convert.from_flax(r["init"]), "step": 0})
    trees = entry.load_named("colored_mnist_guided",
                             ["guided_a", "guided_init"], r["out"],
                             GUIDED_OV, device="cpu")
    jtrees = [r["ref_params"], jax.tree_util.tree_map(jnp.asarray,
                                                      r["init"])]
    model = builders.build_model(config.get_config("colored_mnist_guided",
                                                   GUIDED_OV))
    jmodel = C.build_model(jconfig.get_config("colored_mnist_guided",
                                              GUIDED_OV))
    labels = np.array([[4, 10], [7, 3]], np.int32)
    b, t_small = 2, 12
    key = jax.random.PRNGKey(42)
    stack = jexperts.ExpertStack(jmodel.apply, jtrees)
    lab = jnp.asarray(labels)
    label_args = [jexperts.per_expert(jnp.broadcast_to(lab[:, s:s + 1],
                                                       (2, b)))
                  for s in range(2)]
    x = jax.random.normal(key, (b, 28, 28, 3))
    ref = jsamplers.superdiff(
        lambda x_, ti: stack(x_, ti.astype(jnp.float32), *label_args),
        JaxDDPM(num_timesteps=t_small), key, x, operation="OR")

    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.normal(sub, (b, 28, 28, 3))
    noise = np.array(jax.lax.scan(body, key, None, length=t_small)[1])
    got = entry.sample_superdiff(trees, np.array(x), labels,
                                 operation="OR", num_timesteps=t_small,
                                 noise=torch.from_numpy(noise),
                                 device="cpu", model=model)
    _close(got, np.asarray(ref), 1e-4)


def test_config_paths_default_to_cuda(monkeypatch):
    """Without a card, every new entry point raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: entry.train_image(sanity=True),
                 lambda: entry.sample_image(),
                 lambda: entry.compose_scores(),
                 lambda: entry.load_named("mnist_image", ["a"]),
                 lambda: entry.train_vae(sanity=True),
                 lambda: entry.compose_latent_vae()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
