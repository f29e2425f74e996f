"""Port parity for ``entry.compose_cfg`` (``scripts/compose_cfg.py``) and
``entry.compose_cifar`` (``scripts/compose_cifar.py``):

* ``compose_cfg`` on narrow random experts saved by name through the
  port's ``CheckpointManager``: the ``colored_mnist_guided`` preset
  (ancestral DDPM) and ``ito_cross_attention`` (DDIM, Euler-Maruyama; the
  cross-attention through ``flash_attention``'s plain version), each
  against the script's computation written with the JAX package on the
  same trees, the initial noise and the sampler's draws replayed; the grid
  read back from its PNG;
* ``compose_cifar`` at the script's ``--sanity`` sizes end to end (the
  stand-in through the binary batches, the probe, two experts trained, the
  three sets, the files), and its sampling against the script's jobs on
  given trees and a given float32 probe, every draw replayed: each set's
  class histogram and split share exactly, the mean top probability to
  1e-5, the grids to one level of 255;
* both entry points raising without a card before writing anything.

float32 throughout: the samplers' outputs to 1e-5 of their scale (a
narrow UNet agrees to ~1e-6 a forward). The JAX UNet runs XLA's GroupNorm
and attention, the port the kernels' plain versions on CPU tensors.
"""

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

from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import eval as jeval
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.schedules import DDPMSchedule as JaxDDPM
from composable_diffusion_models_tpu.utils import config as jconfig
from composable_diffusion_models_tpu_torch import (builders, convert, data,
                                                   entry, train)
from composable_diffusion_models_tpu_torch import eval as ceval
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.models.probe import ProbeClassifier
from composable_diffusion_models_tpu_torch.models.unet import UNet
from composable_diffusion_models_tpu_torch.rng import Replay, fold_in
from composable_diffusion_models_tpu_torch.utils import config, viz

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _load(name):
    """A script's module (or ``scripts/_common.py``), from its file."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return mod


C = _load("_common")


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


def _read_png(path):
    """The pixels of an 8-bit RGB PNG with filter-0 rows, by zlib."""
    data_ = Path(path).read_bytes()
    pos, chunks = 8, {}
    while pos < len(data_):
        n, = struct.unpack(">I", data_[pos:pos + 4])
        kind, body = data_[pos + 4:pos + 8], data_[pos + 8:pos + 8 + n]
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    return raw.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def _split_draws(key, n, shape):
    """A JAX scan sampler's normals: it splits its carried key before each
    step's draw."""
    out, k = [], key
    for _ in range(n):
        k, sub = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return np.stack(out)


# ---------------------------------------------------------- compose_cfg
HW, BS, N, T = 8, 3, 4, 6
CASES = {  # preset -> (overrides, digit, color)
    "colored_mnist_guided": (["--model.base_dim=8", f"--data.img_size={HW}",
                              f"--sample.batch_size={BS}",
                              f"--schedule.num_timesteps={T}"], 3, 6),
    "ito_cross_attention": (["--model.base_dim=8", f"--data.img_size={HW}",
                             f"--sample.batch_size={BS}",
                             f"--sample.n_steps={N}"], 7, 1),
}


@pytest.fixture(scope="module")
def cfg_experts(tmp_path_factory):
    """One narrow random expert per preset, saved by name as
    ``train_image`` saves it; the flax trees for the script's side."""
    out = str(tmp_path_factory.mktemp("cfg"))
    trees = {}
    for i, (preset, (ov, _, _)) in enumerate(CASES.items()):
        cfg = config.get_config(preset, ov)
        tree = convert.init_params(builders.build_model(cfg), seed=70 + i)
        CheckpointManager(out, cfg.name).save("expert", {
            "params": convert.unet_torch_layout(convert.from_flax(tree)),
            "step": 0})
        trees[preset] = jax.tree_util.tree_map(jnp.asarray, tree)
    return out, trees


def _jax_compose_cfg(preset, params, sampler, guidance=(2.0, 2.0)):
    """scripts/compose_cfg.py's computation; returns (samples, x_init, the
    sampler's draws or None)."""
    ov, digit, color = CASES[preset]
    jcfg = jconfig.get_config(preset, ov)
    jmodel, schedule = C.build_model(jcfg), C.build_schedule(jcfg)
    n1, n2 = jcfg.model.num_classes
    eps_fn = jsamplers.make_cfg_eps_fn(
        lambda x, t, *labs: jmodel.apply(params, x, t, *labs),
        [(jnp.asarray(digit), jnp.asarray(n2)),
         (jnp.asarray(n1), jnp.asarray(color))],
        (jnp.asarray(n1), jnp.asarray(n2)), jnp.asarray(guidance))
    key = jax.random.PRNGKey(42)
    shape = (BS, HW, HW, 3)
    x_init = jax.random.normal(key, shape)
    if jcfg.schedule.family == "vp":
        if sampler == "em":
            out = jsamplers.euler_maruyama(eps_fn, schedule, key, x_init, N)
            return out, x_init, _split_draws(key, N, shape)
        return jsamplers.ddim(eps_fn, schedule, x_init, N), x_init, None
    out = jsamplers.ddpm_ancestral(
        lambda x, ti: eps_fn(x, ti.astype(jnp.float32)), schedule, key,
        x_init)
    return out, x_init, _split_draws(key, T, shape)


@pytest.mark.parametrize("preset,sampler", [
    ("colored_mnist_guided", "ddim"), ("ito_cross_attention", "ddim"),
    ("ito_cross_attention", "em")])
def test_compose_cfg_matches_the_script(cfg_experts, preset, sampler):
    """A ddpm preset samples ancestrally whatever ``sampler`` says, as the
    script does; the PNG holds the grid of the samples."""
    out, trees = cfg_experts
    ref, x_init, noise = _jax_compose_cfg(preset, trees[preset], sampler)
    ov, digit, color = CASES[preset]
    got = entry.compose_cfg(
        preset, "expert", digit=digit, color=color, sampler=sampler,
        out=out, overrides=ov, x_init=np.array(x_init),
        noise=None if noise is None else torch.from_numpy(noise),
        device="cpu")
    _close(got, ref, TOL)
    png = Path(out, preset, "run_0", "results", f"cfg_d{digit}_c{color}.png")
    np.testing.assert_array_equal(_read_png(png),
                                  viz._to_numpy_grid(got.numpy(), 8))


def test_compose_cfg_kernel_switches_and_refusals(cfg_experts, monkeypatch):
    """``fused_gn`` / ``flash_attn`` False give the same samples on the
    CPU (the kernels' plain versions are the PyTorch-op paths' numbers to
    float32's order); the cross-attention reaches ``flash_attention`` only
    on a preset that has it; an unknown sampler raises."""
    out, _ = cfg_experts
    from composable_diffusion_models_tpu_torch.models import unet
    calls = []
    orig = unet.flash_attention
    monkeypatch.setattr(unet, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    for preset in CASES:
        ov, digit, color = CASES[preset]
        kw = dict(digit=digit, color=color, out=out, overrides=ov,
                  device="cpu")
        calls.clear()
        a = entry.compose_cfg(preset, "expert", **kw)
        assert bool(calls) == (preset == "ito_cross_attention")
        calls.clear()
        b = entry.compose_cfg(preset, "expert", fused_gn=False,
                              flash_attn=False, **kw)
        assert not calls
        _close(b, a, TOL)
    with pytest.raises(ValueError, match="sampler"):
        entry.compose_cfg("ito_cross_attention", "expert", sampler="ode",
                          out=out, device="cpu")


# --------------------------------------------------------- compose_cifar
def test_compose_cifar_runs_at_sanity_sizes(tmp_path, monkeypatch):
    """The whole script at its --sanity sizes on the CPU: the stand-in
    written as five binary batches and read back, the probe, two experts
    trained with the script's keys on the two class splits, the three
    sets, the report written as returned, the four grids."""
    keys = []
    orig = train.train_expert

    def record(key, apply_fn, p0, schedule, imgs, *a, **kw):
        keys.append((key, imgs.shape[0], kw["steps"], kw["batch_size"]))
        return orig(key, apply_fn, p0, schedule, imgs, *a, **kw)
    monkeypatch.setattr(train, "train_expert", record)
    rep = entry.compose_cifar(sanity=True, device="cpu", out=str(tmp_path))
    assert keys == [(fold_in(0, 20), 160, 40, 16),
                    (fold_in(0, 21), 160, 40, 16)]
    assert sorted(p.name for p in (tmp_path / "cifar-10-batches-bin")
                  .iterdir()) == [f"data_batch_{i}.bin" for i in range(1, 6)]
    path = tmp_path / "cifar_split_composition.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
    assert rep["dataset"].startswith("procedural stand-in")
    assert (rep["T"], rep["train_steps"]) == (8, 40)
    assert rep["splits"] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
    assert set(rep["sets"]) == {"solo_A", "solo_B", "superdiff_OR"}
    for row in rep["sets"].values():
        assert sum(row["class_hist"]) == pytest.approx(1.0, abs=1e-3)
        assert 0.0 <= row["frac_split_a"] <= 1.0
    assert rep["or_mixture_balance_error"] == abs(
        0.5 - rep["sets"]["superdiff_OR"]["frac_split_a"])
    for name in ("solo_A", "solo_B", "superdiff_OR"):
        assert _read_png(tmp_path / f"cifar_{name}.png").shape == \
            viz._to_numpy_grid(np.zeros((8, 32, 32, 3)), 8).shape
    assert _read_png(tmp_path / "cifar_comparison.png").shape == \
        viz._to_numpy_grid(np.zeros((24, 32, 32, 3)), 16).shape


def test_compose_cifar_matches_the_script(tmp_path, monkeypatch):
    """The script's jobs (``compose_cifar.py:121-150``) at its sanity sizes
    on the same expert trees and the same float32 probe, the stand-in and
    every sampling draw replayed (all three jobs are keyed fold_in(key,
    50), as in the script)."""
    script = _load("compose_cifar")
    key, n, T_, bs = jax.random.PRNGKey(0), 320, 8, 8
    raw, lab = jdata.synthetic_cifar10(jax.random.fold_in(key, 1), n)
    monkeypatch.setattr(data, "synthetic_cifar10", lambda k, n_, device:
                        (torch.from_numpy(np.array(raw)).to(device),
                         torch.from_numpy(np.array(lab)).long().to(device)))
    probe = ProbeClassifier((10,), 32, None, in_channels=3)
    ptree = convert.init_params(probe, seed=3)
    monkeypatch.setattr(ceval, "train_probe", lambda *a, **k: (
        probe, convert.from_flax(ptree)))
    model = UNet(in_channels=3, base_dim=8, channel_mults=(1, 2, 4))
    trees = [convert.init_params(model, seed=4 + i) for i in range(2)]

    jmodel = JaxUNet(in_channels=3, base_dim=8, channel_mults=(1, 2, 4))
    jp = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    jprobe = jeval.ProbeClassifier((10,), 32, None)
    jpp = jax.tree_util.tree_map(jnp.asarray, ptree)
    schedule = JaxDDPM(num_timesteps=T_)
    shape = (bs, 32, 32, 3)
    k50 = jax.random.fold_in(key, 50)
    x0 = jax.random.normal(jax.random.fold_in(k50, 1), shape)

    def stack_fn(x, ti):
        t = ti.astype(jnp.float32)
        return jnp.stack([jmodel.apply(p, x, t) for p in jp])
    refs = {"solo_A": jsamplers.ddpm_ancestral(
                lambda x, t: jmodel.apply(jp[0], x, t), schedule, k50, x0),
            "solo_B": jsamplers.ddpm_ancestral(
                lambda x, t: jmodel.apply(jp[1], x, t), schedule, k50, x0),
            "superdiff_OR": jsamplers.superdiff(
                stack_fn, schedule, k50, x0, operation="OR", temp=1.0)}
    draws = [np.array(x0), _split_draws(k50, T_, shape)] * 3
    replay = Replay(draws)
    rep = entry.compose_cifar(
        sanity=True, device="cpu", out=str(tmp_path), key=replay,
        experts=[convert.from_flax(t) for t in trees])
    assert not replay.queue
    for name, ref in refs.items():
        ref = jnp.clip(ref, -1, 1)
        want = script.probe_stats(jprobe, jpp, ref)
        got = rep["sets"][name]
        assert got["class_hist"] == want["class_hist"], name
        assert got["frac_split_a"] == want["frac_split_a"], name
        assert got["mean_max_prob"] == pytest.approx(want["mean_max_prob"],
                                                     abs=1e-5)
        pixels = _read_png(tmp_path / f"cifar_{name}.png").astype(int)
        grid = viz._to_numpy_grid(np.asarray(ref), 8).astype(int)
        assert np.abs(pixels - grid).max() <= 1, name


def test_compose_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """device=None means the card: without one they raise before writing
    anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.compose_cfg(out=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.compose_cifar(sanity=True, out=str(tmp_path / "cifar"))
    assert not any(tmp_path.iterdir())
