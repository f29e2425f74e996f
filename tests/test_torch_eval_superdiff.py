"""Port parity for ``eval_superdiff`` (``scripts/eval_superdiff.py``) and
``utils.summarize`` (``scripts/summarize_evals.py``):

* the mixture protocol on narrow unconditional experts (base 8, 28 x 28,
  T 8) with its probe and experts given, against the script's jobs and
  rows written out with the JAX package on the same trees, every draw
  replayed: each job's samples, the per-class histogram, the half
  balance, the OR temperature tokens; its cache and resume;
* the factored protocol on narrow conditional experts at 64 x 64 shapes:
  every combination's scores under the rigorous AND and OR;
* ``summarize_evals``' table text against the script's on the same report
  files (written in ``tmp_path``).

The JAX UNet runs XLA's GroupNorm (``use_pallas=False``), the port the
kernel's plain version on CPU tensors (``fused_gn=True``). The scripts'
probes compute in bfloat16; here both sides' probes compute in float32, so
that the histograms compare argmax for argmax (a bfloat16 rounding can
flip a near tie).
"""

import json
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import eval as jeval
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JaxUNet
from composable_diffusion_models_tpu.schedules import DDPMSchedule as JaxDDPM
from composable_diffusion_models_tpu_torch import convert, train
from composable_diffusion_models_tpu_torch import eval_superdiff as es
from composable_diffusion_models_tpu_torch.models.probe import ProbeClassifier
from composable_diffusion_models_tpu_torch.models.unet import UNet
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.utils import summarize

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
T, BASE = 8, 8


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _close(got, ref, tol):
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


def _ddpm_draws(key, n, shape, per_step=1):
    """A JAX DDPM sampler's normals: it splits its carried key before each
    draw, ``per_step`` times a step."""
    def body(k, _):
        zs = []
        for _ in range(per_step):
            k, sub = jax.random.split(k)
            zs.append(jax.random.normal(sub, shape, jnp.float32))
        return k, zs[0] if per_step == 1 else jnp.stack(zs)
    return _np(jax.lax.scan(body, key, None, length=n)[1])


def _job_draws(k, shape, per_step):
    """The port's order for one job of key ``k``: the initial noise
    (``fold_in(k, 1)``), then the sampler's (T, ...) draws from ``k``."""
    return [_np(jax.random.normal(jax.random.fold_in(k, 1), shape)),
            _ddpm_draws(k, T, shape, per_step)]


def _float32_probe(monkeypatch):
    """The protocol's probe computing in float32 (see the module's
    docstring)."""
    monkeypatch.setattr(es, "ProbeClassifier",
                        lambda n, base, dtype, **kw: ProbeClassifier(
                            n, base, None, **kw))


def _jax_unet(num_classes=()):
    return JaxUNet(in_channels=3, base_dim=BASE, channel_mults=(1, 2, 4),
                   num_classes=num_classes, use_pallas=False)


@pytest.fixture(scope="module")
def mixture_trees():
    model = UNet(in_channels=3, base_dim=BASE, channel_mults=(1, 2, 4))
    probe = ProbeClassifier((10,), 32, None, in_channels=3)
    return {"probe": convert.init_params(probe, seed=3),
            "expert0": convert.init_params(model, seed=4),
            "expert1": convert.init_params(model, seed=5)}


def _port_trees(trees):
    return {k: (convert.from_flax(v) if k == "probe" else
                convert.unet_torch_layout(convert.from_flax(v)))
            for k, v in trees.items()}


def test_mixture_matches_the_script(tmp_path, monkeypatch, mixture_trees):
    """The script's mixture jobs (``eval_superdiff.py:123-196``) with
    ``--temp_sweep 1,1/d,1/dT``, 8 samples, T 8, on the same trees: each
    job's clipped samples to 1e-4 of the scale (measured ~1e-6), the
    histogram and the first half's share exactly, the mean top
    probability to 1e-5; the report's layout as the script writes it."""
    _float32_probe(monkeypatch)
    key, bs, d = jax.random.PRNGKey(0), 8, 28 * 28 * 3
    jm = _jax_unet()
    jt = {k: jax.tree_util.tree_map(jnp.asarray, v)
          for k, v in mixture_trees.items()}
    schedule = JaxDDPM(num_timesteps=T)

    def eps_stack_fn(x, ti):
        t = ti.astype(jnp.float32)
        return jnp.stack([jm.apply(jt["expert0"], x, t),
                          jm.apply(jt["expert1"], x, t)])

    shape = (bs, 28, 28, 3)
    temps = [1.0, 1.0 / d, 1.0 / (d * T)]
    jobs = [(f"OR_temp{t:g}", lambda k, t=t: jsamplers.superdiff(
        eps_stack_fn, schedule, k, jax.random.normal(jax.random.fold_in(
            k, 1), shape), operation="OR", temp=t)) for t in temps]
    jobs += [("AND_heuristic", lambda k: jsamplers.superdiff(
        eps_stack_fn, schedule, k, jax.random.normal(jax.random.fold_in(
            k, 1), shape), operation="AND")),
        ("AND_rigorous", lambda k: jsamplers.superdiff_and_solve(
            eps_stack_fn, schedule, k, jax.random.normal(
                jax.random.fold_in(k, 1), shape), mode="AND"))]
    jprobe = jeval.ProbeClassifier((10,), 32, None)
    k50 = jax.random.fold_in(key, 50)
    ref_rows, ref_samples = {}, {}
    for name, fn in jobs:
        samples = jnp.clip(jax.jit(fn)(k50), -1, 1)
        logits = jeval._jitted_apply(jprobe)(jt["probe"], samples)[0]
        probs = jax.nn.softmax(logits, axis=-1)
        preds = jnp.argmax(probs, axis=-1)
        hist = jnp.bincount(preds, length=10) / bs
        frac_a = float(jnp.mean(preds < 5))
        ref_rows[name] = {"class_hist": [round(float(h), 4) for h in hist],
                          "frac_expert_a": frac_a,
                          "mixture_balance_error": abs(0.5 - frac_a),
                          "mean_max_prob": float(jnp.mean(jnp.max(probs,
                                                                  -1)))}
        ref_samples[name] = samples
    draws = _synthetic_draws(jax.random.split(jax.random.fold_in(key, 1))[0],
                             256, 10)
    for name, _ in jobs:
        draws += _job_draws(k50, shape, 2 if name == "AND_rigorous" else 1)
    replay = Replay(draws)
    got_samples = []
    orig = es.mixture_row

    def record(probe, params, samples):
        got_samples.append(samples)
        return orig(probe, params, samples)
    monkeypatch.setattr(es, "mixture_row", record)
    # the trees given through the protocol's cache, by the script's tags
    tags = {"probe": "mixture_probe_p40_n256_seed0",
            "expert0": "mixture_expert0_s40_b16_w8_n256_seed0",
            "expert1": "mixture_expert1_s40_b16_w8_n256_seed0"}
    for name, tree in _port_trees(mixture_trees).items():
        torch.save(tree, tmp_path / f"cache_{tags[name]}.pt")
    rep = es.eval_superdiff(sanity=True, temp_sweep="1, 1/d,1/dT",
                            out=str(tmp_path), key=replay, device="cpu")
    assert not replay.queue
    assert list(rep["ops"]) == [n for n, _ in jobs]
    assert {k: v for k, v in rep.items() if k != "ops"} == {
        "protocol": "mixture", "subsets": [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]],
        "T": T, "train_steps": 40, "dim": d}
    for (name, _), samples in zip(jobs, got_samples):
        _close(samples, ref_samples[name], 1e-4)
        row, ref = rep["ops"][name], ref_rows[name]
        assert row["class_hist"] == ref["class_hist"], name
        assert row["frac_expert_a"] == ref["frac_expert_a"]
        assert row["mixture_balance_error"] == ref["mixture_balance_error"]
        assert row["mean_max_prob"] == pytest.approx(ref["mean_max_prob"],
                                                     abs=1e-5)
    with open(tmp_path / "superdiff_mixture_colored_mnist.json") as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert (tmp_path / "mixture_AND_rigorous.png").exists()


def test_mixture_caches_and_resumes(tmp_path, monkeypatch):
    """Trained once (probe and experts cached as ``cache_<tag>.pt``); run
    again, every job is read from the ``.partial.json`` and nothing is
    trained or sampled."""
    kw = dict(train_steps=2, T=3, n_samples=2, data_n=32, base_dim=8,
              batch_size=4, probe_steps=2, out=str(tmp_path), device="cpu")
    monkeypatch.setattr(es, "MIXTURE_SUBSETS", ((0, 1), (5, 6)))
    rep = es.eval_superdiff(**kw)
    names = sorted(p.name for p in tmp_path.glob("cache_*.pt"))
    assert [n.split("_")[1] for n in names] == ["mixture"] * 3
    assert set(rep["ops"]) == {"OR", "AND_heuristic", "AND_rigorous"}

    def boom(*a, **k):
        raise AssertionError("trained or sampled again")
    monkeypatch.setattr(train, "train_expert", boom)
    monkeypatch.setattr(es, "mixture_row", boom)
    rep2 = es.eval_superdiff(**kw)
    assert rep2 == rep


def test_factored_matches_the_script(tmp_path, monkeypatch):
    """The script's factored protocol (``eval_superdiff.py:199-282``) on
    64 x 64 shapes, holdout (2, 2), 4 samples a combination, T 8, the
    probe and both conditional experts given: every combination's scores
    under the rigorous AND and OR (the accuracies exactly, the margins to
    1e-5) and the held-out and seen joint accuracies."""
    _float32_probe(monkeypatch)
    n_classes, bs, key = (3, 3), 4, jax.random.PRNGKey(0)
    models = [UNet(in_channels=3, base_dim=BASE, channel_mults=(1, 2, 4),
                   num_classes=(n,)) for n in n_classes]
    probe = ProbeClassifier(n_classes, 32, None, in_channels=3)
    trees = {"probe": convert.init_params(probe, seed=6),
             "expert0": convert.init_params(models[0], seed=7),
             "expert1": convert.init_params(models[1], seed=8)}
    jt = {k: jax.tree_util.tree_map(jnp.asarray, v) for k, v in
          trees.items()}
    m0, m1 = (_jax_unet((n,)) for n in n_classes)
    schedule = JaxDDPM(num_timesteps=T)
    jprobe = jeval.ProbeClassifier(n_classes, 32, None)
    shape = (bs, 64, 64, 3)

    @jax.jit
    def sample_and(l0, l1, k):
        def eps_stack_fn(x, ti):
            t = ti.astype(jnp.float32)
            return jnp.stack([m0.apply(jt["expert0"], x, t, l0),
                              m1.apply(jt["expert1"], x, t, l1)])
        x_init = jax.random.normal(jax.random.fold_in(k, 1), shape)
        return (jsamplers.superdiff_and_solve(eps_stack_fn, schedule, k,
                                              x_init, mode="AND"),
                jsamplers.superdiff(eps_stack_fn, schedule, k, x_init,
                                    operation="OR", temp=1.0))

    ref, draws = {"AND": {}, "OR": {}}, {"AND": [], "OR": []}
    for f0 in range(3):
        for f1 in range(3):
            k = jax.random.fold_in(key, 100 + f0 * 3 + f1)
            out = sample_and(jnp.full((bs,), f0, jnp.int32),
                             jnp.full((bs,), f1, jnp.int32), k)
            for mode, samples in zip(("AND", "OR"), out):
                scores = jeval.compositional_scores(
                    jprobe, jt["probe"], jnp.clip(samples, -1, 1), (f0, f1))
                scores["held_out"] = (f0, f1) in [(2, 2)]
                ref[mode][f"{f0},{f1}"] = scores
                draws[mode] += _job_draws(k, shape, 2 if mode == "AND"
                                          else 1)
    replay = Replay(draws["AND"] + draws["OR"])
    # the probe and the experts given in place of their training
    given = _port_trees(trees)
    monkeypatch.setattr(es.ceval, "train_probe",
                        lambda *a, **k: (None, given["probe"]))
    experts = iter((given["expert0"], given["expert1"]))
    monkeypatch.setattr(es, "train_one", lambda *a, **k: next(experts))
    rep = es.eval_superdiff(protocol="factored", sanity=True,
                            out=str(tmp_path), key=replay, device="cpu")
    assert not replay.queue
    assert rep["holdout"] == [[2, 2]] and rep["dataset"] == "shapes"
    for mode in ("AND", "OR"):
        got = rep["ops"][mode]
        for combo, r in ref[mode].items():
            g = got["combos"][combo]
            assert g.keys() == r.keys()
            for k_, v in r.items():
                if k_.endswith("acc") or k_ == "held_out":
                    assert g[k_] == v, (mode, combo, k_)
                else:
                    assert g[k_] == pytest.approx(v, abs=1e-5)
        held = ref[mode]["2,2"]["joint_acc"]
        seen = [v["joint_acc"] for c, v in ref[mode].items() if c != "2,2"]
        assert got["heldout_joint_acc"] == held
        assert got["seen_joint_acc"] == pytest.approx(sum(seen) / 8)
    assert (tmp_path / "superdiff_factored_shapes.json").exists()


def test_sanity_cuts_and_refusals(tmp_path, monkeypatch):
    """``sanity=True`` makes the script's cuts; an unknown protocol
    raises; without a card the entry point raises and writes nothing."""
    seen = {}

    def run_mixture(key, **kw):
        seen.update(kw)
        return {}
    monkeypatch.setattr(es, "run_mixture", run_mixture)
    es.eval_superdiff(sanity=True, out=str(tmp_path), device="cpu")
    assert {k: seen[k] for k in ("train_steps", "probe_steps", "T",
                                 "n_samples", "data_n", "base_dim",
                                 "batch_size")} == {
        "train_steps": 40, "probe_steps": 40, "T": 8, "n_samples": 8,
        "data_n": 256, "base_dim": 8, "batch_size": 16}
    with pytest.raises(ValueError, match="protocol"):
        es.eval_superdiff(protocol="union", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        es.eval_superdiff(out=str(tmp_path / "none"))
    assert not (tmp_path / "none").exists()
    assert es.parse_temp(" 1/d", 10, 4) == 0.1
    assert es.parse_temp("1/dT", 10, 4) == 1.0 / 40
    assert es.parse_temp("0.5", 10, 4) == 0.5


# -------------------------------------------------------- summarize_evals
def _write_reports(root: Path):
    """Reports of both generations and a sweep, in two runs."""
    a = root / "artifacts" / "run_a"
    b = root / "artifacts" / "run_b"
    a.mkdir(parents=True)
    b.mkdir(parents=True)
    ops = {"avg": {"weights": [1, 1], "heldout_joint_acc": 0.25,
                   "seen_joint_acc": 0.5},
           "cfg_w2x1": {"weights": [2, 1], "heldout_joint_acc": 0.625,
                        "seen_joint_acc": 0.375},
           "ito": {"weights": [1, 1], "seen_joint_acc": 0.125}}
    with open(a / "compositional_eval_shapes_avg-cfg-ito.json", "w") as f:
        json.dump({"dataset": "shapes", "ops": ops}, f)
    with open(a / "compositional_eval.json", "w") as f:
        json.dump({"ops": {"avg": {"heldout_joint_acc": 0.5,
                                   "seen_joint_acc": 0.5}}}, f)
    with open(b / "compositional_sweep_colored_mnist_avg.json", "w") as f:
        json.dump({"dataset": "colored_mnist", "cells": {}, "aggregate": {
            "avg": {"heldout_joint_acc_mean": 0.4,
                    "heldout_joint_acc_min": 0.125,
                    "heldout_joint_acc_max": 0.75,
                    "seen_joint_acc_mean": 0.6, "n_cells": 3}}}, f)
    with open(b / "superdiff_mixture_colored_mnist.json", "w") as f:
        json.dump({"protocol": "mixture", "ops": {}}, f)


@pytest.mark.parametrize("argv", [[], ["--dataset", "shapes"],
                                  ["--top", "2"], ["artifacts/run_b"]])
def test_summarize_matches_the_script(tmp_path, monkeypatch, capsys, argv):
    """The table's text, row for row, against the script's output on the
    same report files (NaN held-out accuracies included)."""
    _write_reports(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["summarize_evals.py"] + argv)
    runpy.run_path(str(ROOT / "scripts" / "summarize_evals.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out
    dirs = [a for a in argv if not a.startswith("--") and not a.isdigit()
            and a != "shapes"]
    got = summarize.summarize_evals(
        dirs or None,
        dataset="shapes" if "--dataset" in argv else None,
        top=2 if "--top" in argv else 0)
    assert capsys.readouterr().out == ref
    assert got + "\n" == ref
    assert len(ref.splitlines()) >= 3
    assert os.path.basename(os.getcwd()) == tmp_path.name
