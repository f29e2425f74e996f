"""The port's command lines (``composable_diffusion_models_tpu_torch.
scripts``) against the JAX package's ``scripts/``, without running either's
work:

* every command line's parser against its script's: the option strings,
  defaults, types, choices, actions and ``nargs`` of every flag, and which
  of ``parse_known_args`` / ``parse_args`` reads the command line (unknown
  arguments passed on as overrides, dropped, or refused). The script's
  parser is caught as its ``main()`` builds it: the two parse methods are
  patched to raise with the parser. The stated exceptions are listed below
  by name, each with its reason;
* the runtime flags: ``--help`` exits 0 without a card; without ``--cpu``
  and without a card every command line exits 3 before any entry point,
  draw, dataset or checkpoint is touched; ``--profile`` writes a trace
  under ``outputs/profile``; ``--debug_nans`` raises ``FloatingPointError``
  on a NaN an expert injects; the plot rule without matplotlib;
* the arguments each command line hands its entry point, with the entry
  point replaced by a recorder (the heavy protocols: ``compose_cifar``,
  ``eval_composition``, ``eval_superdiff``, the two gates, the frontier
  sweep; the same arguments give the same bits, which their own tests
  hold), and the exit codes of the gates, ``eval_nll`` and
  ``sample_image``.

``tests/test_torch_scripts_paths.py`` runs the command lines' work on the
CPU.
"""

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu_torch import (builders, entry,
                                                   eval_composition,
                                                   eval_superdiff, frontier,
                                                   gate, rng)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.scripts import _common

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PKG = "composable_diffusion_models_tpu_torch.scripts"

# the 29 command lines: every script of scripts/
NAMES = ("train_image", "sample_image", "compose_scores", "superdiff",
         "layout_compose", "compose_bbox", "compose_images_ddim",
         "compose_images_ito", "compose_cfg", "compose_cifar", "train_vae",
         "compose_latent_vae", "fit_pca", "train_latent_2d", "sample_latent",
         "latent_shape_experts", "superposition_2d", "eval_nll",
         "eval_composition", "eval_superdiff", "summarize_evals",
         "quality_gate_flagship", "quality_gate_shapes", "frontier_sweep",
         "visualize_forward", "visualize_composition_latent", "profile_dit",
         "profile_unet", "bench_dit_config")

# The stated exceptions to "the script's flags, exactly":
# * the scripts that take no runtime flags get them: every command line of
#   the port takes --cpu, the only way onto the CPU (frontier_sweep runs
#   the gate in this process, on the card unless asked), and
#   summarize_evals accepts them and changes nothing (it is host only);
ADDED_RUNTIME_FLAGS = ("frontier_sweep", "summarize_evals")
# * a default that was a TPU's number is the H100's: the serving MFU that
#   projects the frontier's images/s (0.36 on the TPU; 0.0262 measured on
#   the flagship DiT path on an H100 80GB HBM3 at 700 W), and the bf16
#   peak bench_dit_config's MFU is taken against (195 TFLOP/s on the TPU;
#   the H100's dense 989)
CHANGED_DEFAULTS = {("frontier_sweep", "mfu"): (0.36, 0.0262),
                    ("bench_dit_config", "peak_tflops"): (195.0, 989.0)}
# (frontier_sweep's --timeout keeps its name and default; the port runs
# each cell in its own process, so the flag is accepted and unused.)


def cli(name):
    return importlib.import_module(f"{PKG}.{name}")


def _jax_script(name, monkeypatch):
    """scripts/<name>.py as a module, its ``_common`` importable."""
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    def __init__(self, parser, method):
        super().__init__(method)
        self.parser, self.method = parser, method


def _caught(main, monkeypatch):
    """(parser, parse method) of ``main()``, caught at its parse call."""
    def known(self, args=None, namespace=None):
        raise _Caught(self, "parse_known_args")

    def plain(self, args=None, namespace=None):
        raise _Caught(self, "parse_args")

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_known_args", known)
        m.setattr(argparse.ArgumentParser, "parse_args", plain)
        with pytest.raises(_Caught) as e:
            main()
    return e.value.parser, e.value.method


def _actions(parser):
    """{dest: (option strings, default, type, choices, action, nargs,
    const)} of every action but --help."""
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     None if a.choices is None else tuple(a.choices),
                     type(a).__name__, a.nargs, a.const)
            for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", NAMES)
def test_flags_match_the_script(name, monkeypatch):
    jax_parser, jax_method = _caught(_jax_script(name, monkeypatch).main,
                                     monkeypatch)
    want = _actions(jax_parser)
    if name in ADDED_RUNTIME_FLAGS:
        common = _jax_script("_common", monkeypatch)
        ap = argparse.ArgumentParser()
        common.add_runtime_flags(ap)
        want.update(_actions(ap))
    for (script, dest), (old, new) in CHANGED_DEFAULTS.items():
        if script == name:
            assert want[dest][1] == old
            want[dest] = want[dest][:1] + (new,) + want[dest][2:]
    mod = cli(name)
    got = _actions(mod.build_parser())
    assert got == want
    parser, method = _caught(lambda: mod.main(None), monkeypatch)
    assert _actions(parser) == want and method == jax_method


def test_runtime_flags_match_the_scripts_common(monkeypatch):
    common = _jax_script("_common", monkeypatch)
    a, b = argparse.ArgumentParser(), argparse.ArgumentParser()
    common.add_runtime_flags(a)
    _common.add_runtime_flags(b)
    assert _actions(a) == _actions(b)
    for f in ("build_dataset", "build_model", "build_schedule",
              "init_params"):
        assert getattr(_common, f) is getattr(builders, f)


# ------------------------------------------------------- runtime flags
@pytest.mark.parametrize("name", NAMES)
def test_help_exits_0_without_a_card(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli(name).main(["--help"])
    assert e.value.code == 0
    assert "--cpu" in capsys.readouterr().out


def _forbid_work(monkeypatch):
    """Every entry point, draw, dataset and checkpoint read raises."""
    def touched(*a, **k):
        raise AssertionError("work started without a card")

    for mod in (entry, eval_composition, eval_superdiff, frontier):
        for attr, val in list(vars(mod).items()):
            if callable(val) and getattr(val, "__module__", "") \
                    == mod.__name__ and not isinstance(val, type):
                monkeypatch.setattr(mod, attr, touched)
    monkeypatch.setattr(rng.Draws, "__init__", touched)
    monkeypatch.setattr(builders.data_lib, "get_dataset", touched)
    monkeypatch.setattr(CheckpointManager, "__init__", touched)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if n != "summarize_evals"])
def test_no_card_exits_3_before_any_work(name, monkeypatch, capsys,
                                         tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _forbid_work(monkeypatch)
    with pytest.raises(SystemExit) as e:
        cli(name).main([])
    assert e.value.code == 3
    assert "--cpu" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_summarize_evals_needs_no_card(monkeypatch, tmp_path, capsys):
    """Host only: no card, no --cpu, the table all the same."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = {"dataset": "shapes", "holdout": [[2, 2]], "ops": {"avg": {
        "heldout_joint_acc": 0.25, "seen_joint_acc": 0.5}}}
    (tmp_path / "compositional_eval_shapes_avg.json").write_text(
        json.dumps(report))
    assert cli("summarize_evals").main([str(tmp_path), "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "| shapes |" in out and "0.250" in out
    with pytest.raises(SystemExit) as e:
        cli("summarize_evals").main([str(tmp_path), "--not_a_flag"])
    assert e.value.code == 2


def test_profile_writes_a_trace(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    assert cli("fit_pca").main(["--cpu", "--profile", "--out", "o",
                                "--data.n=40"]) == 0
    trace = tmp_path / "outputs" / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
    assert (tmp_path / "o" / "pca_mean.npy").exists()


@pytest.fixture(scope="module")
def latent(tmp_path_factory):
    """A PCA codec and one 2-D latent expert saved where sample_latent
    reads them (mnist_latent2d: the ScoreMLP of width 256, depth 3)."""
    out = tmp_path_factory.mktemp("latent")
    rs = np.random.default_rng(3)
    np.save(out / "pca_mean.npy", rs.standard_normal(64).astype(np.float32))
    comps = np.linalg.qr(rs.standard_normal((64, 2)))[0].T
    np.save(out / "pca_components.npy", comps.astype(np.float32))
    np.save(out / "pca_explained_variance.npy",
            np.array([2.0, 1.0], np.float32))
    from composable_diffusion_models_tpu_torch import convert
    tree = convert.from_flax(convert.init_params(entry.SHAPES_LATENT_MLP, 5))
    CheckpointManager(str(out), "mnist_latent2d").save(
        "latent_expert", {"params": tree, "step": 0})
    return str(out)


LATENT_ARGS = ["--cpu", "--sample.n_steps=4", "--sample.batch_size=3"]


def test_debug_nans_raises_on_an_injected_nan(latent, monkeypatch):
    from composable_diffusion_models_tpu_torch.models import mlp
    apply = mlp.ScoreMLP.apply

    def poisoned(self, params, t, x):
        return apply(self, params, t, x) * float("nan")

    monkeypatch.setattr(mlp.ScoreMLP, "apply", poisoned)
    main = cli("sample_latent").main
    # without the flag the NaNs are written as they are
    assert main(["--out", latent] + LATENT_ARGS) == 0
    try:
        with pytest.raises(FloatingPointError, match="latents"):
            main(["--out", latent, "--debug_nans"] + LATENT_ARGS)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_plots_are_skipped_without_matplotlib(latent, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    results = Path(latent) / "mnist_latent2d" / "run_0" / "results"
    for f in results.glob("*.png"):
        f.unlink()
    assert cli("sample_latent").main(["--out", latent] + LATENT_ARGS) == 0
    out = capsys.readouterr().out
    assert (f"skipped {results / 'latent_samples.png'}: matplotlib is not "
            "installed") in out
    assert "decoded samples saved to" in out
    assert sorted(f.name for f in results.glob("*.png")) == [
        "latent_decoded.png"]


# ------------------------------------------------ arguments and exit codes
class Recorder:
    """Stands in for an entry point: records each call, returns ``value``
    (or ``value(**kwargs)``)."""

    def __init__(self, value):
        self.value, self.calls = value, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.value(*args, **kwargs) if callable(self.value) \
            else self.value


def _cifar_report(**kw):
    sets = {n: {"class_hist": [0.1] * 10, "frac_split_a": 0.5,
                "mean_max_prob": 0.3}
            for n in ("solo_A", "solo_B", "superdiff_OR")}
    return {"dataset": "procedural stand-in", "sets": sets}


HEAVY = [
    ("compose_cifar", ["--cpu", "--sanity", "--T", "9", "--temp", "0.5",
                       "--data_dir", "d", "--out", "o", "--seed", "3",
                       "--dropped=1"],
     entry, "compose_cifar", _cifar_report, (),
     dict(T=9, train_steps=12000, batch_size=256, lr=2e-4, ema=0.999,
          base_dim=64, temp=0.5, probe_steps=2000, n_samples=64,
          data_n=8192, data_dir="d", sanity=True, out="o", seed=3,
          device="cpu")),
    ("eval_composition",
     ["--cpu", "--op", "avg,cfg", "--holdout", "[[1,2]]", "--weight_grid",
      "[[1,2],[2,1]]", "--t_switch", "0.4", "--factor0_grayscale",
      "--gray_norm", "--sanity", "--model.base_dim=8"],
     eval_composition, "eval_composition", {"ops": {}},
     ("shapes_ddim", "shapes"),
     dict(holdout=[[1, 2]], holdout_sweep=None, samples_per_combo=32,
          probe_steps=1200, probe_noise=0.1, probe_seeds=1, n_steps=200,
          w_shape=1.0, w_color=1.0, weight_grid=[[1, 2], [2, 1]],
          op="avg,cfg", t_switch=0.4, factor0_grayscale=True,
          gray_norm=True, gray_proj="luma", hue_aug=0.0, corrector_steps=0,
          corrector_snr=0.16, corrector_t_max=1.0, uncond_prob=0.1,
          sanity=True, out="outputs", seed=0,
          overrides=["--model.base_dim=8"], device="cpu")),
    ("eval_composition", ["--cpu", "--holdout_sweep", "all"],
     eval_composition, "eval_composition", {}, ("shapes_ddim", "shapes"),
     None),
    ("eval_superdiff",
     ["--cpu", "--protocol", "factored", "--holdout", "[[0,1]]",
      "--temp_sweep", "1/d,2", "--dropped"],
     eval_superdiff, "eval_superdiff", {"rows": [0.5]},
     ("factored", "shapes"),
     dict(holdout=[[0, 1]], T=1000, train_steps=12000, batch_size=256,
          lr=2e-4, ema=0.999, base_dim=64, temp=1.0, temp_sweep="1/d,2",
          probe_steps=2000, n_samples=256, samples_per_combo=64,
          data_n=8192, sanity=False, out="outputs/superdiff_eval", seed=0,
          device="cpu")),
    ("frontier_sweep",
     ["--cpu", "--candidates", "dit_p14_d96_l1_h2", "--budgets", "5,10",
      "--timeout", "1"],
     frontier, "frontier_sweep",
     {"peak_tflops": 989.0, "rows": [
         {"config": "dit_p14_d96_l1_h2", "gflop_per_image": 0.1,
          "best_budget": 5, "verdict": "PASS",
          "projected_images_per_sec": 100}]},
     (["dit_p14_d96_l1_h2"], [5, 10]),
     dict(baseline="artifacts/quality_gate_r4/quality_unet64.json",
          out="outputs/quality_gate_r5", mfu=0.0262, device="cpu")),
]


@pytest.mark.parametrize("name,argv,mod,attr,value,args,kwargs", HEAVY)
def test_heavy_protocols_get_the_scripts_arguments(
        name, argv, mod, attr, value, args, kwargs, monkeypatch, capsys,
        tmp_path):
    monkeypatch.chdir(tmp_path)
    rec = Recorder(value)
    monkeypatch.setattr(mod, attr, rec)
    assert cli(name).main(argv) == 0
    (got_args, got_kw), = rec.calls
    assert got_args == args
    if kwargs is not None:
        assert got_kw == kwargs
    else:  # the sweep's keyword
        assert got_kw["holdout_sweep"] == "all"


def _report(verdict, fails=()):
    crit = {c: {"ok": c not in fails} for c in ("a", "b")}
    return {"train_steps": 40, "verdict": verdict, "criteria": crit}


def _shapes_report(joint):
    return {"composed": {"joint_mean": joint, "joint_min": joint,
                         "diversity_mean": 1.0, "fid_probe": 1.0}}


@pytest.mark.parametrize("joint,code,verdict", [
    (0.5, 1, "FAIL"), (0.9, 0, "PASS")])
def test_quality_gate_shapes_exit_codes(joint, code, verdict, monkeypatch,
                                        tmp_path, capsys):
    """Judged against a crafted baseline report (``gate.judge`` under the
    shapes criteria, as the entry point judges): a FAIL exits 1, a PASS 0;
    a baseline that is neither a report nor a configuration exits 2 before
    any work."""
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"config": "unet64",
                                **_shapes_report(0.9)}))

    def judged(configs, baseline, **kw):
        with open(baseline) as f:
            b = json.load(f)
        out = {}
        for cfg in configs:
            r = {"train_steps": kw["train_steps"], **_shapes_report(joint)}
            r.update(gate.judge(r, b, kw["tol"], kw["div_frac"],
                                kw["fid_slack"],
                                criteria=gate.SHAPES_CRITERIA))
            out[cfg] = r
        return out

    monkeypatch.setattr(entry, "quality_gate_shapes", Recorder(judged))
    main = cli("quality_gate_shapes").main
    code_got = main(["--cpu", "--configs", "dit_p8_d256_l8", "--baseline",
                     str(base), "--out", str(tmp_path)])
    assert code_got == code
    out = capsys.readouterr().out
    assert f"dit_p8_d256_l8: {verdict}" in out
    assert (f"report saved to {tmp_path}/quality_shapes_dit_p8_d256_l8"
            ".json") in out
    assert (verdict == "FAIL") == ("(failed: cell_joint_mean, "
                                   "cell_joint_min)" in out)
    _forbid_work(monkeypatch)
    with pytest.raises(SystemExit) as e:
        main(["--cpu", "--configs", "unet64", "--baseline", "unet32"])
    assert e.value.code == 2
    assert "FATAL: --baseline 'unet32' not found" in capsys.readouterr().err


def test_quality_gate_flagship_exit_codes(monkeypatch, tmp_path, capsys):
    rec = Recorder(lambda configs, **kw: {
        "unet32": _report("FAIL", ("b",)), "unet64": _report("BASELINE")})
    monkeypatch.setattr(entry, "quality_gate_flagship", rec)
    main = cli("quality_gate_flagship").main
    assert main(["--cpu", "--sanity", "--baseline", "unet64", "--configs",
                 "unet32,unet64", "--out", "o", "--seed", "4"]) == 1
    (args, kw), = rec.calls
    assert args == (["unet32", "unet64"],)
    assert kw == dict(train_steps=12000, batch_size=256, lr=2e-4, ema=0.999,
                      probe_steps=2000, n_samples=256, n_steps=50,
                      data_n=8192, seed=4, baseline="unet64", tol=0.02,
                      div_frac=0.5, fid_slack=1.5, sanity=True, out="o",
                      device="cpu")
    out = capsys.readouterr().out
    assert "unet32: FAIL  (failed: b)" in out
    assert "report saved to o/quality_unet32_s40.json" in out
    # report only: no baseline, no verdict, exit 0
    rec.value = lambda configs, **kw: {"unet64": {"train_steps": 12000}}
    assert main(["--cpu", "--configs", "unet64"]) == 0
    assert rec.calls[-1][1]["baseline"] is None
    assert "report saved to outputs/quality_gate/quality_unet64.json" \
        in capsys.readouterr().out
    # exit 2 before any work: a name not among the configs, a report
    # without the distributional statistics
    _forbid_work(monkeypatch)
    lacking = tmp_path / "old.json"
    lacking.write_text(json.dumps({"composed": {"in_set_frac": 1.0}}))
    for bad in ("unet48", str(lacking)):
        with pytest.raises(SystemExit) as e:
            main(["--cpu", "--baseline", bad])
        assert e.value.code == 2
        assert "FATAL" in capsys.readouterr().err


@pytest.mark.parametrize("override,match", [
    ("--schedule.family=ddpm", "continuous VP schedule"),
    ("--train.predict=v", "kind='stable'")])
def test_eval_nll_refuses_as_the_script(override, match, monkeypatch):
    """SystemExit with the script's message, before any checkpoint is
    read."""
    _forbid_work(monkeypatch)
    argv = ["--cpu", override]
    if "predict" in override:
        argv.append("--schedule.kind=cosine")
    with pytest.raises(SystemExit, match=match):
        cli("eval_nll").main(argv)


def test_sample_image_refuses_as_the_script(monkeypatch):
    _forbid_work(monkeypatch)
    with pytest.raises(SystemExit, match="ddim only"):
        cli("sample_image").main(["--cpu", "--train.predict=x0",
                                  "--sampler", "em"])
    with pytest.raises(SystemExit) as e:  # not one of its choices
        cli("sample_image").main(["--cpu", "--sampler", "heun"])
    assert e.value.code == 2


def test_glue_argument_errors_exit_2(monkeypatch, capsys):
    """The scripts' ``ap.error`` checks, before any work."""
    _forbid_work(monkeypatch)
    for name, argv in (
            ("superdiff", ["--labels", "[[1],[2]]"]),
            ("superdiff", ["--bias", "1,2,3"]),
            ("superdiff", ["--operation", "AVG", "--rigorous_and"]),
            ("compose_images_ddim", ["--op", "proj"]),
            ("latent_shape_experts", ["--ops", "ddim,heun"])):
        with pytest.raises(SystemExit) as e:
            cli(name).main(["--cpu"] + argv)
        assert e.value.code == 2, name
        assert "error:" in capsys.readouterr().err
