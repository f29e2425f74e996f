"""Port parity for the flagship gate over named configurations
(``entry.quality_gate_flagship``, ``scripts/quality_gate_flagship.py``),
the frontier sweep (``frontier.frontier_sweep``,
``scripts/frontier_sweep.py``) and the kernel widening their candidates
need (heads of 48 and 64, a bf16 stream of 384):

* ``gate.build_model`` for ``unet16`` and ``dit_p14_d96_l1_h2`` (heads of
  48) against the script's: the initial trees' shapes, one training
  forward and one served forward on the same random trees (float32, 1e-5
  of the scale);
* the plain versions of ``fused_dit_block`` and ``short_seq_attention``
  at heads of 48 and 64 and at D = 384 against the Pallas kernels in
  interpret mode (float32: the JAX tests' 2e-4 / 1e-5; bf16: 4 ulps of the
  scale), and the wrappers' new limits;
* the gate end to end at the script's ``--sanity`` sizes (verdicts, the
  baseline, files, grids), with the script's training keys, and its
  scoring against the script's computation on the same trees, data and
  float32 probe with the sampling noise replayed: the probe's statistics
  of every set, and the verdicts of the judge;
* the sweep with the gate replaced by scripted verdicts: escalation,
  resume, the table, the GFLOP against ``bench.dit_gflop_per_image`` and
  the H100 peak of 989 TFLOP/s;
* both entry points raising without a card before writing anything.
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
from jax.experimental.pallas import tpu as pltpu

import bench
from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import data as jdata
from composable_diffusion_models_tpu import eval as jeval
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.ops import pallas_kernels as pk
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import (convert, data, entry,
                                                   frontier, gate, train)
from composable_diffusion_models_tpu_torch import eval as ceval
from composable_diffusion_models_tpu_torch.models.probe import ProbeClassifier
from composable_diffusion_models_tpu_torch.models.unet import UNet
from composable_diffusion_models_tpu_torch.ops import attention, kernels
from composable_diffusion_models_tpu_torch.rng import Replay, fold_in
from composable_diffusion_models_tpu_torch.utils import viz

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ("unet16", "dit_p14_d96_l1_h2")


def _load(name):
    """A script's module, from its file (with ``scripts/`` importable)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return mod


SCRIPT = _load("quality_gate_flagship")


def _np(x):
    return np.asarray(x.detach().float().cpu()) \
        if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, ref, tol):
    """max |got - ref| <= tol * max(1, |ref|max)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale)


def _png_shape(path):
    """(height, width, 3) of an 8-bit RGB PNG, its rows decoded by zlib."""
    data_ = Path(path).read_bytes()
    pos, chunks = 8, {}
    while pos < len(data_):
        n, = struct.unpack(">I", data_[pos:pos + 4])
        kind, body = data_[pos + 4:pos + 8], data_[pos + 8:pos + 8 + n]
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + 3 * w)
    return h, w, 3


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tuple(np.shape(tree))}


# ------------------------------------------------------------ build_model
@pytest.mark.parametrize("name", CONFIGS)
def test_build_model_matches_the_script(name):
    """The same architecture: the flax init's leaves and shapes, the
    training forward and the served program (the folded DiT; the UNet with
    its GroupNorm through the kernel's plain version) on one random tree,
    float32. The gate's own dtype is bf16, as the script's."""
    model, serve = gate.build_model(name)
    assert model.dtype == torch.bfloat16
    jm, jserve = SCRIPT.build_model(name, jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(
        np.float32)
    jinit = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jnp.ones((1,))))
    m32, serve32 = gate.build_model(name, torch.float32)
    assert _leaves(convert.flax_init(m32, 0)) == _leaves(jinit)
    tree = convert.init_params(m32, seed=5)  # random everywhere
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = convert.from_flax(tree)
    if isinstance(m32, UNet):
        tt = convert.unet_torch_layout(tt)
    t = np.array([0.37], np.float32)
    ref = jax.jit(jm.apply)(jt, jnp.asarray(x), jnp.asarray(t))
    _close(m32.apply(tt, torch.from_numpy(x), torch.from_numpy(t)), ref,
           1e-5)
    assert float(np.abs(np.asarray(ref)).max()) > 1e-2
    with torch.no_grad():
        got = serve32(tt, torch.from_numpy(x), torch.from_numpy(t))
    _close(got, ref if isinstance(m32, UNet) else jax.jit(jserve)(
        jt, jnp.asarray(x), jnp.asarray(t)), 1e-5)
    with torch.no_grad():
        bf = serve(entry._cast(tt, torch.device("cpu"), torch.bfloat16),
                   torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(t).bfloat16())
    assert bool(torch.isfinite(bf).all())
    with pytest.raises(ValueError, match="unknown config"):
        gate.build_model("vit_p4")


# ------------------------------------------- the widened K1 and K2 limits
@pytest.fixture
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _block_args(rng, b, t, d, scale=0.1):
    shapes = [(b, t, d), (d, 3 * d), (3 * d,), (d, d), (d,), (d, 4 * d),
              (4 * d,), (4 * d, d), (d,)]
    return [rng.standard_normal(s).astype(np.float32) * (1.0 if i == 0
                                                         else scale)
            for i, s in enumerate(shapes)]


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("b,t,d,h", [(3, 4, 96, 2), (2, 16, 192, 4),
                                     (2, 4, 256, 4), (2, 4, 384, 8),
                                     (2, 16, 192, 6)])
def test_block_ref_matches_pallas_at_the_new_widths(b, t, d, h):
    """Heads of 48 (D = 96, 192, 384) and 64 (D = 256, 4 heads), D = 384,
    and D = 192 at 16 tokens (its N chunks no multiple of 128): fp32 to
    the JAX tests' 2e-4; bf16 to 4 ulps of the output scale; the CPU
    wrapper is the plain version."""
    args = _block_args(np.random.default_rng(b + t + d), b, t, d)
    ref = np.asarray(pk.fused_dit_block(*map(jnp.asarray, args), h,
                                        use_pallas=True))
    got = kernels.fused_dit_block_ref(*map(torch.from_numpy, args), h)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    wrapped = kernels.fused_dit_block(*map(torch.from_numpy, args), h)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    ref16 = np.asarray(pk.fused_dit_block(
        *(jnp.asarray(a, jnp.bfloat16) for a in args), h,
        use_pallas=True).astype(jnp.float32))
    got16 = kernels.fused_dit_block(
        *(torch.from_numpy(a).bfloat16() for a in args), h).float().numpy()
    scale = float(np.abs(ref16).max())
    assert float(np.abs(got16 - ref16).max()) <= 4 * 2.0 ** -8 * scale


@pytest.mark.usefixtures("_interpret_mode")
@pytest.mark.parametrize("b,t,d,h", [(4, 4, 384, 8), (3, 16, 96, 2),
                                     (3, 4, 256, 4)])
def test_short_seq_attention_ref_matches_pallas_at_the_new_widths(b, t, d,
                                                                  h):
    """Heads of 48 and 64: fp32 to 1e-5, bf16 to a couple of bf16 ulps of
    the O(1) outputs (the bars of the existing widths)."""
    qkv = np.random.default_rng(b * t + d).standard_normal(
        (b, t, 3 * d)).astype(np.float32)
    ref = np.asarray(pk.short_seq_attention(jnp.asarray(qkv), h,
                                            use_pallas=True))
    got = kernels.short_seq_attention(torch.from_numpy(qkv), h).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    ref16 = np.asarray(pk.short_seq_attention(
        jnp.asarray(qkv, jnp.bfloat16), h, use_pallas=True).astype(
            jnp.float32))
    got16 = kernels.short_seq_attention(
        torch.from_numpy(qkv).bfloat16(), h).float().numpy()
    np.testing.assert_allclose(got16, ref16, rtol=0, atol=2 ** -6)


def test_widened_limits_and_routes():
    """K1 takes heads of 48 and 64 and a bf16 stream past 256 on the wide
    route (32 rows, so at most 32 tokens there); K2 heads of 48; K6 heads
    up to 256, on the tiles route only past 128. What stays out still
    raises with its reason."""
    rng = np.random.default_rng(9)
    for d, h in ((96, 2), (256, 4)):
        args = [torch.from_numpy(a) for a in _block_args(rng, 2, 4, d)]
        kernels.fused_dit_block(*args, h)
    assert kernels.block_route(torch.bfloat16, 4, 384) == "wide"
    assert kernels.block_route(torch.bfloat16, 4, 256) == "wgmma"
    assert kernels.block_route(torch.float32, 4, 256) == "rows"
    big = [torch.zeros(s, dtype=torch.bfloat16) for s in (
        (1, 33, 384), (384, 1152), (1152,), (384, 384), (384,),
        (384, 1536), (1536,), (1536, 384), (384,))]
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_dit_block(*big, 8)
    args = [torch.from_numpy(a) for a in _block_args(rng, 2, 4, 96)]
    with pytest.raises(ValueError, match="head width"):
        kernels.fused_dit_block(*args, 4)  # heads of 24
    kernels.short_seq_attention(torch.zeros(2, 4, 3 * 96), 2)
    with pytest.raises(ValueError, match="head width"):
        kernels.short_seq_attention(torch.zeros(2, 4, 3 * 96), 4)
    strides = (8 * 4096 * 256, 4096 * 256, 256) * 4
    assert attention.flash_route(torch.bfloat16, 8, 4096, 256,
                                 strides) == "tiles"
    assert attention.flash_route(torch.bfloat16, 8, 4096, 128,
                                 strides) == "wgmma"
    q, k, v = (torch.randn(2, 2, n, 160) for n in (5, 3, 3))
    torch.testing.assert_close(attention.flash_attention(q, k, v),
                               attention.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


# ----------------------------------------------------------- the gate
@pytest.fixture(scope="module")
def sanity_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("gate")
    return out, entry.quality_gate_flagship(
        configs=CONFIGS, baseline="unet16", sanity=True, device="cpu",
        out=str(out))


def test_gate_runs_at_sanity_sizes(sanity_run):
    """Both configurations at the script's --sanity sizes (40 training
    steps of each expert at batch 16, a 40-step probe, 16 samples of 4 DDIM
    steps, bf16): the baseline labelled, the other judged, each report
    written as returned, the grids of 16 samples 8 a row."""
    out, reps = sanity_run
    assert set(reps) == set(CONFIGS)
    assert reps["unet16"]["verdict"] == "BASELINE"
    assert reps["dit_p14_d96_l1_h2"]["verdict"] in ("PASS", "FAIL")
    grid = viz._to_numpy_grid(np.zeros((16, 28, 28, 1)), 8).shape
    for cfg, rep in reps.items():
        path = out / f"quality_{cfg}_s40.json"
        assert json.loads(path.read_text()) == json.loads(json.dumps(rep))
        assert rep["baseline_config"] == "unet16"
        assert (rep["train_steps"], rep["n_samples"], rep["n_steps"]) == (
            40, 16, 4)
        assert set(rep["solo"]) == {"expert_0", "expert_1", "expert_2"}
        assert set(rep["criteria"]) == {c[0] for c in gate.GATE_CRITERIA}
        assert "escalation" not in rep and "near_boundary" in rep
        for stats in list(rep["solo"].values()) + [rep["composed"]]:
            assert sum(stats["class_hist"]) == pytest.approx(1.0, abs=1e-3)
            assert np.isfinite(stats["fid_probe"])
        for tag in ("solo0", "solo1", "solo2", "composed"):
            assert _png_shape(out / f"{cfg}_{tag}.png") == grid


def test_gate_trains_with_the_scripts_keys(tmp_path, monkeypatch):
    """Expert i of every configuration: its tree drawn with fold_in(seed,
    10 + i), trained with fold_in(seed, 20 + i) on subset i at the
    script's batch, steps, learning rate and EMA; one probe and one set of
    subsets for all configurations."""
    seen, inits = [], []
    orig = entry.flax_init

    def init(model, key, device="cpu"):
        inits.append(key)
        return orig(model, key, device)

    def fake_train(key, apply_fn, p0, schedule, imgs, **kw):
        seen.append((key, imgs.shape, kw))
        return p0, torch.zeros(kw["steps"])
    subsets = []
    orig_mnist = data.get_mnist

    def mnist(key, n, classes=None, device="cpu"):
        subsets.append((key, classes))
        return orig_mnist(key, n=n, classes=classes, device=device)
    monkeypatch.setattr(entry, "flax_init", init)
    monkeypatch.setattr(train, "train_expert", fake_train)
    monkeypatch.setattr(data, "get_mnist", mnist)
    entry.quality_gate_flagship(configs=CONFIGS, sanity=True, device="cpu",
                                out=None, seed=3)
    assert subsets == [(fold_in(3, 1), None)] + [
        (fold_in(3, 3 + i), s) for i, s in enumerate(gate.SUBSETS)]
    assert inits == [fold_in(3, 10 + i) for i in range(3)] * 2
    assert [k for k, _, _ in seen] == [fold_in(3, 20 + i)
                                       for i in range(3)] * 2
    for _, shape, kw in seen:
        assert shape == (256, 28, 28, 1)
        assert kw == dict(steps=40, batch_size=16, lr=2e-4, ema_decay=0.999)
    with pytest.raises(ValueError, match="neither"):
        entry.quality_gate_flagship(configs=CONFIGS, baseline="unet99",
                                    device="cpu", out=str(tmp_path))
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module")
def script_case():
    """The script's computation at its sanity sizes in float32 on given
    trees: JAX's digits, a float32 probe on one random tree, three random
    experts per configuration; the sampling noise of every set."""
    key = jax.random.PRNGKey(0)
    full, labels = jdata.get_mnist(jax.random.fold_in(key, 1), n=256)
    subsets = [jdata.get_mnist(jax.random.fold_in(key, 3 + i), n=256,
                               classes=list(s))[0]
               for i, s in enumerate(SCRIPT.SUBSETS)]
    probe = ProbeClassifier((10,), 32, None)
    ptree = convert.init_params(probe, seed=1)
    jprobe = jeval.ProbeClassifier((10,), 32, None)
    jpp = jax.tree_util.tree_map(jnp.asarray, ptree)
    real = jeval.probe_features(jprobe, jpp, full[:2048])
    trees, refs = {}, {}
    for c, cfg in enumerate(CONFIGS):
        m32, _ = gate.build_model(cfg, torch.float32)
        trees[cfg] = [convert.init_params(m32, seed=20 + 3 * c + i)
                      for i in range(3)]
        _, jserve = SCRIPT.build_model(cfg, jnp.float32)

        @jax.jit
        def run(ps, x, jserve=jserve):
            """The script's solo program (one tree) or its composed one."""
            if len(ps) == 1:
                return jsamplers.ddim(lambda x_, t: jserve(ps[0], x_, t),
                                      JaxVP(), x, 4)
            stack = jexperts.ExpertStack(jserve, ps)
            return jsamplers.ddim(lambda x_, t: jcompose.weighted(
                stack(x_, t), jnp.ones((3,))), JaxVP(), x, 4)
        jp = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees[cfg]]
        rep = {"solo": {}}
        for i, p in enumerate(jp):
            x = jax.random.normal(jax.random.fold_in(key, 30 + i),
                                  (16, 28, 28, 1))
            rep["solo"][f"expert_{i}"] = SCRIPT.probe_stats(
                jprobe, jpp, run([p], x), SCRIPT.SUBSETS[i], real)
        x = jax.random.normal(jax.random.fold_in(key, 40), (16, 28, 28, 1))
        out = run(jp, x)
        rep["composed"] = SCRIPT.probe_stats(
            jprobe, jpp, out, tuple(sorted(c for s in SCRIPT.SUBSETS
                                           for c in s)), real)
        refs[cfg] = rep
    heldin = jeval.probe_accuracy(jprobe, jpp, full[:512], (labels[:512],))
    noise = {fold_in(0, s): np.asarray(jax.random.normal(
        jax.random.fold_in(key, s), (16, 28, 28, 1))) for s in (30, 31, 32,
                                                                40)}
    return dict(full=(full, labels), subsets=subsets, probe=probe,
                ptree=ptree, trees=trees, refs=refs, heldin=heldin,
                noise=noise)


def _port_gate(case, monkeypatch, out, baseline):
    """The port's gate on the case's data, probe and trees, the noise
    replayed, float32."""
    full, labels = (torch.from_numpy(np.array(a)) for a in case["full"])

    def mnist(key, n, classes=None, device="cpu"):
        if classes is None:
            return full, labels.long()
        i = list(gate.SUBSETS).index(tuple(classes))
        return torch.from_numpy(np.array(case["subsets"][i])), None
    monkeypatch.setattr(data, "get_mnist", mnist)
    monkeypatch.setattr(ceval, "train_probe", lambda *a, **k: (
        case["probe"], convert.from_flax(case["ptree"])))
    monkeypatch.setattr(entry, "Draws", lambda key, dev: Replay(
        [case["noise"][key]], dev))
    experts = {cfg: [convert.from_flax(t) for t in ts]
               for cfg, ts in case["trees"].items()}
    return entry.quality_gate_flagship(
        configs=CONFIGS, baseline=baseline, sanity=True, device="cpu",
        out=str(out), experts=experts, dtype=torch.float32)


def _same_stats(got, want):
    assert got["in_set_frac"] == want["in_set_frac"]
    assert got["class_hist"] == want["class_hist"]
    for k in ("mean_max_prob", "mean_max_prob_in_set", "class_entropy"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    for k in ("diversity_mean", "fid_probe"):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-4), k


def test_gate_scores_as_the_script(script_case, tmp_path, monkeypatch):
    """Every set's probe statistics against the script's ``probe_stats`` of
    its samples (fractions and histograms exactly, confidences and entropy
    to 1e-5, diversity and FID-lite to 1e-3); the verdicts as the script's
    judge gives them; a baseline given as a report path is judged
    against, not labelled."""
    reps = _port_gate(script_case, monkeypatch, tmp_path, "unet16")
    for cfg, rep in reps.items():
        ref = script_case["refs"][cfg]
        for i in range(3):
            _same_stats(rep["solo"][f"expert_{i}"],
                        ref["solo"][f"expert_{i}"])
        _same_stats(rep["composed"], ref["composed"])
        assert rep["probe_heldin"] == script_case["heldin"]
    want = SCRIPT.judge(reps["dit_p14_d96_l1_h2"], reps["unet16"], 0.02, 0.5,
                        1.5, n_samples=16)
    assert {k: reps["dit_p14_d96_l1_h2"][k] for k in want} == want
    assert reps["unet16"]["verdict"] == "BASELINE"
    base = tmp_path / "quality_unet16_s40.json"
    again = _port_gate(script_case, monkeypatch, tmp_path / "again",
                       str(base))
    assert again["unet16"]["verdict"] == "PASS"  # itself, within every bar
    assert again["dit_p14_d96_l1_h2"]["verdict"] == \
        reps["dit_p14_d96_l1_h2"]["verdict"]
    assert again["unet16"]["baseline_config"] == "unet16"


# -------------------------------------------------------------- frontier
def test_frontier_sweep_escalates_resumes_and_tabulates(tmp_path,
                                                        monkeypatch):
    """A PASS at the first budget stops a candidate; a FAIL goes on; a
    report already on disk is read, not gated again; the table lists every
    candidate with its last budget and verdict, its GFLOP per composed
    image as ``bench.dit_gflop_per_image`` counts it, and the images/s a
    measured MFU gives at the H100's 989 TFLOP/s."""
    script = _load("frontier_sweep")
    assert frontier.DEFAULT_CANDIDATES == script.DEFAULT_CANDIDATES
    assert Path(frontier.DEFAULT_BASELINE).is_file()
    a, b, c = "dit_p14_d256_l6", "dit_p14_d384_l6", "dit_p7_d192_l6_h6"
    plan = {(a, 100): "PASS", (b, 100): "FAIL", (b, 200): "PASS",
            (c, 100): "FAIL", (c, 200): "FAIL", (c, 300): "FAIL"}
    calls = []

    def fake_gate(configs, train_steps, baseline, out, device, **kw):
        cand, = configs
        calls.append((cand, train_steps, baseline, kw))
        with open(frontier.gate_json(out, cand, train_steps), "w") as f:
            json.dump({"verdict": plan[cand, train_steps]}, f)
    monkeypatch.setattr(entry, "quality_gate_flagship", fake_gate)
    with open(frontier.gate_json(str(tmp_path), c, 100), "w") as f:
        json.dump({"verdict": "FAIL"}, f)
    table = frontier.frontier_sweep(
        candidates=(a, b, c), budgets=(100, 200, 300), baseline="base.json",
        out=str(tmp_path), mfu=0.2, device="cpu", probe_steps=7)
    assert [(cand, s) for cand, s, _, _ in calls] == [
        (a, 100), (b, 100), (b, 200), (c, 200), (c, 300)]
    assert all(bl == "base.json" and kw == {"probe_steps": 7}
               for _, _, bl, kw in calls)
    assert json.loads((tmp_path / "frontier_table.json").read_text()) == \
        table
    assert table["mfu_assumed"] == 0.2 and table["peak_tflops"] == 989.0
    rows = {r["config"]: r for r in table["rows"]}
    assert [r["config"] for r in table["rows"]] == [a, b, c]
    assert [(rows[x]["best_budget"], rows[x]["verdict"]) for x in (a, b, c)] \
        == [(100, "PASS"), (200, "PASS"), (300, "FAIL")]
    for x in (a, b, c):
        parts = {p[0]: int(p[1:]) for p in x.split("_")[1:]}
        g = bench.dit_gflop_per_image(28, parts["p"], parts["d"], parts["l"])
        assert frontier.cand_gflop(x) == pytest.approx(g, rel=1e-12)
        assert rows[x]["gflop_per_image"] == round(g, 2)
        assert rows[x]["projected_images_per_sec"] == round(
            989.0 * 1e3 * 0.2 / g)
    calls.clear()
    again = frontier.frontier_sweep(candidates=(a, b, c),
                                    budgets=(100, 200, 300),
                                    out=str(tmp_path), device="cpu")
    assert not calls  # every cell resumed from its report
    assert [r["verdict"] for r in again["rows"]] == ["PASS", "PASS", "FAIL"]
    assert {r["projected_images_per_sec"] for r in again["rows"]} == {None}
    assert frontier.cand_gflop("unet64") == pytest.approx(
        entry.unet_gflop_per_image(gate.build_model("unet64")[0], 28, 28)
        * 150)


def test_gate_and_sweep_default_to_cuda(monkeypatch, tmp_path):
    """device=None means the card: without one they raise before writing
    anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.quality_gate_flagship(sanity=True, out=str(tmp_path / "g"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontier.frontier_sweep(out=str(tmp_path / "f"))
    assert not any(tmp_path.iterdir())
