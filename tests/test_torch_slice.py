"""Port parity for the serving slice as a whole: 3 full-width
``dit_p14_d256_l4`` experts composed in a DDIM loop, against the JAX
package's program on the same weights and noise; plus the expert stack,
the blend, the port's independence from JAX, and its device default."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import DiT as JaxDiT
from composable_diffusion_models_tpu.models import (
    make_folded_apply as jax_folded)
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import compose, convert, entry
from composable_diffusion_models_tpu_torch import experts

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "composable_diffusion_models_tpu_torch"


@pytest.fixture(scope="module")
def flagship_run():
    """3 randomized flagship experts, batch 4, 10 DDIM steps: the JAX
    reference program in fp32 (folded apply, XLA block path on the CPU)."""
    trees = [convert.init_params(entry.FLAGSHIP, seed=10 + i)
             for i in range(3)]
    x_init = np.random.default_rng(0).standard_normal(
        (4, 28, 28, 1)).astype(np.float32)
    jm = JaxDiT(patch=14, dim=256, depth=4, n_heads=8, in_channels=1,
                qkv_fused=True)
    stack = jexperts.ExpertStack(
        jax_folded(jm), [jax.tree_util.tree_map(jnp.asarray, t)
                         for t in trees])
    w = jnp.ones((3,))
    ref = np.asarray(jsamplers.ddim(
        lambda x, t: jcompose.weighted(stack(x, t), w), JaxVP(),
        jnp.asarray(x_init), 10))
    return trees, x_init, ref


@pytest.mark.parametrize("fused_block", [True, False])
def test_flagship_ddim_matches_jax(flagship_run, fused_block):
    """fp32 end to end. Measured max |diff| ~3e-5 on outputs of magnitude
    ~1 (float32 summation order through 4 blocks x 10 steps, amplified by
    the 1/alpha of the early steps); the bar leaves 30x room: 1e-3."""
    trees, x_init, ref = flagship_run
    got = entry.sample([convert.from_flax(t) for t in trees], x_init,
                       n_steps=10, fused_block=fused_block, device="cpu",
                       dtype=torch.float32).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert float(np.abs(ref).max()) > 0.5
    assert float(np.abs(got - ref).max()) <= 1e-3


def test_flops_per_image():
    assert abs(entry.gflop_per_image() - 4.377) < 1e-3


@pytest.mark.parametrize("w", [[1.0, 2.0, 0.5],
                               [[1.0, 0.5], [2.0, 1.0], [0.5, 3.0]]])
def test_weighted_matches_jax(w):
    eps = np.random.default_rng(4).standard_normal(
        (3, 2, 4, 4, 1)).astype(np.float32)
    ref = np.asarray(jcompose.weighted(jnp.asarray(eps), jnp.asarray(w)))
    got = compose.weighted(torch.from_numpy(eps), torch.tensor(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _apply(p, x, t, lab):
    return p["w"] * x + t + lab.reshape(-1, 1, 1, 1)


def test_expert_stack_matches_jax():
    """Broadcast and per-expert labels map the same way; an ambiguous
    (K, ...) label is rejected."""
    ws = [1.0, -2.0, 0.5]
    x = np.random.default_rng(5).standard_normal((2, 3, 3, 1)).astype(
        np.float32)
    lab = np.array([1.0, 2.0], np.float32)
    per = np.arange(6, dtype=np.float32).reshape(3, 2)
    jst = jexperts.ExpertStack(_apply, [{"w": jnp.float32(w)} for w in ws])
    tst = experts.ExpertStack(_apply, [{"w": torch.tensor(w)} for w in ws])
    for jl, tl in ((jnp.asarray(lab), torch.from_numpy(lab)),
                   (jexperts.per_expert(jnp.asarray(per)),
                    experts.per_expert(torch.from_numpy(per)))):
        ref = np.asarray(jst(jnp.asarray(x), jnp.float32(0.25), jl))
        got = tst(torch.from_numpy(x), torch.tensor(0.25), tl).numpy()
        assert got.shape == (3, 2, 3, 3, 1)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="ambiguous"):
        tst(torch.from_numpy(x), torch.tensor(0.25), torch.zeros(3, 2))
    with pytest.raises(ValueError, match="per_expert"):
        tst(torch.from_numpy(x), torch.tensor(0.25),
            experts.per_expert(torch.zeros(2, 2)))


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """device=None means the card: without one the entry point raises and
    never runs on the CPU (the serving path's, those of the latent, 2-D
    and evaluation scripts, and parallel/'s: make_expert_parallel_eps_fn,
    sample_expert_parallel and dryrun_multichip, which start no rank)."""
    from composable_diffusion_models_tpu_torch import (eval_composition,
                                                       eval_superdiff)
    from composable_diffusion_models_tpu_torch.parallel import dryrun
    from composable_diffusion_models_tpu_torch.parallel import (
        sample as psample)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trees = [convert.from_flax(convert.init_params(entry.FLAGSHIP, seed=0))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.sample(trees, np.zeros((1, 28, 28, 1), np.float32), n_steps=1)
    out = str(tmp_path)
    for call in (entry.fit_pca, entry.train_latent_2d,
                 entry.superposition_2d, entry.compose_images_ito,
                 eval_composition.eval_composition,
                 eval_superdiff.eval_superdiff,
                 lambda out: eval_superdiff.eval_superdiff("factored",
                                                           out=out)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(out=out)
    assert not any(tmp_path.iterdir())
    for call in (lambda: psample.make_expert_parallel_eps_fn(
                     entry.make_folded_apply(entry.FLAGSHIP), None, trees[0],
                     torch.ones(1)),
                 lambda: psample.sample_expert_parallel(
                     trees, np.zeros((1, 28, 28, 1), np.float32), None,
                     entry.FLAGSHIP),
                 lambda: dryrun.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
              "composable_diffusion_models_tpu", "bench", "__graft_entry__")


def test_port_imports_nothing_of_jax():
    """Every module of the port (and chip_smoke.py, compare_builds.py)
    imports with JAX and the JAX package blocked, and no source names them
    in an import."""
    scripts = ["chip_smoke", "compare_builds"]
    sources = sorted(PKG.rglob("*.py")) + [ROOT / f"{m}.py" for m in scripts]
    for src in sources:
        for node in ast.walk(ast.parse(src.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in _FORBIDDEN, (src, n)
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + scripts
    # the walk reaches every slice's modules: the serving paths', the
    # latent slice's, the training path's, the DDPM samplers' and the
    # shapes gate's and NLL path's (data, models.unet, models.probe,
    # samplers, convert, eval, gate, entry, ops.kernels, ops.attention),
    # the config-driven paths' and the evaluation scripts', parallel/, and
    # the command lines of scripts/ (the profilers among them)
    assert {PKG.name + "." + m for m in (
        "models.dit", "models.unet", "models.mlp", "models.probe",
        "models.embeddings", "ops.kernels", "ops.attention", "ops.pca",
        "ops.divergence", "ops._build", "compose", "experts", "samplers",
        "schedules", "convert", "entry", "train", "data", "gate", "eval",
        "checkpoint", "rng", "builders", "utils.config", "utils.viz",
        "eval_composition", "eval_superdiff", "utils.summarize",
        "parallel", "parallel.mesh", "parallel.sample", "parallel.train",
        "parallel.tp", "parallel.pp", "parallel.sp", "parallel.dryrun",
        "scripts", "scripts._common", "scripts.train_image",
        "scripts.sample_image", "scripts.compose_scores", "scripts.superdiff",
        "scripts.layout_compose", "scripts.compose_bbox",
        "scripts.compose_images_ddim", "scripts.compose_images_ito",
        "scripts.compose_cfg", "scripts.compose_cifar", "scripts.train_vae",
        "scripts.compose_latent_vae", "scripts.fit_pca",
        "scripts.train_latent_2d", "scripts.sample_latent",
        "scripts.latent_shape_experts", "scripts.superposition_2d",
        "scripts.eval_nll", "scripts.eval_composition",
        "scripts.eval_superdiff", "scripts.summarize_evals",
        "scripts.quality_gate_flagship", "scripts.quality_gate_shapes",
        "scripts.frontier_sweep", "scripts.visualize_forward",
        "scripts.visualize_composition_latent", "scripts.profile_dit",
        "scripts.profile_unet", "scripts.bench_dit_config")} <= set(mods)
    code = ("import sys\n"
            + "".join(f"sys.modules[{n!r}] = None\n" for n in _FORBIDDEN)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            + f"{_FORBIDDEN!r} and sys.modules[m] is not None]\n"
            + "assert not bad, bad\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
