"""The port's profilers (``scripts.profile_dit``, ``scripts.profile_unet``,
``scripts.bench_dit_config``) and the folded DiT's einsum attention route,
on the CPU:

* ``make_folded_apply(pallas_attn=False)`` against the JAX package's
  ``make_folded_apply(pallas_attn=False, fused_block=False)``, with and
  without ``fold_ln``, on both attention layouts, float32 and bf16;
* the FLOP counts against the JAX scripts' (loaded by path), and
  ``bench_dit_config``'s GFLOP per image against ``bench.py``'s;
* a ``--cpu`` run of each command line at a tiny size: exit 0, every row
  of its script, the launching wrappers called exactly where the served
  variants call them; ``--profile`` writes the trace; ``timed_scan``'s
  call count.

The parsers, ``--help`` and the exit 3 without a card are held with every
other command line's in ``test_torch_scripts.py``.
"""

import importlib.util
import inspect
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu.models import DiT as JaxDiT
from composable_diffusion_models_tpu.models.dit import (
    make_folded_apply as jax_folded)
from composable_diffusion_models_tpu_torch import convert, samplers
from composable_diffusion_models_tpu_torch.models import dit
from composable_diffusion_models_tpu_torch.models.dit import (
    DiT, make_folded_apply)
from composable_diffusion_models_tpu_torch.scripts import (bench_dit_config,
                                                           profile_dit,
                                                           profile_unet)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(patch=7, dim=64, depth=2, n_heads=4)
BF16_ULP = 2.0 ** -8


def _max_rel(got, ref):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


# ------------------------------------------- the folded einsum attention
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fold_ln", [False, True])
@pytest.mark.parametrize("qkv_fused", [True, False])
def test_folded_einsum_route_matches_jax(qkv_fused, fold_ln, dtype,
                                         monkeypatch):
    """``pallas_attn=False`` computes the attention as JAX's non-Pallas
    ``short_seq_attention`` and launches no kernel: float32 to 1e-5 of the
    output scale (summation order), bf16 to 4 bf16 ulps of it (the two
    libraries' summation orders flip single roundings)."""
    cfg = DiT(**SMALL, qkv_fused=qkv_fused, dtype=dtype)
    jm = JaxDiT(**SMALL, qkv_fused=qkv_fused,
                dtype=None if dtype is None else jnp.bfloat16)
    tree = convert.init_params(cfg, seed=6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 28, 28, 1)).astype(np.float32)
    t = np.array([0.41], np.float32)
    ref = np.asarray(jax_folded(jm, fold_ln=fold_ln, pallas_attn=False,
                                fused_block=False)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
        jnp.asarray(t)), np.float32)

    def refused(*a, **k):
        raise AssertionError("pallas_attn=False reached a kernel wrapper")

    monkeypatch.setattr(dit, "short_seq_attention", refused)
    monkeypatch.setattr(dit, "fused_dit_block", refused)
    apply = make_folded_apply(cfg, fused_block=False, fold_ln=fold_ln,
                              pallas_attn=False)
    got = apply(convert.from_flax(tree), torch.from_numpy(x),
                torch.from_numpy(t))
    tol = 1e-5 if dtype is None else 4 * BF16_ULP
    assert _max_rel(got.float().numpy(), ref) <= tol


def test_folded_apply_has_no_attn_mode():
    """One K1 design and a loop over experts: neither the Pallas block's
    second attention layout nor the scan's unroll threshold is a knob."""
    assert list(inspect.signature(make_folded_apply).parameters) == [
        "model", "fused_block", "fold_ln", "pallas_attn"]


# ------------------------------------------------------------ FLOP counts
def _jax_script(name, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("b,t,d,depth,h", [
    (768, 16, 256, 8, 8), (3, 4, 64, 2, 2), (17, 49, 96, 5, 4)])
def test_dit_flops_match_the_script(b, t, d, depth, h, monkeypatch):
    jax_dit = _jax_script("profile_dit", monkeypatch)
    assert profile_dit.attn_flops(b, t, d, h) == jax_dit.attn_flops(b, t, d,
                                                                    h)
    assert profile_dit.block_flops(b, t, d, h) == jax_dit.block_flops(
        b, t, d, h)
    assert profile_dit.dit_flops(b, t, d, depth, h) == jax_dit.dit_flops(
        b, t, d, depth, h)


@pytest.mark.parametrize("args", [
    (384, 28, 28, 1, 64), (384, 14, 14, 64, 128, 3), (5, 7, 7, 256, 256, 1)])
def test_conv_flops_match_the_script(args, monkeypatch):
    jax_unet = _jax_script("profile_unet", monkeypatch)
    assert profile_unet.conv_flops(*args) == jax_unet.conv_flops(*args)


@pytest.mark.parametrize("patch,dim,depth", [
    (7, 256, 6), (14, 256, 4), (4, 512, 4)])
def test_bench_gflop_matches_bench(patch, dim, depth, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import bench
    want = bench.dit_gflop_per_image(28, patch, dim, depth, 3, 50)
    got = bench_dit_config.gflop_per_image(
        DiT(patch=patch, dim=dim, depth=depth, in_channels=1), 50)
    assert got == pytest.approx(want, rel=1e-12)
    assert round(got, 2) == round(want, 2)


# ------------------------------------------------- the command lines, --cpu
def test_timed_scan_calls_warm_plus_reps():
    calls = []

    def fn(x, y):
        calls.append(x)
        return x * y

    x, y = torch.ones(4, 3), torch.full((4, 3), 2.0)
    sec = profile_unet.timed_scan(fn, (x, y), 5)
    assert len(calls) == 1 + 5 and sec > 0
    assert profile_unet.device_ms(fn, (x, y)) is None  # no device


UNET_ARGV = ["--cpu", "--bs", "2", "--reps", "1", "--base_dim", "8",
             "--img", "8", "--experts", "1"]
# the JAX script's rows at UNET_ARGV
UNET_ROWS = ["UNet forward (1 expert)", "1-expert blended eps",
             "init conv 1->8 @8", "conv 8->8 @8", "conv 8->16 @4",
             "conv 16->32 @2", "conv 32->32 @2", "GN+SiLU 8 @8",
             "conv2x bare 8->8 @8", "conv2x + GN between @8",
             "ResBlock 8->8 @8", "ResBlock 8->16 @4", "ResBlock 16->32 @2",
             "upsample 2->4 @32", "upsample 4->8 @16",
             "full 50-step DDIM batch"]


def test_profile_unet_runs_every_row(monkeypatch, capsys):
    gn = []
    real = profile_unet.gn_silu

    def counted(*a, **k):
        gn.append(k.get("fused_gn", a[3] if len(a) > 3 else None))
        return real(*a, **k)

    monkeypatch.setattr(profile_unet, "gn_silu", counted)
    assert profile_unet.main(UNET_ARGV) == 0
    out = capsys.readouterr().out
    assert ("bs=2 base_dim=8 img=8 in_ch=1 experts=1 reps=1 device=cpu"
            in out)
    assert "| op | ms | dev ms | TF/s | % of 1-expert eps step |" in out
    for name in UNET_ROWS:
        assert f"| {name} | " in out, name
    assert "full-sample throughput: " in out
    assert gn and all(gn)  # the GN rows through the kernel's wrapper


DIT_ARGV = ["--cpu", "--bs", "2", "--reps", "1", "--dim", "32", "--heads",
            "2", "--depth", "1", "--patch", "14", "--experts", "1"]
FWD_TAGS = ["stock MHDPA", "fused-qkv", "FOLDED", "FOLD_LN", "PALLAS_ATTN",
            "FUSED_BLOCK"]
# the JAX script's per-op rows at DIT_ARGV
DIT_ROWS = ["DiTBlock (stock)", "DiTBlock (fused)",
            "attention (stock MHDPA)", "attention (fused qkv)",
            "MLP d->4d->d (+gelu)", "LN(fp32)+modulate pass",
            "patchify conv", "ideal GEMM 10x1024x10 (= fwd FLOPs)"]


def test_profile_dit_runs_every_row_and_route(monkeypatch, capsys):
    """Every row of the script, BLOCK_BATCHED replaced by one line; each
    sampler call reaches fused_dit_block only under FUSED_BLOCK (depth x
    experts x 50 calls) and short_seq_attention only under PALLAS_ATTN,
    in the order the rounds run them."""
    monkeypatch.setattr(profile_dit, "ROUNDS", 2)
    monkeypatch.setattr(profile_dit, "CALLS", 1)
    counts = {"fused_dit_block": 0, "short_seq_attention": 0}
    for name in counts:
        real = getattr(dit, name)

        def counted(*a, name=name, real=real):
            counts[name] += 1
            return real(*a)
        monkeypatch.setattr(dit, name, counted)
    per_call, ddim = [], samplers.ddim

    def recorded(*a, **k):
        before = dict(counts)
        out = ddim(*a, **k)
        per_call.append({n: counts[n] - before[n] for n in counts})
        return out

    monkeypatch.setattr(samplers, "ddim", recorded)
    assert profile_dit.main(DIT_ARGV) == 0
    out = capsys.readouterr().out
    for rep in range(2):
        for tag in FWD_TAGS:
            assert f"| DiT fwd ({tag}) r{rep} | " in out, tag
    for name in DIT_ROWS:
        assert f"| {name} | " in out, name
    assert "| op | ms | dev ms | TF/s |" in out
    assert out.count("BLOCK_BATCHED") == 1 and out.count("blkbat") == 1
    for tag in profile_dit.SAMPLER_TAGS:
        assert f"round 1 {tag}: " in out
        assert f"attn={tag[0]:6s} experts={tag[1]:6s}: " in out
    assert "mean diff" in out
    tags = list(profile_dit.SAMPLER_TAGS)
    order = tags + [tag for _ in range(2) for tag in tags]
    want = {"block": {"fused_dit_block": 50, "short_seq_attention": 0},
            "pallas": {"fused_dit_block": 0, "short_seq_attention": 50}}
    zero = {"fused_dit_block": 0, "short_seq_attention": 0}
    assert per_call == [want.get(tag[0], zero) for tag in order]


def test_bench_dit_config_prints_the_scripts_rows(capsys):
    argv = ["--cpu", "--configs", "p14_d128_l1,p14_d128_l2",
            "--batch_sizes", "2,3", "--iters", "1", "--n_steps", "2"]
    assert bench_dit_config.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert [(r["depth"], r["batch_size"]) for r in rows] == [
        (1, 2), (1, 3), (2, 2), (2, 3)]
    for r in rows:
        assert list(r) == ["patch", "dim", "depth", "batch_size", "n_steps",
                           "images_per_sec", "gflop_per_image",
                           "implied_tflops", "mfu"]
        assert r["images_per_sec"] > 0 and r["n_steps"] == 2
    assert lines[-1].startswith("# best: {")


@pytest.mark.parametrize("name,argv", [
    ("profile_unet", UNET_ARGV),
    ("profile_dit", DIT_ARGV),
    ("bench_dit_config", ["--cpu", "--configs", "p14_d128_l1",
                          "--batch_sizes", "2", "--iters", "1",
                          "--n_steps", "2"])])
def test_profile_flag_writes_the_trace(name, argv, monkeypatch, tmp_path,
                                       capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(profile_dit, "ROUNDS", 1)
    monkeypatch.setattr(profile_dit, "CALLS", 1)
    mod = {"profile_unet": profile_unet, "profile_dit": profile_dit,
           "bench_dit_config": bench_dit_config}[name]
    assert mod.main(argv + ["--profile"]) == 0
    trace = tmp_path / "outputs" / "profile" / "trace.json"
    assert trace.exists() and trace.stat().st_size > 0
