"""Per-op profile of the 16-token DiT (patch 7 / dim 256 / depth 8):
``scripts/profile_dit.py`` on the port. Times the whole forward under
each attention and serving variant, the block's ops standalone at the
block's shapes, and the full 50-step 3-expert DDIM sampler per variant,
interleaved over rounds.

    python -m composable_diffusion_models_tpu_torch.scripts.profile_dit \\
        --bs 768 --reps 100

The variants, all in bf16 on one ``convert.init_params`` tree per expert
and attention layout:

* ``stock MHDPA`` / ``fused-qkv``: ``DiT.apply`` (the unfolded training
  forward) on the stock multi-head and the fused-QKV layout;
* ``FOLDED``: ``make_folded_apply(fused_block=False, pallas_attn=False)``,
  the adaLN fold with the attention's einsum chain;
* ``FOLD_LN``: the same with the LayerNorm folded into the GEMM epilogue;
* ``PALLAS_ATTN``: ``make_folded_apply(fused_block=False)``, the attention
  through the ``short_seq_attention`` kernel;
* ``FUSED_BLOCK``: ``make_folded_apply()``, each block one
  ``fused_dit_block`` launch, as ``entry.sample`` serves.

The script's ``BLOCK_BATCHED`` (and the ``blkbat`` sampler) is a second
attention layout inside the TPU's fused block with the same math; the
port's ``fused_dit_block`` has one design (whole images in a 64-row tile,
attention per image), so ``BLOCK_BATCHED`` is ``FUSED_BLOCK`` here and is
not timed twice: one line says so.

Timing as ``profile_unet``: ``ms`` by CUDA events over ``--reps`` chained
calls, ``dev ms`` the device time of one call from a trace, TF/s over the
dev ms, flagged above the H100's dense bf16 peak (989 TF/s). The unfolded
variants launch hundreds of small kernels a forward, so their ``ms`` is the
host's launch rate. The sampler rounds are timed on the host clock, forced
once per round.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.nn.functional as F

from composable_diffusion_models_tpu_torch import (compose, convert, entry,
                                                   experts, rng, samplers)
from composable_diffusion_models_tpu_torch.models.dit import (
    DiT, _dense, _modulate, make_folded_apply)
from composable_diffusion_models_tpu_torch.ops.kernels import ln_f32
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.scripts.profile_unet import (
    device_ms, device_name, tflops, timed_scan)

# the sampler A/B: the variants in the order each round runs them (the
# script's expert layout tag kept: the experts run one after another), the
# rounds, and the calls each variant makes in a round
SAMPLER_TAGS = (("stock", "unroll"), ("fused", "unroll"),
                ("folded", "unroll"), ("pallas", "unroll"),
                ("block", "unroll"))
ROUNDS = 3
CALLS = 3
BLOCK_BATCHED = ("DiT fwd (BLOCK_BATCHED) and attn=blkbat: FUSED_BLOCK in "
                 "the port (fused_dit_block has one attention layout, whole "
                 "images in a 64-row tile with attention per image); not "
                 "timed twice")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Per-op profile of the "
                                             "16-token DiT.")
    ap.add_argument("--bs", type=int, default=768)
    ap.add_argument("--patch", type=int, default=7)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--img", type=int, default=28)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--experts", type=int, default=3)
    add_runtime_flags(ap)
    return ap


def dit_trees(model: DiT, n: int, device) -> list:
    """``n`` random DiT trees (``convert.init_params``, seeds 0..n-1) in
    bf16 on ``device``."""
    trees = [convert.from_flax(convert.init_params(model, seed=i))
             for i in range(n)]
    return entry.load_experts(trees, device, torch.bfloat16)


def sampler_ab(samplers_by_tag: dict, bs: int, rounds: int,
               calls: int) -> dict:
    """images/s of each variant's sampler per round: ``rounds`` rounds,
    each running every variant in turn for ``calls`` calls, forced once at
    the end of each (no sync inside a call)."""
    reps_by_tag = {tag: [] for tag in samplers_by_tag}
    for rnd in range(rounds):
        for tag, sample in samplers_by_tag.items():
            t0 = time.perf_counter()
            outs = [sample(rng.fold_in(0, 7 * rnd + i))
                    for i in range(calls)]
            torch.stack(outs).sum().item()
            v = bs * calls / (time.perf_counter() - t0)
            reps_by_tag[tag].append(v)
            print(f"  round {rnd} {tag}: {v:.1f} img/s")
    return reps_by_tag


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = torch.device(start(args) or "cuda")
    with profiled(args), torch.inference_mode():
        run(args, device)
    return 0


def run(args, device: torch.device) -> None:
    bs, d, img = args.bs, args.dim, args.img
    n_tok = (img // args.patch) ** 2
    dt = torch.bfloat16
    draws = rng.Draws(0, device)
    rows = []  # (name, sec, dev ms, flops)

    def row(name, fn, x, flops=None):
        sec = timed_scan(fn, (x,), args.reps)
        dev = None if args.profile else device_ms(fn, (x,))
        rows.append((name, sec, dev, flops))

    def rand(shape):
        return draws.normal(shape, dt)

    # ---- full forwards: every variant, A/B interleaved --------------------
    x = rand((bs, img, img, 1))
    t = torch.full((1,), 0.5, dtype=dt, device=device)
    variants = {}
    for fused in (False, True):
        model = DiT(patch=args.patch, dim=d, depth=args.depth,
                    n_heads=args.heads, in_channels=1, qkv_fused=fused,
                    img_size=img, dtype=dt)
        variants[fused] = (model, dit_trees(model, args.experts, device))
    stock_model, stock_trees = variants[False]
    fused_model, fused_trees = variants[True]
    folded = make_folded_apply(fused_model, fused_block=False,
                               pallas_attn=False)
    fold_ln = make_folded_apply(fused_model, fold_ln=True, pallas_attn=False)
    pallas = make_folded_apply(fused_model, fused_block=False)
    block = make_folded_apply(fused_model)
    fwd_fns = {
        "stock MHDPA": (stock_model.apply, stock_trees[0]),
        "fused-qkv": (fused_model.apply, fused_trees[0]),
        # the adaLN fold into per-step GEMM weights, patchify as a GEMM
        "FOLDED": (folded, fused_trees[0]),
        # + the LayerNorm's normalisation folded into the GEMM epilogue
        "FOLD_LN": (fold_ln, fused_trees[0]),
        # + scores, softmax and values in the short_seq_attention kernel
        "PALLAS_ATTN": (pallas, fused_trees[0]),
        # + each whole block one fused_dit_block launch
        "FUSED_BLOCK": (block, fused_trees[0]),
    }
    for rep in range(2):  # interleave all variants per round
        for tag, (apply, params) in fwd_fns.items():
            row(f"DiT fwd ({tag}) r{rep}",
                lambda xx, f=apply, p=params: f(p, xx, t), x,
                dit_flops(bs, n_tok, d, args.depth, args.heads))

    # ---- per-op decomposition at the block's shapes -----------------------
    tok = rand((bs, n_tok, d))
    c = rand((bs, d))
    for fused in (False, True):
        model, trees = variants[fused]
        row(f"DiTBlock ({'fused' if fused else 'stock'})",
            lambda xx, m=model, bp=trees[0]["params"]["block_0"]:
            m._block(bp, xx, c), tok,
            block_flops(bs, n_tok, d, args.heads))

    # attention alone, on either layout
    stock_bp = stock_trees[0]["params"]["block_0"]
    fused_bp = fused_trees[0]["params"]["block_0"]
    row("attention (stock MHDPA)",
        lambda xx: stock_model._attention(stock_bp, xx), tok,
        attn_flops(bs, n_tok, d, args.heads))
    row("attention (fused qkv)",
        lambda xx: fused_model._attention(fused_bp, xx), tok,
        attn_flops(bs, n_tok, d, args.heads))

    # MLP GEMM pair alone (the block's FLOP majority)
    row("MLP d->4d->d (+gelu)",
        lambda xx: _dense(F.gelu(_dense(xx, fused_bp["Dense_1"], dt),
                                 approximate="tanh"),
                          fused_bp["Dense_2"], dt), tok,
        2 * 2 * bs * n_tok * d * 4 * d)

    # LN(fp32) + modulate pass
    shift, scale = rand((bs, d)), rand((bs, d))
    row("LN(fp32)+modulate pass",
        lambda xx: _modulate(ln_f32(xx), shift, scale), tok)

    # the patchify convolution (the HWIO kernel in F.conv2d's order)
    pat = fused_trees[0]["params"]["patchify"]
    w_pat = pat["kernel"].permute(3, 2, 0, 1)
    row("patchify conv",
        lambda xx: F.conv2d(xx.permute(0, 3, 1, 2), w_pat, pat["bias"],
                            stride=args.patch).permute(0, 2, 3, 1), x,
        2 * bs * n_tok * args.patch * args.patch * 1 * d)

    # ideal-GEMM ceiling probe: one torch.matmul with the forward's FLOPs
    fl_total = dit_flops(bs, n_tok, d, args.depth, args.heads)
    m = int(round((fl_total / 2 / 1024) ** 0.5))
    a, b = rand((m, 1024)), rand((1024, m))
    row(f"ideal GEMM {m}x1024x{m} (= fwd FLOPs)", lambda aa: aa @ b, a,
        2 * m * m * 1024)

    # ---- the decision number: full 50-step 3-expert DDIM ------------------
    # variants interleaved over rounds, the best per variant kept; each
    # sampler call returns its output's sum, forced once per round
    schedule = VPSchedule()
    w3 = torch.ones((args.experts,), dtype=torch.float32, device=device)

    def build_sampler(apply_fn, trees):
        stack = experts.ExpertStack(apply_fn, trees)

        def eps_fn(xx, tt):
            eps = stack(xx.to(dt), tt.to(dt))
            return compose.weighted(eps.float(), w3)

        def sample(key):
            xi = rng.Draws(key, device).normal((bs, img, img, 1))
            return finite(args, "samples",
                          samplers.ddim(eps_fn, schedule, xi, 50)).sum()

        return sample

    apply_by_tag = {"stock": (stock_model.apply, stock_trees),
                    "fused": (fused_model.apply, fused_trees),
                    "folded": (folded, fused_trees),
                    "pallas": (pallas, fused_trees),
                    "block": (block, fused_trees)}
    samplers_by_tag = {tag: build_sampler(*apply_by_tag[tag[0]])
                       for tag in SAMPLER_TAGS}
    for sample in samplers_by_tag.values():  # warm all first
        sample(0).item()
    reps_by_tag = sampler_ab(samplers_by_tag, bs, ROUNDS, CALLS)

    # ---- table ------------------------------------------------------------
    print(f"\nbs={bs} patch={args.patch} dim={d} depth={args.depth} "
          f"heads={args.heads} tokens={n_tok} reps={args.reps} "
          f"device={device_name(device)}")
    print(BLOCK_BATCHED)
    print("\n| op | ms | dev ms | TF/s |")
    print("|---|---|---|---|")
    for name, sec, dev, fl in rows:
        dev_s = "-" if dev is None else f"{dev:.3f}"
        print(f"| {name} | {sec * 1e3:.3f} | {dev_s} | {tflops(fl, dev)} |")
    print("\nfull 50-step DDIM 3-expert (img/s; mean +- halfspread over "
          "interleaved rounds, best in brackets):")
    means = {}
    for tag, reps in sorted(reps_by_tag.items()):
        mean = sum(reps) / len(reps)
        spread = (max(reps) - min(reps)) / 2
        means[tag] = mean
        print(f"  attn={tag[0]:6s} experts={tag[1]:6s}: "
              f"{mean:.1f} +- {spread:.1f}  [best {max(reps):.1f}]  "
              f"reps={[round(r, 1) for r in reps]}")
    # pairwise mean diffs against the best variant
    best_tag = max(means, key=means.get)
    for tag in sorted(means):
        if tag != best_tag:
            diff = means[best_tag] - means[tag]
            print(f"  {best_tag} vs {tag}: mean diff {diff:+.1f} img/s "
                  f"({100 * diff / means[tag]:+.1f}%)")


def attn_flops(b, t, d, h):
    # qkv + out projections dominate; score/value matmuls are 2*2*b*h*t*t*hd
    return 2 * b * t * d * 4 * d + 2 * 2 * b * t * t * d


def block_flops(b, t, d, h):
    return (attn_flops(b, t, d, h) + 2 * 2 * b * t * d * 4 * d
            + 2 * b * d * 6 * d)


def dit_flops(b, t, d, depth, h):
    return depth * block_flops(b, t, d, h)


if __name__ == "__main__":
    sys.exit(main())
