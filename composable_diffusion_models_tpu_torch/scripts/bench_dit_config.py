"""Throughput of candidate DiT flagship configurations on the headline
workload (MNIST 28x28, 50-step DDIM, 3 composed experts):
``scripts/bench_dit_config.py`` on the port. One JSON row per
(configuration, batch size), then the best.

    python -m composable_diffusion_models_tpu_torch.scripts.bench_dit_config \\
        --configs p7_d256_l6 --batch_sizes 256,512,1024

Each configuration ``p<patch>_d<dim>_l<depth>`` (8 heads) serves three
random bf16 experts (``convert.init_params``, seeds 0-2) through
``entry.sample``: the folded DiT, each block one ``fused_dit_block``
launch. That is the route the port serves on the card, and the one this
command line times; the script timed ``model.apply`` under ``jit``, which
is what the TPU served.

Timing: one warm call of the exact sampler, then ``--iters`` calls on the
host clock, ending in a synchronise. GFLOP per image is
``entry.dit_gflop_per_image`` x 3 experts x ``--n_steps``, and MFU is
against ``--peak_tflops``, by default the H100's dense bf16 peak (989
TFLOP/s; the script's 195 was a TPU's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from composable_diffusion_models_tpu_torch import convert, entry, rng
from composable_diffusion_models_tpu_torch.frontier import (
    H100_BF16_PEAK_TFLOPS)
from composable_diffusion_models_tpu_torch.models.dit import DiT
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, profiled, start)

N_EXPERTS = 3


def gflop_per_image(model: DiT, n_steps: int) -> float:
    """Analytic GFLOP per sampled image: three experts' forwards a step."""
    return entry.dit_gflop_per_image(model) * N_EXPERTS * n_steps


def measure(patch: int, dim: int, depth: int, batch_size: int,
            iters: int, n_steps: int, peak_tflops: float,
            device=None, debug_nans: bool = False) -> dict:
    """images/s of ``entry.sample`` over three random bf16 experts of the
    configuration at ``batch_size``, and what it implies. ``device=None``
    is the CUDA card. ``debug_nans``: raise ``FloatingPointError`` where a
    timed batch holds a NaN or an Inf."""
    dev = torch.device("cuda" if device is None else device)
    model = DiT(patch=patch, dim=dim, depth=depth, in_channels=1)
    params_list = entry.load_experts(
        [convert.from_flax(convert.init_params(model, seed=i))
         for i in range(N_EXPERTS)], dev, torch.bfloat16)

    def sample(key):
        x = rng.Draws(key, dev).normal((batch_size, 28, 28, 1))
        return entry.sample(params_list, x, n_steps, device=dev,
                            model=model)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sample(0)                                # warm the exact call
    sync()
    t0 = time.perf_counter()
    outs = [sample(rng.fold_in(0, 1 + i)) for i in range(iters)]
    sync()
    dt = time.perf_counter() - t0
    if debug_nans and not all(bool(torch.isfinite(o).all()) for o in outs):
        raise FloatingPointError("--debug_nans: samples hold a NaN or an "
                                 "Inf")
    ips = batch_size * iters / dt
    gfi = gflop_per_image(model, n_steps)
    return {
        "patch": patch, "dim": dim, "depth": depth,
        "batch_size": batch_size, "n_steps": n_steps,
        "images_per_sec": round(ips, 1),
        "gflop_per_image": round(gfi, 2),
        "implied_tflops": round(ips * gfi / 1e3, 1),
        "mfu": round(ips * gfi / 1e3 / peak_tflops, 3),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Throughput of DiT flagship "
                                             "configurations.")
    ap.add_argument("--configs", default="p7_d256_l6",
                    help="comma list of p<patch>_d<dim>_l<depth>")
    ap.add_argument("--batch_sizes", default="256,512,1024")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--n_steps", type=int, default=50)
    ap.add_argument("--peak_tflops", type=float,
                    default=H100_BF16_PEAK_TFLOPS,
                    help="dense bf16 peak the MFU is taken against (the "
                         "H100's)")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = start(args)
    rows = []
    with profiled(args):
        for cfg in args.configs.split(","):
            parts = {p[0]: int(p[1:]) for p in cfg.split("_")}
            for bs in [int(b) for b in args.batch_sizes.split(",")]:
                r = measure(parts["p"], parts["d"], parts["l"], bs,
                            args.iters, args.n_steps, args.peak_tflops,
                            device, args.debug_nans)
                rows.append(r)
                print(json.dumps(r))
    best = max(rows, key=lambda r: r["images_per_sec"])
    print("# best:", json.dumps(best))
    return 0


if __name__ == "__main__":
    sys.exit(main())
