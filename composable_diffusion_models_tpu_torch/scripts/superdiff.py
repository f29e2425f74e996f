"""SUPERDIFF OR / AND composition with the Ito density estimator over
discrete-DDPM experts: ``scripts/superdiff.py`` over ``entry.load_named``
and ``entry.sample_superdiff`` (every GroupNorm + SiLU through the
``groupnorm_silu`` kernel on the card). The initial noise comes from
``rng.Draws(seed)`` and the sampler's draws from a generator seeded with
``seed``. Writes ``results/superdiff_<operation>.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from composable_diffusion_models_tpu_torch import (builders, entry,
                                                   resolve_device)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.rng import Draws
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="SUPERDIFF composition of "
                                             "trained DDPM experts.")
    ap.add_argument("--preset", default="colored_mnist_guided")
    ap.add_argument("--experts", default='["expert_a","expert_b"]')
    ap.add_argument("--labels", default=None,
                    help="JSON per-expert label lists, e.g. [[0],[6]]")
    ap.add_argument("--operation", default="OR",
                    choices=["OR", "AND", "AVG", "FIXED"])
    ap.add_argument("--rigorous_and", action="store_true",
                    help="use the Prop.-6 linear-system AND (K=2)")
    ap.add_argument("--kappa", default=None,
                    help="JSON per-expert fixed kappa for --operation FIXED, "
                         "e.g. [0.7,0.3]")
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--bias", default="0.0",
                    help="scalar, or comma-separated per-expert biases "
                         "(e.g. '0.5,-0.5'). A non-zero scalar is rejected "
                         "in OR mode: softmax is shift-invariant, so it "
                         "would silently sweep nothing")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, overrides = ap.parse_known_args(argv)
    device = start(args)
    cfg = get_config(args.preset, overrides)
    names = json.loads(args.experts)
    n_slots = len(cfg.model.num_classes)
    labels = None
    if args.labels:
        labels = np.asarray(json.loads(args.labels), np.int64)
        if labels.shape != (len(names), n_slots):
            ap.error(f"--labels must be a {len(names)}x{n_slots} list "
                     f"(one label per expert per slot), got "
                     f"{tuple(labels.shape)}")
    bias_vals = [float(v) for v in str(args.bias).split(",")]
    if len(bias_vals) not in (1, len(names)):
        ap.error(f"--bias needs 1 or {len(names)} values")
    bias = bias_vals[0] if len(bias_vals) == 1 else tuple(bias_vals)
    if args.rigorous_and and args.operation not in ("OR", "AND"):
        ap.error("--rigorous_and supports --operation OR|AND only")
    dev = resolve_device(device)
    model = builders.build_model(cfg)
    with profiled(args):
        trees = entry.load_named(args.preset, names, args.out, overrides,
                                 device)
        shape = (cfg.sample.batch_size, cfg.data.img_size, cfg.data.img_size,
                 cfg.model.in_channels)
        out = entry.sample_superdiff(
            trees, Draws(args.seed, dev).normal(shape), labels,
            operation=args.operation, rigorous_and=args.rigorous_and,
            temp=args.temp, bias=bias,
            kappa=json.loads(args.kappa) if args.kappa else None,
            num_timesteps=cfg.schedule.num_timesteps, seed=args.seed,
            device=device, dtype=model.dtype or torch.float32, model=model)
        finite(args, "samples", out)
        path = viz.save_grid(out, os.path.join(
            CheckpointManager(args.out, cfg.name).results_dir,
            f"superdiff_{args.operation}.png"))
    print(f"SUPERDIFF {args.operation} samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
