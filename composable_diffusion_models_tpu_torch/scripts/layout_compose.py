"""Spatial-mask layout composition: ``scripts/layout_compose.py`` over
``entry.load_named`` and ``entry.sample_layout``: the first expert
everywhere, the second in a centred circle of ``--radius`` on top, label 0
in every slot (every GroupNorm + SiLU through the ``groupnorm_silu`` kernel
on the card). Draws as in ``superdiff``. Writes
``results/layout_composed.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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
    ap = argparse.ArgumentParser(description="Layout composition of two "
                                             "trained experts.")
    ap.add_argument("--preset", default="colored_mnist_guided")
    ap.add_argument("--experts", default='["expert_a","expert_b"]')
    ap.add_argument("--radius", type=int, default=None)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    cfg = get_config(args.preset, overrides)
    dev = resolve_device(device)
    model = builders.build_model(cfg)
    with profiled(args):
        trees = entry.load_named(args.preset, json.loads(args.experts),
                                 args.out, overrides, device)
        size = cfg.data.img_size
        shape = (cfg.sample.batch_size, size, size, cfg.model.in_channels)
        out = entry.sample_layout(
            trees, Draws(args.seed, dev).normal(shape), radius=args.radius,
            num_timesteps=cfg.schedule.num_timesteps, seed=args.seed,
            device=device, dtype=model.dtype or torch.float32, model=model)
        finite(args, "samples", out)
        path = viz.save_grid(out, os.path.join(
            CheckpointManager(args.out, cfg.name).results_dir,
            "layout_composed.png"))
    print(f"layout-composed samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
