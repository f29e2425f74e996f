"""Compose K trained image experts by a weighted eps blend:
``scripts/compose_scores.py`` over ``entry.compose_scores``. On the card
the blend runs through the ``blend_eps`` kernel. Writes
``results/composed_<names>.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Compose trained experts by "
                                             "a weighted eps blend.")
    ap.add_argument("--preset", default="mnist_image")
    ap.add_argument("--experts", default='["expert_a","expert_b"]',
                    help="JSON list of checkpoint names")
    ap.add_argument("--weights", default=None, help="JSON list of weights")
    ap.add_argument("--sampler", default="em", choices=["em", "ddim", "dpmpp"])
    ap.add_argument("--corrector_steps", type=int, default=0,
                    help="Langevin corrector steps per DDIM level (the "
                         "Du et al. 2023 fix for composed score fields); "
                         "ddim sampler only")
    ap.add_argument("--corrector_snr", type=float, default=0.16)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    names = json.loads(args.experts)
    with profiled(args):
        out = entry.compose_scores(
            args.preset, names,
            weights=json.loads(args.weights) if args.weights else None,
            sampler=args.sampler, corrector_steps=args.corrector_steps,
            corrector_snr=args.corrector_snr, seed=args.seed, out=args.out,
            overrides=overrides, device=device)
        finite(args, "samples", out)
    path = os.path.join(
        CheckpointManager(args.out,
                          get_config(args.preset, overrides).name).results_dir,
        f"composed_{'_'.join(names)}.png")
    print(f"composed samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
