"""Classifier-free-guidance composition of (digit, color) with one
dual-conditioned expert: ``scripts/compose_cfg.py`` over
``entry.compose_cfg``. On ``ito_cross_attention`` the cross-attention runs
through the ``flash_attention`` kernel. Writes
``results/cfg_d<digit>_c<color>.png``.
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
    ap = argparse.ArgumentParser(description="CFG composition with one "
                                             "dual-conditioned expert.")
    ap.add_argument("--preset", default="colored_mnist_guided")
    ap.add_argument("--name", default="guided")
    ap.add_argument("--digit", type=int, default=3)
    ap.add_argument("--color", type=int, default=6)
    ap.add_argument("--guidance", default="[2.0,2.0]",
                    help="JSON per-condition guidance weights")
    ap.add_argument("--sampler", default="ddim", choices=["ddim", "em"])
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        out = entry.compose_cfg(
            args.preset, args.name, digit=args.digit, color=args.color,
            guidance=json.loads(args.guidance), sampler=args.sampler,
            out=args.out, seed=args.seed, overrides=overrides, device=device)
        finite(args, "samples", out)
    path = os.path.join(
        CheckpointManager(args.out,
                          get_config(args.preset, overrides).name).results_dir,
        f"cfg_d{args.digit}_c{args.color}.png")
    print(f"CFG-composed samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
