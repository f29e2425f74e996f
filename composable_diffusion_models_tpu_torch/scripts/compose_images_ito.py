"""Ito-kappa (equal-density AND) composition of a gray shape expert and a
color expert over the 3 x 3 labels: ``scripts/compose_images_ito.py`` over
``entry.compose_images_ito``, which prints where it wrote
``results/ito_composition_grid.png``. The divergences are forward-mode
jvps, so both UNets run their GroupNorm in PyTorch ops: no kernel runs.
"""

from __future__ import annotations

import argparse
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Ito-kappa composition of a "
                                             "shape and a color expert.")
    ap.add_argument("--preset", default="shapes_ddim")
    ap.add_argument("--shape_expert", default="shape_expert")
    ap.add_argument("--color_expert", default="color_expert")
    ap.add_argument("--n_steps", type=int, default=1000)
    ap.add_argument("--bs", type=int, default=1)
    ap.add_argument("--probe", default="gaussian",
                    choices=["gaussian", "rademacher"])
    ap.add_argument("--gray_protocol", default="white",
                    choices=["white", "luma", "luma_norm"],
                    help="the 1-channel shape expert's training protocol "
                         "(data.gray_mode; see compose_images_ddim)")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        out = entry.compose_images_ito(
            args.preset, args.shape_expert, args.color_expert,
            n_steps=args.n_steps, bs=args.bs, probe=args.probe,
            gray_protocol=args.gray_protocol, out=args.out, seed=args.seed,
            overrides=overrides, device=device)
        finite(args, "samples", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
