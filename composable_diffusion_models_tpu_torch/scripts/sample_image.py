"""Sample from a trained image expert: ``scripts/sample_image.py`` over
``entry.sample_image``. Writes ``results/<name>_samples.png``.

A model that predicts x0 or v samples through DDIM only: any other sampler
exits with the script's message.
"""

from __future__ import annotations

import argparse
import os
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Sample one trained expert.")
    ap.add_argument("--preset", default="mnist_image")
    ap.add_argument("--name", default="expert")
    ap.add_argument("--sampler", default=None,
                    choices=[None, "em", "ddim", "ode", "dpmpp", "picard"])
    ap.add_argument("--eta", type=float, default=0.0,
                    help="stochastic-DDIM noise level (0 = deterministic)")
    ap.add_argument("--corrector_steps", type=int, default=0,
                    help="Langevin corrector steps per DDIM level "
                         "(predictor-corrector, Song et al. 2021 alg. 4)")
    ap.add_argument("--corrector_snr", type=float, default=0.16)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    cfg = get_config(args.preset, overrides)
    if args.sampler:
        cfg.sample.sampler = args.sampler
    if (cfg.train.predict != "eps"
            and cfg.sample.sampler not in (None, "", "ddim")):
        raise SystemExit(f"predict='{cfg.train.predict}' models sample via "
                         "ddim only (the flag is threaded through "
                         "samplers.ddim; em/ode/picard/dpmpp consume eps "
                         "closures)")
    with profiled(args):
        out = entry.sample_image(
            args.preset, args.name, sampler=args.sampler, eta=args.eta,
            corrector_steps=args.corrector_steps,
            corrector_snr=args.corrector_snr, seed=args.seed, out=args.out,
            overrides=overrides, device=device)
        finite(args, "samples", out)
    path = os.path.join(CheckpointManager(args.out, cfg.name).results_dir,
                        f"{args.name}_samples.png")
    print(f"samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
