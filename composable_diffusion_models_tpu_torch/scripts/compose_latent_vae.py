"""Compose the VAE's latent expert over digit conditions and decode:
``scripts/compose_latent_vae.py`` over ``entry.compose_latent_vae``.
``--mode weighted`` blends the conditional forwards through the
``blend_eps`` kernel on the card. Writes
``results/vae_composed_<mode>.png``.
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
    ap = argparse.ArgumentParser(description="Compose VAE-latent experts "
                                             "and decode.")
    ap.add_argument("--preset", default="mnist_image")
    ap.add_argument("--name", default="vae")
    ap.add_argument("--digits", default="[3,5]",
                    help="JSON digit conditions to compose")
    ap.add_argument("--mode", default="cfg", choices=["cfg", "weighted"])
    ap.add_argument("--guidance", type=float, default=2.0)
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--latent_dim", type=int, default=10)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        imgs = entry.compose_latent_vae(
            args.preset, args.name, digits=json.loads(args.digits),
            mode=args.mode, guidance=args.guidance, bs=args.bs,
            latent_dim=args.latent_dim, seed=args.seed, out=args.out,
            overrides=overrides, device=device)
        finite(args, "images", imgs)
    mgr = CheckpointManager(args.out,
                            f"{get_config(args.preset, overrides).name}_vae")
    path = os.path.join(mgr.results_dir, f"vae_composed_{args.mode}.png")
    print(f"VAE-latent composed samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
