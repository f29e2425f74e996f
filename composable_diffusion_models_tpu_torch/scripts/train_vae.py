"""Train the beta-VAE codec and its digit-conditional latent expert:
``scripts/train_vae.py`` over ``entry.train_vae``. Saves {"vae", "mlp",
"latent_dim"} as ``checkpoints/<name>_final`` under
``<out>/<preset name>_vae/run_0``.
"""

from __future__ import annotations

import argparse
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the beta-VAE and its "
                                             "latent expert.")
    ap.add_argument("--preset", default="mnist_image")
    ap.add_argument("--latent_dim", type=int, default=10)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--vae_steps", type=int, default=2000)
    ap.add_argument("--diff_steps", type=int, default=2000)
    ap.add_argument("--name", default="vae")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--sanity", action="store_true")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        run = entry.train_vae(
            args.preset, latent_dim=args.latent_dim, beta=args.beta,
            vae_steps=args.vae_steps, diff_steps=args.diff_steps,
            name=args.name, sanity=args.sanity, out=args.out,
            overrides=overrides, device=device)
        for k in ("vae", "mlp", "vae_losses", "diff_losses"):
            finite(args, k, run[k])
    if run["vae_losses"].shape[0]:
        print(f"VAE final loss: {float(run['vae_losses'][-1]):.2f}")
    print(f"saved VAE+latent-diffusion: {run['path']}  "
          f"diff_loss={float(run['diff_losses'][-1]):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
