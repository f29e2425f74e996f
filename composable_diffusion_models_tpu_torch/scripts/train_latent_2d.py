"""Train a 2-D PCA-latent ``ScoreMLP`` expert: ``scripts/train_latent_2d.py``
over ``entry.train_latent_2d`` (the dataset encoded through the ``matmul``
kernel on the card). Saves ``checkpoints/<name>_final`` and
``results/<name>_loss.npy``, and draws ``results/<name>_latents.png`` and
``<name>_loss.png`` where matplotlib is installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from composable_diffusion_models_tpu_torch import (builders, entry,
                                                   resolve_device)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, plot, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train a 2-D latent expert.")
    ap.add_argument("--preset", default="mnist_latent2d")
    ap.add_argument("--pca", default=None,
                    help="PCA prefix (default: <out>/pca)")
    ap.add_argument("--classes", default=None)
    ap.add_argument("--name", default="latent_expert")
    ap.add_argument("--out", default="outputs")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    if args.pca is None:
        args.pca = os.path.join(args.out, "pca")
    device = start(args)
    classes = json.loads(args.classes) if args.classes else None
    cfg = get_config(args.preset, overrides)
    if classes:
        cfg.data.classes = tuple(classes)
    mgr = CheckpointManager(args.out, cfg.name)

    def latents(path):
        # the encoded dataset, as the entry point encodes it for training
        images, (labels, *_) = builders.build_dataset(
            cfg, cfg.train.seed, resolve_device(device))
        z = entry.load_pca(args.pca, images.device).encode(images)
        viz.scatter2d(z, path, labels=labels.cpu().numpy(),
                      title="PCA latents", lim=float(z.abs().max()) * 1.1)

    with profiled(args):
        plot(os.path.join(mgr.results_dir, f"{args.name}_latents.png"),
             latents)
        params, losses, _ = entry.train_latent_2d(
            args.preset, pca=args.pca, classes=classes, name=args.name,
            out=args.out, overrides=overrides, device=device)
        finite(args, "params", params)
        finite(args, "losses", losses)
        plot(os.path.join(mgr.results_dir, f"{args.name}_loss.png"),
             lambda p: viz.plot_loss(losses, p))
    return 0


if __name__ == "__main__":
    sys.exit(main())
