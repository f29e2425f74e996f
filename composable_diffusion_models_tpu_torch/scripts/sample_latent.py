"""Sample from 2-D latent experts and decode through the PCA:
``scripts/sample_latent.py`` over ``entry.sample_latent`` (op "em"): the
experts read by name and the codec from ``--pca``, Euler-Maruyama in the
latent with the experts' eps blended through the ``blend_eps`` kernel, the
decode through ``matmul``. Writes ``results/latent_decoded.png`` and, where
matplotlib is installed, the scatter ``results/latent_samples.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from composable_diffusion_models_tpu_torch import (builders, entry,
                                                   resolve_device)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.rng import Draws
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, plot, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Sample 2-D latent experts and "
                                             "decode.")
    ap.add_argument("--preset", default="mnist_latent2d")
    ap.add_argument("--pca", default=None,
                    help="PCA prefix (default: <out>/pca)")
    ap.add_argument("--experts", default='["latent_expert"]')
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    if args.pca is None:
        args.pca = os.path.join(args.out, "pca")
    device = start(args)
    dev = resolve_device(device)
    cfg = get_config(args.preset, overrides)
    mgr = CheckpointManager(args.out, cfg.name)
    with profiled(args):
        trees = [mgr.load(n, device=dev)["params"]
                 for n in json.loads(args.experts)]
        pca = entry.load_pca(args.pca, dev)
        z_init = Draws(args.seed, dev).normal((cfg.sample.batch_size, 2))
        z, imgs = entry.sample_latent(
            trees, pca, z_init, op="em", n_steps=cfg.sample.n_steps,
            weights=json.loads(args.weights) if args.weights else None,
            xi=cfg.sample.xi, seed=args.seed, device=device,
            model=builders.build_model(cfg),
            schedule=VPSchedule(kind=cfg.schedule.kind))
        finite(args, "latents", z)
        plot(os.path.join(mgr.results_dir, "latent_samples.png"),
             lambda p: viz.scatter2d(z, p, title="latent samples"))
        path = viz.save_grid(imgs, os.path.join(mgr.results_dir,
                                                "latent_decoded.png"))
    print(f"decoded samples saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
