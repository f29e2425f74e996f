"""Fit the PCA latent codec on a preset's dataset: ``scripts/fit_pca.py``
over ``entry.fit_pca``, which prints the explained variance and writes
``<out>/<name>_mean.npy``, ``_components.npy`` and
``_explained_variance.npy``.
"""

from __future__ import annotations

import argparse
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Fit the PCA latent codec.")
    ap.add_argument("--preset", default="mnist_latent2d")
    ap.add_argument("--components", type=int, default=2)
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--name", default="pca")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        pca = entry.fit_pca(args.preset, args.components, out=args.out,
                            name=args.name, overrides=overrides,
                            device=device)
        finite(args, "pca", [pca.mean, pca.components,
                             pca.explained_variance])
    return 0


if __name__ == "__main__":
    sys.exit(main())
