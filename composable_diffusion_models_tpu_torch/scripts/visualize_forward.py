"""Forward-process diagnostic: ``scripts/visualize_forward.py``. The PCA
latents of a preset's dataset (or, with ``--toy2d``, raw 4-Gaussian-grid
points under the sigma = t ``jax_faithful`` schedule, plot limits +-3)
noised by q_t at t in {0.001, 0.2, 0.4, 0.6, 0.8, 1}, each t's noise drawn
on the device from ``fold_in(seed, int(1000 t))``; the six scatter panels
are drawn on the host into ``--out`` where matplotlib is installed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from composable_diffusion_models_tpu_torch import (data, entry,
                                                   resolve_device)
from composable_diffusion_models_tpu_torch.rng import Draws, fold_in
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, build_dataset, finite, plot, profiled, start)
from composable_diffusion_models_tpu_torch.utils.config import get_config

T_GRID = (1e-3, 0.2, 0.4, 0.6, 0.8, 1.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Scatter the forward process "
                                             "over a time grid.")
    ap.add_argument("--preset", default="mnist_latent2d")
    ap.add_argument("--pca", default="outputs/pca")
    ap.add_argument("--toy2d", action="store_true",
                    help="2D toy forward demo, no PCA")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--out", default="outputs/forward_diag.png")
    add_runtime_flags(ap)
    return ap


def forward_panels(schedule: VPSchedule, z: torch.Tensor, key: int) -> list:
    """(t, x_t) on the device for each t of ``T_GRID``."""
    dev = z.device
    return [(t, schedule.q_t(
        z, torch.full((z.shape[0],), t, device=dev),
        gen=Draws(fold_in(key, int(t * 1000)), dev).generator())[0])
        for t in T_GRID]


def draw_panels(path: str, panels, labels: np.ndarray, lim: float) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
    for ax, (t, xt) in zip(axes, panels):
        xt = xt.cpu().numpy()
        for lab in np.unique(labels):
            ax.scatter(*xt[labels == lab].T, s=3, alpha=0.3)
        ax.set_title(f"t={t}")
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.grid(True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    dev = resolve_device(device)
    cfg = get_config(args.preset, overrides)
    key = cfg.train.seed
    with profiled(args):
        if args.toy2d:
            schedule = VPSchedule(kind="jax_faithful")
            z = data.toy2d(fold_in(key, 1), args.n, up=True, device=dev)
            labels = np.zeros((args.n,), np.int64)
            lim = 3.0
        else:
            schedule = VPSchedule(kind=cfg.schedule.kind)
            images, (labels, *_) = build_dataset(cfg, key, dev)
            z = entry.load_pca(args.pca, dev).encode(images)
            labels = labels.cpu().numpy()
            lim = float(z.abs().max()) * 1.2
        panels = forward_panels(schedule, z, key)
        finite(args, "panels", [xt for _, xt in panels])
        if plot(args.out, lambda p: draw_panels(p, panels, labels, lim)):
            print(f"forward-process panels saved to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
