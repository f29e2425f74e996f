"""Compose a gray shape expert and an RGB color expert with DDIM over the
3 x 3 labels: ``scripts/compose_images_ddim.py`` over
``entry.sample_gray_color``, the two class-conditional UNets (the preset's
base and widths) read by name. Combination (s, c) starts from the noise of
``rng.Draws(fold_in(seed, 3 s + c))``. ``--op proj`` needs
``--gray_protocol luma_norm``. Writes ``results/ddim_composition_grid.png``
(3 bs a row).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from composable_diffusion_models_tpu_torch import entry, resolve_device
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.models import UNet
from composable_diffusion_models_tpu_torch.rng import Draws, fold_in
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="DDIM composition of a shape "
                                             "and a color expert.")
    ap.add_argument("--preset", default="shapes_ddim")
    ap.add_argument("--shape_expert", default="shape_expert")
    ap.add_argument("--color_expert", default="color_expert")
    ap.add_argument("--w_shape", type=float, default=1.0)
    ap.add_argument("--w_color", type=float, default=1.0)
    ap.add_argument("--bs", type=int, default=1)
    ap.add_argument("--gray_protocol", default="white",
                    choices=["white", "luma", "luma_norm"],
                    help="how the 1-channel shape expert was trained "
                         "(data.gray_mode): 'white' = white-on-black; "
                         "'luma' = trained on luma(RGB data); 'luma_norm' = "
                         "trained on the unit-norm projection (see "
                         "experts.rgb_to_gray)")
    ap.add_argument("--op", default="avg", choices=["avg", "proj"],
                    help="avg = channel-broadcast weighted blend; proj = "
                         "projection substitution (compose.projected; needs "
                         "--gray_protocol luma_norm)")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, overrides = ap.parse_known_args(argv)
    device = start(args)
    if args.op == "proj" and args.gray_protocol != "luma_norm":
        ap.error("--op proj needs --gray_protocol luma_norm (the gray "
                 "expert must estimate exactly P eps)")
    cfg = get_config(args.preset, overrides)
    dev = resolve_device(device)
    size = cfg.data.img_size
    mgr = CheckpointManager(args.out, cfg.name)
    shape_model, color_model = (
        UNet(in_channels=ch, base_dim=cfg.model.base_dim,
             channel_mults=tuple(cfg.model.channel_mults), num_classes=(3,))
        for ch in (1, 3))
    with profiled(args):
        sp, cp = (mgr.load(n, device=dev)["params"]
                  for n in (args.shape_expert, args.color_expert))
        grids = []
        for s_lab in range(3):
            for c_lab in range(3):
                x = Draws(fold_in(args.seed, 3 * s_lab + c_lab),
                          dev).normal((args.bs, size, size, 3))
                grids.append(entry.sample_gray_color(
                    sp, cp, x, torch.full((args.bs,), s_lab, device=dev),
                    torch.full((args.bs,), c_lab, device=dev), op=args.op,
                    gray_protocol=args.gray_protocol, w_shape=args.w_shape,
                    w_color=args.w_color, n_steps=cfg.sample.n_steps,
                    device=device, shape_model=shape_model,
                    color_model=color_model,
                    schedule=VPSchedule(kind=cfg.schedule.kind)))
        out = finite(args, "samples", torch.cat(grids))
        path = viz.save_grid(out, os.path.join(
            mgr.results_dir, "ddim_composition_grid.png"), nrow=3 * args.bs)
    print(f"3x3 composition grid saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
