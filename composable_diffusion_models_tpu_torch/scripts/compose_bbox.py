"""Three-factor (shape, color, bbox) composition as one command:
``scripts/compose_bbox.py``.

1. Three single-factor class-conditional UNets (3 classes each, the
   preset's base and widths) on ``data.make_shapes_bbox_dataset`` with the
   preset's holdout: the initial tree of factor i drawn with
   ``fold_in(seed, i)``, trained with ``fold_in(seed, 10 + i)`` on the
   preset's DDPM schedule and saved as ``<factor>_expert``
   (``--no_train`` loads them).
2. The 27 (shape, color, bbox) combinations, ``--bs`` each, by the K = 3
   ``compose.weighted`` blend under ancestral DDPM
   (``entry.sample_ancestral``, every GroupNorm + SiLU through the
   ``groupnorm_silu`` kernel on the card), combination n keyed
   ``fold_in(seed, 100 + n)`` (its initial noise from ``rng.Draws`` of
   that key, its steps' draws from a generator seeded with it).

``--sanity`` cuts the config (``Config.apply_sanity``), the batch to 2
and the timesteps to 20. Writes ``results/bbox_composition_grid.png``
(3 bs a row) and ``logs/compose_bbox_config.yaml``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from composable_diffusion_models_tpu_torch import (data, entry,
                                                   resolve_device, train)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.convert import (flax_init,
                                                           unet_torch_layout)
from composable_diffusion_models_tpu_torch.models import UNet
from composable_diffusion_models_tpu_torch.rng import Draws, fold_in
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, build_schedule, finite, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import (get_config,
                                                                save_yaml)

FACTORS = ("shape", "color", "bbox")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train three single-factor "
                                             "experts and compose them.")
    ap.add_argument("--preset", default="shapes_bbox")
    ap.add_argument("--weights", default="[1.0,1.0,1.0]",
                    help="JSON [w_shape, w_color, w_bbox]")
    ap.add_argument("--bs", type=int, default=4,
                    help="samples per combination in the output grid")
    ap.add_argument("--no_train", action="store_true",
                    help="reuse existing expert checkpoints")
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    cfg = get_config(args.preset, overrides)
    cfg.train.sanity = cfg.train.sanity or args.sanity
    cfg.apply_sanity()
    if args.sanity:
        args.bs = 2
        cfg.sample.n_steps = min(cfg.sample.n_steps, 20)
        cfg.schedule.num_timesteps = min(cfg.schedule.num_timesteps, 20)
    dev = resolve_device(device)
    key = cfg.train.seed
    size = cfg.data.img_size
    schedule = build_schedule(cfg)
    mgr = CheckpointManager(args.out, cfg.name)
    holdout = [tuple(h) for h in cfg.data.holdout]
    model = UNet(in_channels=3, base_dim=cfg.model.base_dim,
                 channel_mults=tuple(cfg.model.channel_mults),
                 num_classes=(3,))

    with profiled(args):
        imgs, *factor_labels = data.make_shapes_bbox_dataset(
            cfg.data.n, size, holdout=holdout, device=dev)
        params = []
        for i, fac in enumerate(FACTORS):
            name = f"{fac}_expert"
            if args.no_train:
                params.append(mgr.load(name, device=dev)["params"])
                continue
            print(f"training {fac} expert ...")
            p, losses = train.train_expert(
                fold_in(key, 10 + i), model.apply,
                unet_torch_layout(flax_init(model, fold_in(key, i), dev)),
                schedule, imgs, (factor_labels[i],), steps=cfg.train.steps,
                batch_size=cfg.train.batch_size, lr=cfg.train.lr)
            print(f"  final loss {float(losses[-1]):.4f}")
            finite(args, name, p)
            mgr.save(name, {"params": p, "step": cfg.train.steps})
            params.append(p)

        weights = json.loads(args.weights)
        bs = args.bs
        grids = []
        combos = [(s, c, b) for s in range(3) for c in range(3)
                  for b in range(3)]
        for n, (s, c, b) in enumerate(combos):
            k = fold_in(key, 100 + n)
            labels = torch.tensor([[s] * bs, [c] * bs, [b] * bs],
                                  device=dev)
            grids.append(entry.sample_ancestral(
                params, Draws(k, dev).normal((bs, size, size, 3)), labels,
                weights=weights, num_timesteps=cfg.schedule.num_timesteps,
                seed=k, device=device, model=model))
            if (s, c) in holdout:
                print(f"held-out combo (shape={s}, color={c}, bbox={b}) "
                      "sampled")
        grid = finite(args, "samples", torch.cat(grids))
        path = viz.save_grid(grid, os.path.join(
            mgr.results_dir, "bbox_composition_grid.png"), nrow=3 * bs)
    save_yaml(cfg, os.path.join(mgr.logs_dir, "compose_bbox_config.yaml"))
    print(f"27-combination (3 shapes x 3 colors x 3 bbox colors) grid "
          f"saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
