"""Per-shape-class PCA-latent experts and their composition in the latent,
as one command: ``scripts/latent_shape_experts.py``.

1. Grayscale shapes -> PCA(latent_dim), saved as
   ``checkpoints/pca_grayscale_*.npy`` (``--no_train`` reads it back).
2. One ``ScoreMLP`` expert per shape class, the initial tree drawn with
   ``fold_in(seed, c)`` and trained with ``fold_in(seed, 10 + c)``
   (``--no_train`` loads ``latent_expert_class<c>``).
3. The ``--pair`` composed in the latent by each of ``--ops``
   (``entry.sample_latent``: ``ito``, the divergence kappa with probes from
   ``fold_in(seed, 88)``; ``avg``, kappa 0.5 under the probability-flow ODE;
   ``ddim``, the unit-weight eps blend through the ``blend_eps`` kernel) from
   the initial latents of ``fold_in(seed, 77)``, decoded through the
   ``matmul`` kernel.

One schedule kind (``--schedule.kind``) serves both the training and the
sampling. Writes ``results/latent_composed_<op>.png`` per operator and,
where matplotlib is installed, ``latents_by_class.png`` and the
``latent_composed_<op>_scatter.png`` overlays, and
``logs/latent_shape_experts_config.yaml``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from composable_diffusion_models_tpu_torch import (data, entry,
                                                   resolve_device, train)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.convert import flax_init
from composable_diffusion_models_tpu_torch.models import ScoreMLP
from composable_diffusion_models_tpu_torch.ops import pca as pca_codec
from composable_diffusion_models_tpu_torch.rng import Draws, fold_in
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, plot, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import (get_config,
                                                                save_yaml)

KNOWN_OPS = ("ito", "avg", "ddim")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Per-class latent experts and "
                                             "their composition.")
    ap.add_argument("--preset", default="shapes_latent")
    ap.add_argument("--ops", default="ito,avg,ddim",
                    help="comma list of latent composition operators")
    ap.add_argument("--pair", default="0,1",
                    help="two shape-class experts to compose "
                         "(0=circle 1=square 2=triangle)")
    ap.add_argument("--n_samples", type=int, default=512)
    ap.add_argument("--no_train", action="store_true",
                    help="reuse existing expert checkpoints + PCA")
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, overrides = ap.parse_known_args(argv)
    device = start(args)
    cfg = get_config(args.preset, overrides)
    cfg.train.sanity = cfg.train.sanity or args.sanity
    cfg.apply_sanity()
    if args.sanity:
        args.n_samples = 64
        cfg.sample.n_steps = min(cfg.sample.n_steps, 50)
    ops = args.ops.split(",")
    bad = [o for o in ops if o not in KNOWN_OPS]
    if bad:
        ap.error(f"unknown ops {bad}; choose from {KNOWN_OPS}")
    dev = resolve_device(device)
    key = cfg.train.seed
    size, dim = cfg.data.img_size, cfg.model.latent_dim
    schedule = VPSchedule(kind=cfg.schedule.kind)
    mgr = CheckpointManager(args.out, cfg.name)

    with profiled(args):
        # 1. grayscale shapes -> PCA latents
        imgs, shape_labels, _ = data.make_shapes_dataset(
            cfg.data.n, size, grayscale=True, device=dev)
        pca_prefix = os.path.join(mgr.ckpt_dir, "pca_grayscale")
        if args.no_train and os.path.exists(pca_prefix + "_mean.npy"):
            pca = pca_codec.load_pca(pca_prefix, dev)
        else:
            pca = pca_codec.fit_pca(imgs, dim)
            pca_codec.save_pca(pca_prefix, pca)
        z_all = pca.encode(imgs)
        lim = float(z_all.abs().max())
        plot(os.path.join(mgr.results_dir, "latents_by_class.png"),
             lambda p: viz.scatter2d(z_all, p,
                                     labels=shape_labels.cpu().numpy(),
                                     title="PCA latents by shape class",
                                     lim=lim * 1.1))

        # 2. one ScoreMLP expert per shape class
        model = ScoreMLP(hidden=cfg.model.hidden, depth=cfg.model.depth,
                         out_dim=dim)
        params = {}
        for c in range(3):
            name = f"latent_expert_class{c}"
            if args.no_train:
                params[c] = mgr.load(name, device=dev)["params"]
                continue
            z_c = z_all[shape_labels == c]
            if z_c.shape[0] == 0:  # the reference's empty-class guard
                raise ValueError(f"no data for shape class {c}")
            print(f"training latent expert for class {c} "
                  f"({z_c.shape[0]} latents) ...")
            p, losses = train.train_expert(
                fold_in(key, 10 + c), model.apply,
                flax_init(model, fold_in(key, c), dev), schedule, z_c,
                steps=cfg.train.steps,
                batch_size=min(cfg.train.batch_size, z_c.shape[0]),
                lr=cfg.train.lr, time_first=True,
                steps_per_scan=min(200, cfg.train.steps))
            print(f"  final loss {float(losses[-1]):.4f}")
            finite(args, name, p)
            mgr.save(name, {"params": p, "step": cfg.train.steps})
            params[c] = p

        # 3. the pair composed in the latent, decoded, drawn
        a, b = (int(v) for v in args.pair.split(","))
        x_init = Draws(fold_in(key, 77), dev).normal((args.n_samples, dim))
        for op in ops:
            z_gen, decoded = entry.sample_latent(
                [params[a], params[b]], pca, x_init, op=op,
                n_steps=cfg.sample.n_steps, seed=fold_in(key, 88),
                device=device, model=model, schedule=schedule)
            finite(args, f"{op} latents", z_gen)
            grid = viz.save_grid(
                decoded[:64],
                os.path.join(mgr.results_dir, f"latent_composed_{op}.png"),
                nrow=8)
            both = torch.cat([z_all, z_gen])
            tags = torch.cat([torch.zeros(z_all.shape[0]),
                              torch.ones(z_gen.shape[0])]).int().numpy()
            plot(os.path.join(mgr.results_dir,
                              f"latent_composed_{op}_scatter.png"),
                 lambda p, both=both, tags=tags, op=op: viz.scatter2d(
                     both, p, labels=tags,
                     title=f"data (0) vs {op}-composed (1) latents",
                     lim=lim * 1.3))
            print(f"[{op}] decoded grid -> {grid}")
    save_yaml(cfg, os.path.join(mgr.logs_dir,
                                "latent_shape_experts_config.yaml"))
    print(f"composed classes ({a}, {b}) with ops {ops}; artifacts in "
          f"{mgr.results_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
