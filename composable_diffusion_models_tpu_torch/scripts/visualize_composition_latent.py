"""Reverse-composition trajectory of two or more 2-D latent experts against
the noised data: ``scripts/visualize_composition_latent.py``.

``--mode sum`` composes the experts' eps by their unnormalised sum,
``avg`` by fixed kappa 1/K, ``ito`` (two experts) by the divergence
kappa under the probability-flow ODE. ``--sampler em`` keeps the whole
Euler-Maruyama trajectory and draws six panels, t = 1, 0.8, ..., 0, each
against the data noised at t with the draws of ``fold_in(seed, step)``;
``ddim`` and ``ode`` draw the final state against the data. Sampling and
noising run on the device, the scatter on the host, into
``results/composition_trajectory_<mode>_<sampler>.png`` where matplotlib
is installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from composable_diffusion_models_tpu_torch import (compose, entry,
                                                   resolve_device, samplers)
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.rng import Draws, fold_in
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, build_dataset, build_model, finite, plot, profiled,
    start)
from composable_diffusion_models_tpu_torch.utils.config import get_config

T_PANELS = (1.0, 0.8, 0.6, 0.4, 0.2, 0.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Composed latent trajectory "
                                             "against the noised data.")
    ap.add_argument("--preset", default="mnist_latent2d")
    ap.add_argument("--pca", default=None,
                    help="PCA prefix (default: <out>/pca)")
    ap.add_argument("--experts", default='["latent_expert"]')
    ap.add_argument("--n_steps", type=int, default=500)
    ap.add_argument("--mode", default="sum", choices=["sum", "ito", "avg"],
                    help="composition: eps-sum | divergence-kappa | fixed "
                         "kappa 1/K")
    ap.add_argument("--sampler", default="em", choices=["em", "ddim", "ode"],
                    help="em = 6-panel trajectory; ddim/ode = final scatter")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


@torch.no_grad()  # not inference_mode: ito runs forward-mode AD
def trajectory(args, cfg, params_list, dev) -> torch.Tensor:
    """(steps + 1, 512, 2) under ``em``, else (1, 512, 2): the final
    state."""
    model = build_model(cfg)
    schedule = VPSchedule(kind=cfg.schedule.kind)
    k = len(params_list)
    kappa = compose.constant([1.0 / k if args.mode == "avg" else 1.0] * k,
                             torch.float32, dev)

    def eps_fn(x, t):
        return compose.fixed(torch.stack([model.apply(p, t, x)
                                          for p in params_list]), kappa)

    z_init = Draws(args.seed, dev).normal((512, 2))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.mode == "ito":
        if k != 2:
            raise ValueError("ito kappa composition takes 2 experts")
        # sigma-scaled scores s = -eps
        fns = tuple((lambda x, t, p=p: -model.apply(p, t, x))
                    for p in params_list)
        return samplers.ito_kappa_ode(fns, schedule, gen, z_init,
                                      args.n_steps)[None]
    if args.sampler == "ddim":
        return samplers.ddim(eps_fn, schedule, z_init, args.n_steps,
                             clip=None)[None]
    if args.sampler == "ode":
        return samplers.prob_flow_ode(
            lambda x, t: -eps_fn(x, t) / schedule.sigma(t), schedule,
            z_init, args.n_steps)[None]
    return samplers.euler_maruyama_traj(eps_fn, schedule, gen, z_init,
                                        args.n_steps)


def draw(path: str, args, traj: torch.Tensor, z_gt: torch.Tensor,
         noised: list) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    lim = float(z_gt.abs().max()) * 1.2
    gt = z_gt.cpu().numpy()
    if traj.shape[0] == 1:
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(*gt.T, s=3, alpha=0.3, label="data")
        ax.scatter(*traj[0].cpu().numpy().T, s=3, alpha=0.5, color="green",
                   label=f"composed ({args.mode}/{args.sampler})")
        axes = [ax]
    else:
        fig, axes = plt.subplots(1, len(T_PANELS), figsize=(24, 4))
        for ax, t, (step, xt) in zip(axes, T_PANELS, noised):
            ax.scatter(*xt.cpu().numpy().T, s=3, alpha=0.3,
                       label="noised data")
            ax.scatter(*traj[step].cpu().numpy().T, s=3, alpha=0.5,
                       color="green", label="composed")
            ax.set_title(f"t={t}")
    for ax in axes:
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.grid(True)
    axes[0].legend()
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    if args.pca is None:
        args.pca = os.path.join(args.out, "pca")
    device = start(args)
    dev = resolve_device(device)
    cfg = get_config(args.preset, overrides)
    mgr = CheckpointManager(args.out, cfg.name)
    schedule = VPSchedule(kind=cfg.schedule.kind)
    with profiled(args):
        params_list = [mgr.load(n, device=dev)["params"]
                       for n in json.loads(args.experts)]
        traj = finite(args, "trajectory",
                      trajectory(args, cfg, params_list, dev))
        # the data's latents for the comparison panels
        images, _ = build_dataset(cfg, fold_in(args.seed, 1), dev)
        z_gt = entry.load_pca(args.pca, dev).encode(images)
        noised = []
        if traj.shape[0] > 1:
            for t in T_PANELS:
                step = int((1.0 - t) * args.n_steps)
                noised.append((step, schedule.q_t(
                    z_gt, torch.full((z_gt.shape[0],), max(t, 1e-3),
                                     device=dev),
                    gen=Draws(fold_in(args.seed, step), dev).generator())[0]))
        path = os.path.join(
            mgr.results_dir,
            f"composition_trajectory_{args.mode}_{args.sampler}.png")
        if plot(path, lambda p: draw(p, args, traj, z_gt, noised)):
            print(f"trajectory panels saved to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
