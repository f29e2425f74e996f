"""Log-likelihood and bits/dim of a trained expert by the probability-flow
ODE: ``scripts/eval_nll.py`` over ``entry.eval_nll``, the expert read by
name and the scored set drawn from the preset's dataset with
``fold_in(seed, 7)``. Writes ``results/nll_<name>.json``. A DDPM schedule,
or v-prediction off the ``stable`` kind, exits with the script's message.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from composable_diffusion_models_tpu_torch import builders, entry
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.schedules import VPSchedule
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.utils.config import get_config

# the script's report, in its order
REPORT_KEYS = ("n_steps", "n_probes", "probe", "exact", "t_max",
               "schedule_kind", "nll_nats_mean", "bits_per_dim_mean",
               "bits_per_dim_sem")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="NLL and bits/dim of a trained "
                                             "expert.")
    ap.add_argument("--preset", default="mnist_image")
    ap.add_argument("--name", default="expert")
    ap.add_argument("--n_data", type=int, default=256,
                    help="number of (fresh-key) dataset examples to score")
    ap.add_argument("--n_steps", type=int, default=200,
                    help="forward prob-flow ODE steps (discretization)")
    ap.add_argument("--n_probes", type=int, default=4,
                    help="Hutchinson probes per step (variance of the "
                         "divergence estimate falls as 1/n_probes)")
    ap.add_argument("--probe", default="rademacher",
                    choices=["rademacher", "gaussian"])
    ap.add_argument("--exact", action="store_true",
                    help="exact Jacobian trace (tiny dims only: D forwards "
                         "per ODE step)")
    ap.add_argument("--t_max", type=float, default=None,
                    help="terminal integration time (default: 1.0, or 0.99 "
                         "under schedule.kind=rectified whose g^2 diverges "
                         "at t=1)")
    ap.add_argument("--conditional", action="store_true",
                    help="pass dataset labels to the model (match how the "
                         "expert was trained)")
    ap.add_argument("--label_slots", default=None,
                    help="JSON indices into the dataset label tuple "
                         "(train_image convention)")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=42)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    cfg = get_config(args.preset, overrides)
    schedule = builders.build_schedule(cfg)
    if not isinstance(schedule, VPSchedule):
        raise SystemExit("eval_nll needs a continuous VP schedule "
                         "(schedule.family=vp); DDPM discrete tables have "
                         "no ODE drift to integrate")
    if cfg.train.predict == "v" and schedule.kind != "stable":
        raise SystemExit("predict='v' identities need "
                         "VPSchedule(kind='stable') (alpha^2 + sigma^2 = 1)")
    with profiled(args):
        params, = entry.load_named(args.preset, [args.name], args.out,
                                   overrides, device)
        result = entry.eval_nll(
            params, model=builders.build_model(cfg),
            dataset=cfg.data.dataset,
            dataset_kw=builders.dataset_kwargs(cfg), n_data=args.n_data,
            n_steps=args.n_steps, n_probes=args.n_probes, probe=args.probe,
            exact=args.exact, t_max=args.t_max, schedule=schedule,
            predict=cfg.train.predict, conditional=args.conditional,
            label_slots=(json.loads(args.label_slots) if args.label_slots
                         else None),
            seed=args.seed, device=device)
    report = {"expert": args.name, "preset": args.preset,
              "n_data": args.n_data, **{k: result[k] for k in REPORT_KEYS}}
    finite(args, "bits/dim", [float(report["bits_per_dim_mean"])])
    mgr = CheckpointManager(args.out, cfg.name)
    path = os.path.join(mgr.results_dir, f"nll_{args.name}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"bits/dim {report['bits_per_dim_mean']:.4f} +/- "
          f"{report['bits_per_dim_sem']:.4f} "
          f"(NLL {report['nll_nats_mean']:.1f} nats) -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
