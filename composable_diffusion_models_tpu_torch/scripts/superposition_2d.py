"""The 2-D SUPERDIFF teaching example end to end:
``scripts/superposition_2d.py`` over ``entry.superposition_2d``, which
trains the up and down experts on the 4-Gaussian grid, composes them with
the Ito-kappa equal-density path, prints ``|ll1 - ll2|`` and writes the
samples and log-likelihoods as ``.npy`` under ``--out``. The scatters
``composed_and.png``, ``log_likelihoods.png`` and ``ground_truth_up.png``
are drawn where matplotlib is installed. Unknown arguments are refused, as
the script refuses them.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from composable_diffusion_models_tpu_torch import (data, entry,
                                                   resolve_device)
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, plot, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="The 2-D superposition "
                                             "example.")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--bs", type=int, default=512)
    ap.add_argument("--n_sample_steps", type=int, default=1000)
    ap.add_argument("--out", default="outputs/superposition_2d")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sanity", action="store_true")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = start(args)
    with profiled(args):
        run = entry.superposition_2d(
            steps=args.steps, hidden=args.hidden, bs=args.bs,
            n_sample_steps=args.n_sample_steps, out=args.out,
            seed=args.seed, sanity=args.sanity, device=device)
        x, ll = finite(args, "samples", run["samples"]), run["ll"]
        finite(args, "log-likelihoods", ll)
        plot(os.path.join(args.out, "composed_and.png"),
             lambda p: viz.scatter2d(x, p, title="Ito-kappa AND of up/down "
                                                 "experts"))
        plot(os.path.join(args.out, "log_likelihoods.png"),
             lambda p: viz.scatter2d(
                 torch.stack([ll[0], ll[1]], 1), p,
                 title="per-expert integrated log-likelihood",
                 lim=float(ll.abs().max())))
        plot(os.path.join(args.out, "ground_truth_up.png"),
             lambda p: viz.scatter2d(
                 data.toy2d(args.seed, 512, up=True,
                            device=resolve_device(device)),
                 p, title="up-half data"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
