"""SUPERDIFF composition quality: ``scripts/eval_superdiff.py`` over
``eval_superdiff.eval_superdiff`` (the port's module, imported by its
absolute name). ``--protocol mixture``: OR of two class-subset experts on
colored MNIST, its mixture balance against each expert solo;
``factored``: AND of a shape and a color expert over held-out combinations.
Every UNet's GroupNorm + SiLU runs through the ``groupnorm_silu`` kernel on
the card. Writes the report and grids under ``--out``. Unknown arguments
are dropped, as the script drops them.
"""

from __future__ import annotations

import argparse
import json
import sys

from composable_diffusion_models_tpu_torch import eval_superdiff
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Score SUPERDIFF composition.")
    ap.add_argument("--protocol", default="mixture",
                    choices=["mixture", "factored"])
    ap.add_argument("--dataset", default="shapes",
                    choices=["shapes", "colored_mnist"],
                    help="factored protocol only")
    ap.add_argument("--holdout", default=None,
                    help="JSON held-out pairs (factored); defaults to "
                         "[[2,2]] shapes / [[7,2]] colored_mnist")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--train_steps", type=int, default=12000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--base_dim", type=int, default=64)
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--temp_sweep", default="",
                    help="mixture protocol: comma list of OR softmax "
                         "temperatures swept on the SAME trained experts "
                         "(one OR job per value). Accepts floats and the "
                         "tokens 1/d and 1/dT (resolved against the image "
                         "dim and --T)")
    ap.add_argument("--probe_steps", type=int, default=2000)
    ap.add_argument("--n_samples", type=int, default=256,
                    help="mixture protocol sample count")
    ap.add_argument("--samples_per_combo", type=int, default=64)
    ap.add_argument("--data_n", type=int, default=8192)
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs/superdiff_eval")
    ap.add_argument("--seed", type=int, default=0)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        report = eval_superdiff.eval_superdiff(
            args.protocol, args.dataset,
            holdout=json.loads(args.holdout) if args.holdout else None,
            T=args.T, train_steps=args.train_steps,
            batch_size=args.batch_size, lr=args.lr, ema=args.ema,
            base_dim=args.base_dim, temp=args.temp,
            temp_sweep=args.temp_sweep, probe_steps=args.probe_steps,
            n_samples=args.n_samples,
            samples_per_combo=args.samples_per_combo, data_n=args.data_n,
            sanity=args.sanity, out=args.out, seed=args.seed, device=device)
        finite(args, "report", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
