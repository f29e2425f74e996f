"""CIFAR-10 class-split SUPERDIFF composition: ``scripts/compose_cifar.py``
over ``entry.compose_cifar``. Two unconditional experts on the classes
{0-4} and {5-9}, each sampled solo and the pair composed by SUPERDIFF OR,
scored by a 10-class probe. Where no CIFAR binaries are found, the
procedural stand-in goes through the binary-batch format and back.

Writes under ``--out``: ``cifar_solo_A.png``, ``cifar_solo_B.png``,
``cifar_superdiff_OR.png``, ``cifar_comparison.png`` and the report
``cifar_split_composition.json``. Unknown arguments are dropped, as the
script drops them.
"""

from __future__ import annotations

import argparse
import os
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CIFAR-10 class-split "
                                             "SUPERDIFF composition.")
    ap.add_argument("--T", type=int, default=1000)
    ap.add_argument("--train_steps", type=int, default=12000)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--base_dim", type=int, default=64)
    ap.add_argument("--temp", type=float, default=1.0)
    ap.add_argument("--probe_steps", type=int, default=2000)
    ap.add_argument("--n_samples", type=int, default=64)
    ap.add_argument("--data_n", type=int, default=8192)
    ap.add_argument("--data_dir", default=None,
                    help="real CIFAR binary dir; default: auto-discover, "
                         "else procedural stand-in")
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs/cifar_split")
    ap.add_argument("--seed", type=int, default=0)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        report = entry.compose_cifar(
            T=args.T, train_steps=args.train_steps,
            batch_size=args.batch_size, lr=args.lr, ema=args.ema,
            base_dim=args.base_dim, temp=args.temp,
            probe_steps=args.probe_steps, n_samples=args.n_samples,
            data_n=args.data_n, data_dir=args.data_dir, sanity=args.sanity,
            out=args.out, seed=args.seed, device=device)
    print(f"dataset: {report['dataset']}")
    for name, stats in report["sets"].items():
        finite(args, name, stats)
        print(f"  {name}: frac_A={stats['frac_split_a']:.3f} "
              f"conf={stats['mean_max_prob']:.3f}")
    print(f"report saved to "
          f"{os.path.join(args.out, 'cifar_split_composition.json')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
