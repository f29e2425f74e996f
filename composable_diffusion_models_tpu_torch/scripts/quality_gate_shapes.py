"""The quality gate of the shapes-64 workload:
``scripts/quality_gate_shapes.py`` over ``entry.quality_gate_shapes``. A
shape- and a color-conditional expert per configuration (``unet<W>`` or
``dit_p<P>_d<D>_l<L>``), the 9 (shape, color) cells served through the
bench program (``groupnorm_silu`` or ``fused_dit_block`` on the card),
scored by a two-factor probe and judged against ``--baseline``.

Writes ``quality_shapes_<config>[_s<train_steps>].json`` and the cells'
grids under ``--out``, and prints each verdict. Exit codes are the
script's: 2 when ``--baseline`` is neither a report .json nor a name in
``--configs`` (checked here before any work; the script checks after it);
1 when a candidate FAILs; else 0. Unknown arguments are dropped, as the
script drops them.
"""

from __future__ import annotations

import argparse
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)
from composable_diffusion_models_tpu_torch.scripts.quality_gate_flagship \
    import report_verdicts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Gate configurations on the "
                                             "shapes-64 workload.")
    ap.add_argument("--configs", default="unet64,dit_p8_d256_l8")
    ap.add_argument("--baseline", default="unet64",
                    help="config name in --configs or a prior quality_*.json")
    ap.add_argument("--train_steps", type=int, default=12000)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--snr_gamma", type=float, default=0.0,
                    help="min-SNR loss weighting (0 disables, the default: "
                         "under gamma=5 the 64x64 DiT expert diverged at "
                         "10-20k steps; the gate is relative, so baseline "
                         "and candidates always share one recipe)")
    ap.add_argument("--clip_norm", type=float, default=1.0,
                    help="global-norm gradient clipping (0 disables); "
                         "binds only on spike steps")
    ap.add_argument("--probe_steps", type=int, default=2000)
    ap.add_argument("--samples_per_cell", type=int, default=64)
    ap.add_argument("--n_steps", type=int, default=50)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--data_n", type=int, default=8192)
    ap.add_argument("--tol", type=float, default=0.02)
    ap.add_argument("--div_frac", type=float, default=0.5)
    ap.add_argument("--fid_slack", type=float, default=1.5)
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs/quality_gate_shapes")
    ap.add_argument("--seed", type=int, default=0)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = start(args)
    configs = args.configs.split(",")
    if not (args.baseline.endswith(".json") or args.baseline in configs):
        print(f"FATAL: --baseline {args.baseline!r} not found",
              file=sys.stderr)
        sys.exit(2)
    with profiled(args):
        reports = entry.quality_gate_shapes(
            configs, baseline=args.baseline, train_steps=args.train_steps,
            batch_size=args.batch_size, lr=args.lr, ema=args.ema,
            snr_gamma=args.snr_gamma, clip_norm=args.clip_norm,
            probe_steps=args.probe_steps,
            samples_per_cell=args.samples_per_cell, n_steps=args.n_steps,
            img=args.img, data_n=args.data_n, tol=args.tol,
            div_frac=args.div_frac, fid_slack=args.fid_slack,
            sanity=args.sanity, out=args.out, seed=args.seed, device=device)
        finite(args, "reports", reports)
    return report_verdicts(reports, args.out, "quality_shapes_")


if __name__ == "__main__":
    sys.exit(main())
