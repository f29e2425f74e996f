"""The flagship's quality gate over named configurations:
``scripts/quality_gate_flagship.py`` over ``entry.quality_gate_flagship``.
Three digit-subset experts per configuration (``unet<W>`` or
``dit_p<P>_d<D>_l<L>[_h<H>]``), each sampled solo and the three composed
through the configuration's served program (``groupnorm_silu`` or
``fused_dit_block`` on the card), scored by a digit probe and, with
``--baseline``, judged.

Writes ``quality_<config>[_s<train_steps>].json`` and the grids under
``--out``, and prints each verdict. Exit codes are the script's: 2 when
``--baseline`` is neither a report .json nor a name in ``--configs``, or
its report lacks the distributional statistics (checked here before any
work; the script checks after it); 1 when a candidate FAILs; else 0.
Unknown arguments are dropped, as the script drops them.
"""

from __future__ import annotations

import argparse
import json
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Gate named configurations of "
                                             "the flagship.")
    ap.add_argument("--configs", default="unet64,unet32",
                    help="comma list: unet<W> or dit_p<P>_d<D>_l<L>")
    ap.add_argument("--train_steps", type=int, default=12000,
                    help="per expert (12k x bs256 = the reference-equivalent "
                         "budget used by every flagship eval)")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--ema", type=float, default=0.999)
    ap.add_argument("--probe_steps", type=int, default=2000)
    ap.add_argument("--n_samples", type=int, default=256,
                    help="per solo expert and for the composed program")
    ap.add_argument("--n_steps", type=int, default=50,
                    help="DDIM steps (the bench program uses 50)")
    ap.add_argument("--data_n", type=int, default=8192)
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs/quality_gate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default="",
                    help="a prior run's quality_*.json path, or a config "
                         "name also in --configs (judged in-run). Empty = "
                         "report only.")
    ap.add_argument("--tol", type=float, default=0.02,
                    help="absolute noise tolerance on the accuracy/entropy "
                         "criteria")
    ap.add_argument("--div_frac", type=float, default=0.5,
                    help="candidate within-class diversity must be >= this "
                         "fraction of the baseline's")
    ap.add_argument("--fid_slack", type=float, default=1.5,
                    help="candidate FID-lite must be <= this multiple of "
                         "the baseline's")
    add_runtime_flags(ap)
    return ap


def check_baseline(baseline: str, configs) -> None:
    """The script's exit 2: a baseline neither a report nor a configuration
    of this run, or a report without the distributional statistics."""
    if baseline.endswith(".json"):
        with open(baseline) as f:
            if "diversity_mean" in (json.load(f).get("composed") or {}):
                return
        print("FATAL: baseline report lacks the r4 distributional stats "
              "(diversity/fid) — re-run the baseline config with this "
              "script version", file=sys.stderr)
        sys.exit(2)
    if baseline not in configs:
        print(f"FATAL: --baseline {baseline!r} is neither a .json path nor "
              "a config in --configs", file=sys.stderr)
        sys.exit(2)


def report_verdicts(reports: dict, out: str, stem: str) -> int:
    """Prints each configuration's verdict and report path as the scripts
    do; returns their exit code: 1 if any FAILs, else 0."""
    any_fail = False
    for cfg, report in reports.items():
        if "verdict" in report:
            any_fail |= report["verdict"] == "FAIL"
            fails = [k for k, v in report["criteria"].items() if not v["ok"]]
            print(f"{cfg}: {report['verdict']}"
                  + (f"  (failed: {', '.join(fails)})" if fails else ""))
        steps = report["train_steps"]
        suffix = "" if steps == 12000 else f"_s{steps}"
        print(f"report saved to {out}/{stem}{cfg}{suffix}.json")
    return 1 if any_fail else 0


def main(argv=None) -> int:
    args, _ = build_parser().parse_known_args(argv)
    device = start(args)
    configs = args.configs.split(",")
    if args.baseline:
        check_baseline(args.baseline, configs)
    with profiled(args):
        reports = entry.quality_gate_flagship(
            configs, train_steps=args.train_steps,
            batch_size=args.batch_size, lr=args.lr, ema=args.ema,
            probe_steps=args.probe_steps, n_samples=args.n_samples,
            n_steps=args.n_steps, data_n=args.data_n, seed=args.seed,
            baseline=args.baseline or None, tol=args.tol,
            div_frac=args.div_frac, fid_slack=args.fid_slack,
            sanity=args.sanity, out=args.out, device=device)
        finite(args, "reports", reports)
    return report_verdicts(reports, args.out, "quality_")


if __name__ == "__main__":
    sys.exit(main())
