"""The markdown results table over ``eval_composition`` reports:
``scripts/summarize_evals.py`` over ``utils.summarize.summarize_evals``,
which prints it. Host only: it reads JSON files and touches no tensor, so
it needs no card, and ``--cpu`` (accepted with the other runtime flags)
changes nothing. Unknown arguments are refused, as the script refuses
them.
"""

from __future__ import annotations

import argparse
import sys

from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, apply_runtime_flags, profiled)
from composable_diffusion_models_tpu_torch.utils.summarize import (
    summarize_evals)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Tabulate composition "
                                             "reports.")
    ap.add_argument("dirs", nargs="*", default=None,
                    help="report dirs (default: artifacts/*)")
    ap.add_argument("--dataset", default=None,
                    help="filter: shapes | colored_mnist")
    ap.add_argument("--top", type=int, default=0,
                    help="only the N best held-out rows (0 = all)")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    apply_runtime_flags(args)
    with profiled(args):
        summarize_evals(args.dirs or None, args.dataset, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
