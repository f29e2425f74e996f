"""Walk the quality / FLOP frontier of the flagship:
``scripts/frontier_sweep.py`` over ``frontier.frontier_sweep``. One
flagship gate per (candidate, budget) against ``--baseline``, with
escalating budgets; a cell whose report already has a verdict is read, not
run. The DiT candidates serve through the ``fused_dit_block`` kernel on the
card. Writes ``frontier_table.json`` under ``--out`` and prints it.

Two flags keep the script's names with a meaning of the port's:

* ``--timeout``: the script ran each cell in a subprocess under this
  timeout, to survive a stalled connection to a remote TPU. Here every
  cell runs in this process on the local card; the flag is accepted and
  unused.
* ``--mfu``: the script's default 0.36 was a TPU's serving MFU. The
  default here is the H100's, 0.0262, measured on the flagship DiT path
  (H100 80GB HBM3, 700 W; ``chip_smoke.py`` phase 4).

The script takes no runtime flags; this command line takes them, as every
command line of the port does, so that ``--cpu`` can ask for the CPU.
Unknown arguments are refused, as the script refuses them.
"""

from __future__ import annotations

import argparse
import sys

from composable_diffusion_models_tpu_torch import frontier
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, profiled, start)

# the serving MFU of the flagship's DiT path on the H100 (batch 2048, 50
# DDIM steps, 3 bf16 experts; H100 80GB HBM3 at 700 W, chip_smoke.py)
H100_SERVING_MFU = 0.0262


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Gate candidates at escalating "
                                             "training budgets.")
    ap.add_argument("--candidates",
                    default=",".join(frontier.DEFAULT_CANDIDATES))
    ap.add_argument("--budgets", default="24000,48000,96000")
    ap.add_argument("--baseline",
                    default="artifacts/quality_gate_r4/quality_unet64.json")
    ap.add_argument("--out", default="outputs/quality_gate_r5")
    ap.add_argument("--timeout", type=int, default=4800,
                    help="accepted and unused: the script's per-cell "
                         "subprocess timeout; every cell runs in this "
                         "process on the card")
    ap.add_argument("--mfu", type=float, default=H100_SERVING_MFU,
                    help="measured serving MFU used for the projected "
                         "img/s column (the H100's on the flagship DiT "
                         "path)")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = start(args)
    with profiled(args):
        table = frontier.frontier_sweep(
            args.candidates.split(","),
            [int(b) for b in args.budgets.split(",")],
            baseline=args.baseline, out=args.out, mfu=args.mfu,
            device=device)
    print(f"\n=== frontier table (MFU {args.mfu:.4f} => projected img/s at "
          f"{table['peak_tflops']:.0f} TFLOP/s) ===")
    for row in table["rows"]:
        print(f"{row['config']:24s} {row['gflop_per_image']:7.2f} GF/img  "
              f"@{row['best_budget']} {row['verdict']:6s} -> "
              f"~{row['projected_images_per_sec']:7.0f} img/s if PASS")
    print(f"table saved to {args.out}/frontier_table.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
