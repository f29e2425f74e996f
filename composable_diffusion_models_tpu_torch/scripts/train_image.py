"""Train one image-space diffusion expert: ``scripts/train_image.py`` over
``entry.train_image``.

  python -m composable_diffusion_models_tpu_torch.scripts.train_image \\
      --preset mnist_image --classes "[0,1,2,3,4]" --name expert_04 --sanity

Writes under ``<out>/<preset name>/run_0``: the checkpoint
``checkpoints/<name>_final`` (``torch.save``), ``logs/<name>_config.yaml``,
``results/<name>_loss.npy`` and ``<name>_loss.png`` (matplotlib), and for
an unconditional VP preset ``results/<name>_onestep.png``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from composable_diffusion_models_tpu_torch import entry
from composable_diffusion_models_tpu_torch.checkpoint import CheckpointManager
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, plot, profiled, start)
from composable_diffusion_models_tpu_torch.utils import viz
from composable_diffusion_models_tpu_torch.utils.config import get_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train one image expert.")
    ap.add_argument("--preset", default="mnist_image")
    ap.add_argument("--name", default="expert")
    ap.add_argument("--classes", default=None,
                    help="JSON list of class ids to train on, e.g. [0,1]")
    ap.add_argument("--conditional", action="store_true",
                    help="pass dataset labels to the model")
    ap.add_argument("--label_slots", default=None,
                    help="JSON indices into the dataset label tuple, e.g. "
                         "[1] to condition the color expert on color labels")
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--resumable", action="store_true",
                    help="checkpoint {params, opt_state, step} every chunk "
                         "and resume from the newest step checkpoint "
                         "(bitwise-identical restart)")
    ap.add_argument("--out", default="outputs")
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    with profiled(args):
        params, losses, path = entry.train_image(
            args.preset, args.name,
            classes=json.loads(args.classes) if args.classes else None,
            conditional=args.conditional,
            label_slots=(json.loads(args.label_slots) if args.label_slots
                         else None),
            sanity=args.sanity, resumable=args.resumable, out=args.out,
            overrides=overrides, device=device)
        finite(args, "params", params)
        finite(args, "losses", losses)
        if losses.shape[0]:  # empty when a resumable run was complete
            mgr = CheckpointManager(args.out,
                                    get_config(args.preset, overrides).name)
            plot(os.path.join(mgr.results_dir, f"{args.name}_loss.png"),
                 lambda p: viz.plot_loss(losses, p))
    final = (f"{float(losses[-1]):.4f}" if losses.shape[0]
             else "resumed-complete")
    print(f"saved checkpoint: {path}  final_loss={final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
