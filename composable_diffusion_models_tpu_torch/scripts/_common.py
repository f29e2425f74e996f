"""What every command line shares: the runtime flags, the builders the
scripts import from ``_common``, the output checks of ``--debug_nans`` and
the plot rule.

The port's counterpart of ``scripts/_common.py``:

* ``add_runtime_flags`` adds ``--profile``, ``--debug_nans`` and ``--cpu``
  with the script's names and defaults. :func:`start` applies them and
  returns the ``device`` the entry points take: ``"cpu"`` under ``--cpu``,
  else None, the CUDA card. Without ``--cpu`` and without a card,
  :func:`require_accelerator` prints the reason and exits 3 before any
  tensor is made; no command line falls back to the CPU.
* The JAX probe's retries and its stall watchdog guard a remote TPU whose
  failure is a silent hang; a local card fails at once, so neither is
  ported.
* ``--debug_nans``: ``torch.autograd.set_detect_anomaly(True)``, and each
  command line passes what it returns or saves through :func:`finite`,
  which raises ``FloatingPointError`` naming the first tensor holding a
  NaN or an Inf. ``jax_debug_nans`` checks every jitted output as it is
  made; this checks the command line's outputs once they exist (and the
  backward passes of training, through anomaly mode).
* :func:`plot`: the scatters and loss curves need matplotlib, which the
  card's machine lacks; where it is missing the command line prints
  ``skipped <path>: matplotlib is not installed`` and carries on. Grids
  never need it (``utils.viz.save_grid``).
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Any, Callable, Optional

import torch

# re-exported under the names the scripts import from their _common
from ..builders import (  # noqa: F401
    build_dataset, build_model, build_schedule, init_params)
from ..utils.profiling import maybe_profile

PROFILE_DIR = "outputs/profile"


def add_runtime_flags(ap: argparse.ArgumentParser) -> None:
    """--profile / --debug_nans / --cpu on every command line."""
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of the run into "
                         "outputs/profile/trace.json")
    ap.add_argument("--debug_nans", action="store_true",
                    help="torch.autograd anomaly mode, and fail with "
                         "FloatingPointError if anything the command line "
                         "saves or returns holds a NaN or an Inf")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain PyTorch "
                         "versions); without it everything runs on the CUDA "
                         "card, and a missing card exits 3")


def apply_runtime_flags(args) -> None:
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)


def require_accelerator() -> None:
    """Exit 3 when there is no CUDA card (the script's code for a missing
    accelerator)."""
    if not torch.cuda.is_available():
        print("FATAL: no CUDA card: this command line runs on the GPU. "
              "Pass --cpu to run on the CPU.", file=sys.stderr)
        sys.exit(3)


def start(args) -> Optional[str]:
    """Applies the runtime flags and returns the entry points' ``device``:
    "cpu" under ``--cpu``, else None (the card, which must exist)."""
    apply_runtime_flags(args)
    if args.cpu:
        return "cpu"
    require_accelerator()
    return None


def profiled(args):
    """``--profile``: a trace of the enclosed work into outputs/profile."""
    return maybe_profile(args.profile, PROFILE_DIR)


def _bad(value: Any) -> bool:
    if isinstance(value, float):
        return not math.isfinite(value)
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and not bool(
            torch.isfinite(value).all())
    if isinstance(value, dict):
        return any(_bad(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_bad(v) for v in value)
    return False


def finite(args, name: str, value: Any) -> Any:
    """``value`` (a tensor, or a dict / list of them), checked under
    ``--debug_nans``."""
    if getattr(args, "debug_nans", False) and _bad(value):
        raise FloatingPointError(f"--debug_nans: {name} holds a NaN or an "
                                 "Inf")
    return value


def plot(path: str, draw: Callable[[str], Any]) -> Optional[str]:
    """``draw(path)`` where matplotlib is installed; else one line on
    stdout, and nothing is drawn or computed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"skipped {path}: matplotlib is not installed")
        return None
    draw(path)
    return path
