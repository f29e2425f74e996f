"""Checkpoints: the directory contract and step-level resume, with
``torch.save``.

Port of ``composable_diffusion_models_tpu.checkpoint``. The layout is the
JAX package's: ``base/exp_name/run_id/{checkpoints,results,logs}``, with
``{name}_final`` and ``{name}_epoch_{n}`` for saved states and
``{name}_step_{step:09d}`` for resumable training states. Each is one file
written by ``torch.save`` (the JAX package writes orbax directories under
the same names; those are not read here). A state is a nested dict of
tensors and plain Python values: params, the optimizer state, the step, the
EMA tree and the generator key. Loading reads tensors only
(``weights_only``), onto the device asked for, and gives back the bits that
were saved.

Writes go to a temporary file that is renamed into place, so a crash in the
middle of a save leaves the previous checkpoint readable. Saves are
synchronous: :meth:`CheckpointManager.flush` has nothing to wait for and
exists for the JAX package's interface.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import torch

State = Any


def _write(path: str, state: State) -> str:
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str, device=None) -> State:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    """Directory contract: base/exp_name/run_id/{checkpoints,results,logs}."""

    def __init__(self, base_dir: str, exp_name: str, run_id: str = "run_0"):
        self.root = os.path.abspath(os.path.join(base_dir, exp_name, run_id))
        self.ckpt_dir = os.path.join(self.root, "checkpoints")
        self.results_dir = os.path.join(self.root, "results")
        self.logs_dir = os.path.join(self.root, "logs")
        for d in (self.ckpt_dir, self.results_dir, self.logs_dir):
            os.makedirs(d, exist_ok=True)

    def _path(self, name: str, epoch: Optional[int]) -> str:
        suffix = "final" if epoch is None else f"epoch_{epoch}"
        return os.path.join(self.ckpt_dir, f"{name}_{suffix}")

    def save(self, name: str, state: State,
             epoch: Optional[int] = None) -> str:
        """``{name}_final``, or ``{name}_epoch_{epoch}``; overwrites."""
        return _write(self._path(name, epoch), state)

    def load(self, name: str, epoch: Optional[int] = None,
             device=None) -> State:
        return _read(self._path(name, epoch), device)

    # -- step-level resume -------------------------------------------------
    def _step_path(self, name: str, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{name}_step_{step:09d}")

    def save_step(self, name: str, state: State, step: int,
                  keep: int = 3) -> str:
        """Save a resumable training state at ``step`` and keep, besides
        it, the ``keep`` newest older step checkpoints of ``name`` (the JAX
        package's count: its in-flight save is the extra one)."""
        if keep < 1:
            raise ValueError("keep-latest-k needs k >= 1")
        path = _write(self._step_path(name, step), state)
        older = [s for s in self.step_list(name) if s != step]
        for old in older[:-keep]:
            os.remove(self._step_path(name, old))
        return path

    def flush(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def step_list(self, name: str) -> List[int]:
        """Sorted steps for which a step checkpoint of ``name`` exists."""
        prefix = f"{name}_step_"
        steps = []
        for f in os.listdir(self.ckpt_dir):
            if f.startswith(prefix) and f[len(prefix):].isdigit():
                steps.append(int(f[len(prefix):]))
        return sorted(steps)

    def restore_latest(self, name: str,
                       device=None) -> Tuple[Optional[State], int]:
        """(the newest step checkpoint's state on ``device``, its step), or
        (None, 0) when there is none."""
        steps = self.step_list(name)
        if not steps:
            return None, 0
        return _read(self._step_path(name, steps[-1]), device), steps[-1]


def save_checkpoint(path: str, state: State) -> str:
    """One state at ``path`` (overwritten)."""
    return _write(os.path.abspath(path), state)


def load_checkpoint(path: str, device=None) -> State:
    return _read(os.path.abspath(path), device)
