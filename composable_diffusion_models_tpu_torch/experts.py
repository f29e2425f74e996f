"""ExpertStack: K same-architecture experts behind one apply.

Port of ``composable_diffusion_models_tpu.experts.ExpertStack``. The JAX
version unrolls small K and vmaps over stacked parameters for large K; both
compute the same (K, B, ...) stack, which a Python loop over the experts
computes here for every K.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


class PerExpert:
    """Marks a label array whose leading (K, ...) axis is MAPPED over the
    expert stack instead of broadcast. Construct via :func:`per_expert`."""

    __slots__ = ("value",)

    def __init__(self, value: torch.Tensor):
        self.value = value


def per_expert(label: torch.Tensor) -> PerExpert:
    """Mark ``label`` (leading axis K) as per-expert for ExpertStack calls."""
    return PerExpert(label)


class ExpertStack:
    """``stack(x, t, *labels)`` -> (K, B, ...) eps stack. Data is shared by
    every expert; labels broadcast unless wrapped with :func:`per_expert`.
    A bare label whose leading dim equals K with ndim >= 2 is rejected as
    ambiguous rather than guessed at."""

    def __init__(self, apply_fn: Callable[..., torch.Tensor],
                 params_list: Sequence[Any]):
        self.apply_fn = apply_fn
        self.params_list = list(params_list)
        self.k = len(self.params_list)

    def _check(self, labels):
        for lab in labels:
            if isinstance(lab, PerExpert):
                if lab.value.shape[0] != self.k:
                    raise ValueError(
                        f"per_expert label leading dim {lab.value.shape[0]} "
                        f"!= K={self.k}")
            elif getattr(lab, "ndim", 0) >= 2 and lab.shape[0] == self.k:
                raise ValueError(
                    f"ambiguous label shape {tuple(lab.shape)} with "
                    f"K={self.k}: wrap with experts.per_expert(...) to map it "
                    "over the expert axis, or reshape to broadcast it")

    def __call__(self, x: torch.Tensor, t, *labels) -> torch.Tensor:
        self._check(labels)
        return torch.stack([
            self.apply_fn(p, x, t, *(lab.value[i] if isinstance(lab, PerExpert)
                                     else lab for lab in labels))
            for i, p in enumerate(self.params_list)])
