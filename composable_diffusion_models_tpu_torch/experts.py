"""ExpertStack: K same-architecture experts behind one apply, and the
blend across experts of different signatures.

Port of ``composable_diffusion_models_tpu.experts``: ``ExpertStack`` and
``per_expert``, ``grouped_eps_fn`` (groups of experts with their own input
adapters and output lifts, e.g. a 1-channel shape expert beside a
3-channel color expert), ``rgb_to_gray`` and ``gray_to_rgb`` (the
projection those experts see through, and its lift). The JAX
``ExpertStack`` unrolls small K and vmaps over stacked parameters for large
K; both compute the same (K, B, ...) stack, which a Python loop over the
experts computes here for every K. ``stack_params``, ``unstack_params`` and
``pad_expert_stack`` put the K trees on one leading axis, the unit that
``parallel/`` shards over its ``expert`` axis.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from .compose import LUMA_W, constant
from .train import tree_map

Params = Any


def stack_params(params_list: Sequence[Params]) -> Params:
    """Stack K identically-shaped parameter trees on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *params_list)


def unstack_params(stacked: Params, k: int) -> list:
    """The K trees of a stack (views of its leaves)."""
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(k)]


def pad_expert_stack(stacked_params: Params, weights: torch.Tensor,
                     multiple: int, labels: Sequence[torch.Tensor] = ()):
    """Pad a stacked expert tree to a multiple of the expert axis' size.

    The padding repeats expert 0 with a ZERO blend weight (and expert 0's
    per-expert labels): the weighted blend divides by the sum of the
    weights, so the composition is unchanged. Returns (padded params,
    padded weights, padded labels); a no-op when ``multiple`` divides K."""
    k = weights.shape[0]
    pad = (-k) % multiple
    if pad == 0:
        return stacked_params, weights, tuple(labels)

    def rep(a):
        return torch.cat([a, a[:1].expand(pad, *a.shape[1:])], dim=0)
    w = torch.cat([weights, weights.new_zeros((pad,))])
    return tree_map(rep, stacked_params), w, tuple(rep(lab) for lab in labels)


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


EpsStackFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def grouped_eps_fn(groups: Sequence[EpsStackFn],
                   adapters: Sequence[Callable] = (),
                   lifts: Sequence[Callable] = ()) -> EpsStackFn:
    """Blend across heterogeneous expert groups. Each group is an
    ``eps_stack_fn(x, t) -> (K_g, B, ...)`` over its own input signature;
    ``adapters[g]`` maps the sampler's x into the group's input (e.g. RGB
    -> gray), ``lifts[g]`` maps each of the group's K_g predictions back
    into the sampler's space (e.g. 1 -> 3 channels). Returns the combined
    ``eps_stack_fn`` producing the concatenated (sum K_g, B, ...) stack.
    Empty ``adapters`` / ``lifts`` mean identities; otherwise there must be
    one per group (zip would silently drop groups)."""
    adapters = list(adapters) or [lambda x: x] * len(groups)
    lifts = list(lifts) or [lambda e: e] * len(groups)
    if len(adapters) != len(groups) or len(lifts) != len(groups):
        raise ValueError(
            f"adapters ({len(adapters)}) and lifts ({len(lifts)}) must match "
            f"groups ({len(groups)}): pass identity functions for "
            "pass-through groups")

    def eps_stack_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        outs = []
        for g, ad, lf in zip(groups, adapters, lifts):
            eps = g(ad(x), t)
            outs.append(torch.stack([lf(e) for e in eps.unbind(0)]))
        return torch.cat(outs, dim=0)

    return eps_stack_fn


def _unit_row(x: torch.Tensor, weights: Optional[Sequence[float]]):
    """The projection row (LUMA_W by default) in x's dtype on x's device,
    and its norm."""
    w = constant(LUMA_W if weights is None else weights, x.dtype, x.device)
    return w, torch.sqrt((w * w).sum())


def rgb_to_gray(x: torch.Tensor, normalized: bool = False,
                weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Channel projection of NHWC ``x`` to one channel: sum_c w_c x_c with
    the ITU-R 601 luma weights by default (``weights``: another row, e.g.
    (1, 1, 1)). ``normalized=True`` divides by ||w||, which makes the
    projection row unit-norm: the gray view of a unit-variance RGB
    diffusion state is then itself one, P x_t = a P x0 + s eps1 with eps1
    ~ N(0, 1)."""
    w, norm = _unit_row(x, weights)
    g = (x * w).sum(dim=-1, keepdim=True)
    return g / norm if normalized else g


def gray_to_rgb(eps: torch.Tensor, normalized: bool = False,
                weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Lift a 1-channel prediction to 3 channels: equal broadcast (the
    reference's ``repeat(1, 3, 1, 1)``), or with ``normalized=True`` the
    adjoint of :func:`rgb_to_gray`'s unit-norm projection, eps * w / ||w||
    (``weights`` must match the projection that made the view)."""
    if not normalized:
        return eps.repeat_interleave(3, dim=-1)
    w, norm = _unit_row(eps, weights)
    return eps * (w / norm)
