"""Pipeline parallelism: homogeneous stages across a 'stage' mesh axis.

Port of ``composable_diffusion_models_tpu.parallel.pp``: a GPipe-style
microbatch pipeline. Stage s lives on position s of the axis (this rank
holds its stage's params), activations hop stage to stage around the ring
(:func:`mesh.ppermute_grad`, whose backward sends the gradient back), and M
microbatches drain through S stages in M + S - 1 ticks (the fill-drain
schedule, bubble fraction (S - 1) / (M + S - 1)). As in the JAX program
every position computes every tick, a tensor condition picking its input
(the injected microbatch on stage 0, the hop elsewhere) and its output
(the last stage's y, zeros elsewhere), so every rank runs the same
exchanges forward and backward. The last stage's outputs are replicated to
every rank by one all-reduce whose backward hands each rank's gradient to
its own summand: the loss computed alike on every rank is one loss.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..experts import stack_params
from .mesh import axis_index, axis_size, ppermute_grad, shard_pytree_leading, \
    sum_replicated
from ..train import tree_map

Params = Any


def stack_stage_params(params_list: Sequence[Params]) -> Params:
    """Stack S same-structure stage param trees on a new leading axis."""
    return stack_params(params_list)


def make_pipeline_apply(stage_fn: Callable[[Params, torch.Tensor],
                                           torch.Tensor],
                        mesh, n_stages: int, axis: str = "stage"):
    """Build ``fn(stage_params, microbatches) -> outputs``.

    Args:
      stage_fn: one pipeline stage, ``(params, x) -> y`` with x and y of the
        SAME shape (a homogeneous tower, e.g. DiT blocks).
      mesh: a mesh containing ``axis`` of size ``n_stages``.
      n_stages: S; must equal the axis size.

    The returned fn takes this rank's stage params (:func:`shard_stage_params`:
    a leading dim of 1) and the microbatches (M, mb, ...), the same on every
    rank; it returns (M, mb, ...) outputs on every rank, equal to applying
    the S stages in order to each microbatch. Differentiable.
    """
    s = axis_size(mesh, axis)
    if s != n_stages:
        raise ValueError(f"mesh axis {axis}={s} != n_stages={n_stages}")
    i = axis_index(mesh, axis)

    def fn(stacked, microbatches: torch.Tensor) -> torch.Tensor:
        params = tree_map(lambda a: a[0], stacked)
        m = microbatches.shape[0]
        first = torch.tensor(i == 0, device=microbatches.device)
        last = torch.tensor(i == s - 1, device=microbatches.device)
        x = torch.zeros_like(microbatches[0])
        outs = []
        for t in range(m + s - 1):
            x_in = torch.where(first, microbatches[min(t, m - 1)], x)
            y = stage_fn(params, x_in)
            # the last stage's y is this tick's pipeline output
            outs.append(torch.where(last, y, torch.zeros_like(y)))
            if t < m + s - 2:  # the last tick's hop feeds nothing
                x, = ppermute_grad([y], mesh, axis)
        outs = sum_replicated(torch.stack(outs), mesh, axis)
        # microbatch j leaves the last stage at tick j + s - 1
        return outs[s - 1:]

    return fn


def shard_stage_params(stacked: Params, mesh, axis: str = "stage") -> Params:
    """This rank's stage of stacked stage params (leading dim 1)."""
    return shard_pytree_leading(stacked, mesh, axis)
