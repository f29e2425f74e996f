"""Expert-parallel sampling: the K composed experts spread over ranks.

Port of ``composable_diffusion_models_tpu.parallel.sample``. The
composition samplers' only cross-expert point is the eps blend
(``compose.weighted``). With the expert stack split over an 'expert' mesh
axis and the sample batch over 'data', each rank runs its local experts'
forwards on its batch shard, sums w_i eps_i, and one all-reduce over the
expert axis completes the blend; the sampler loops of ``samplers`` take
the resulting eps function unchanged.

:func:`sample_expert_parallel` serves ``entry.sample``'s composition (the
folded DiT experts, ``fused_dit_block`` on the card) and
``entry.sample_shapes``' (the UNet experts, ``groupnorm_silu``) that way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from .. import resolve_device
from ..experts import unstack_params
from ..models.dit import DiT, make_folded_apply
from ..samplers import ddim
from ..schedules import VPSchedule
from ..convert import unet_torch_layout
from ..train import flatten, tree_map
from .mesh import Sharding, all_reduce, axis_index, axis_size, shard_batch


def make_expert_parallel_eps_fn(apply_fn: Callable[..., torch.Tensor], mesh,
                                stacked_params: Any, weights: torch.Tensor,
                                labels: Sequence[torch.Tensor] = (),
                                device=None):
    """Build ``eps_fn(x, t) -> weighted-combined eps`` with the experts
    spread over the mesh's 'expert' axis.

    Args:
      apply_fn: per-expert model apply ``(params, x, t, *labels) -> eps``.
      mesh: a mesh with ('expert', 'data') axes (either may be size 1).
      stacked_params: this rank's shard of the stacked tree: leading dim
        K / expert-axis size (``shard_pytree_leading(stack_params(...),
        mesh, "expert")``).
      weights: the full (K,) blend weights (``compose.weighted``: the blend
        is normalized by their global sum); this rank takes its slice.
      labels: per-expert label arrays, this rank's (expert, data) shard of
        each (K, B) array, i.e. (K / expert size, B / data size).
      device: where the experts run (``None``: the CUDA card, raises
        without one); the shard and labels are moved there.

    Returns ``eps_fn``: x is this rank's batch shard (``shard_batch``), the
    result is the blended eps of that shard in float32. Each call issues
    exactly one all-reduce, over the expert axis, of one local eps shard.
    """
    dev = resolve_device(device)
    k, n_expert = int(weights.shape[0]), axis_size(mesh, "expert")
    if k % n_expert:
        raise ValueError(f"{k} experts do not divide the expert axis of "
                         f"size {n_expert}: pad them (pad_expert_stack)")
    k_local = k // n_expert
    lead = {int(x.shape[0]) for x in flatten(stacked_params)[1]}
    if lead != {k_local}:
        raise ValueError(f"stacked_params must be this rank's shard of "
                         f"{k_local} experts (shard_pytree_leading), got "
                         f"leading dims {sorted(lead)}")
    params = unstack_params(tree_map(lambda a: a.to(dev), stacked_params),
                            k_local)
    return _local_eps_fn(apply_fn, mesh, params, weights, labels, dev)


def _local_eps_fn(apply_fn, mesh, params: Sequence[Any], weights,
                  labels: Sequence[torch.Tensor], dev: torch.device):
    """:func:`make_expert_parallel_eps_fn`'s ``eps_fn`` over this rank's
    expert trees ``params`` (a list, already on ``dev``)."""
    k_local = len(params)
    lo = axis_index(mesh, "expert") * k_local
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    w_local = weights[lo:lo + k_local]
    w_sum = weights.sum()
    labs = [[lab[i].to(dev) for lab in labels] for i in range(k_local)]

    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=x.device)
        if t.dim() == 0:
            t = t[None]
        # the local experts' sum_i w_i eps_i in compose.weighted's form (at
        # one rank: the single-process blend, bit for bit)
        eps = torch.stack([apply_fn(p, x, t, *lab).float()
                           for p, lab in zip(params, labs)])
        w = w_local.reshape((-1,) + (1,) * (eps.dim() - 1))
        return all_reduce((w * eps).sum(dim=0), mesh, "expert") / w_sum

    return eps_fn


@torch.inference_mode()
def sample_expert_parallel(params_list: Sequence[Any], x_init, mesh, model,
                           labels=None, n_steps: int = 50,
                           dtype: torch.dtype = torch.bfloat16,
                           device=None) -> torch.Tensor:
    """``entry.sample`` (a ``DiT``: the folded serving path, through
    ``fused_dit_block``) or ``entry.sample_shapes`` (a ``UNet``, through
    ``groupnorm_silu``) with the K experts spread over the mesh's 'expert'
    axis and the batch over 'data'. Call it on every rank of the mesh with
    the same arguments.

    ``params_list``: all K experts' trees (``convert.from_flax``), of which
    this rank keeps its slice; K is padded to a multiple of the expert axis
    as ``pad_expert_stack`` pads a stack (zero-weight copies of expert 0).
    ``x_init``: the global (B, H, W, C) noise; ``labels``: the UNet's
    (K, B) per-expert labels. ``dtype`` is the experts' compute type,
    blended in float32 as the single-process paths do. ``device=None`` is
    the CUDA card. Returns this rank's rows of the float32 samples (DDIM on
    ``VPSchedule()``, unit weights)."""
    dev = resolve_device(device)
    if isinstance(model, DiT):
        forward = make_folded_apply(dataclasses.replace(model, dtype=dtype),
                                    True)
        layout = None
    else:
        forward = dataclasses.replace(model, dtype=dtype,
                                      fused_gn=True).apply
        layout = unet_torch_layout
    k, n_expert = len(params_list), axis_size(mesh, "expert")
    labs = () if labels is None else (torch.as_tensor(labels),)
    pad = (-k) % n_expert
    trees = list(params_list) + [params_list[0]] * pad
    weights = torch.cat([torch.ones(k), torch.zeros(pad)])
    labs = [torch.cat([lab, lab[:1].expand(pad, *lab.shape[1:])])
            for lab in labs]
    k_local = len(trees) // n_expert
    lo = axis_index(mesh, "expert") * k_local
    local = [tree_map(lambda a: a.to(dev, dtype),
                      layout(tree) if layout else tree)
             for tree in trees[lo:lo + k_local]]
    labs = [Sharding(mesh, ("expert", "data")).shard(lab) for lab in labs]

    def apply(p, x, t, *lab):
        return forward(p, x.to(dtype), t.to(dtype), *lab)

    eps_fn = _local_eps_fn(apply, mesh, local, weights, labs, dev)
    x = shard_batch(torch.as_tensor(x_init, dtype=torch.float32), mesh)
    return ddim(eps_fn, VPSchedule(), x.to(dev), n_steps)
