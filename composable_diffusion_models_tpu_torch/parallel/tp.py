"""Tensor-parallel (model-axis) sharding of the UNet, computed on shards.

Port of ``composable_diffusion_models_tpu.parallel.tp``. Layout rule
(channels-last NHWC everywhere), per leaf of the port's tree:

  * conv weights  (cout, cin, kh, kw) -> shard cout on the model axis
  * dense kernels (cin, cout)         -> shard cout
  * biases / GN scale+bias (c,)       -> shard c
  * embedding tables (vocab, emb)     -> shard emb

i.e. the output-channel dim (the trailing one of the flax tree's leaf);
a leaf whose dim does not divide the axis size is replicated (e.g. the
1- or 3-channel output head). The JAX package places the tree and lets
GSPMD partition the jitted apply; the port has no GSPMD, so
:func:`make_tp_apply` computes on the shards itself: it passes
``UNet.apply`` the call's layout (``tp=``), through which each
convolution and dense layer computes its rank's slice of the output
channels, and the slices are gathered along channels at once (every
consumer of a UNet layer, GroupNorm (K4 on the card), attention, the next
layer and the head, reads every channel). The result equals the unsharded
UNet; gradients flow (each sharded layer's input gradient is summed over
the axis in the backward pass).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..train import flatten, unflatten
from .mesh import all_gather, all_reduce, axis_index, axis_size

Params = Any


def _spec_for(path: Tuple[str, ...], x: torch.Tensor,
              axis_size_: int) -> Optional[int]:
    """The dim of ``x`` to shard (its output channels) or None (replicate)."""
    if x.dim() == 0:
        return None
    dim = 0 if path[-1] == "weight" and x.dim() == 4 else x.dim() - 1
    return dim if x.shape[dim] % axis_size_ == 0 else None


def tp_layout(params: Params,
              size: int) -> Dict[Tuple[str, ...], Optional[int]]:
    """{key path: sharded dim or None} of the (unsharded) tree ``params``
    on a model axis of ``size``."""
    return {path: _spec_for(path, x, size)
            for path, x in zip(*flatten(params))}


def shard_unet_tp(params: Params, mesh, axis: str = "model") -> Params:
    """This rank's tensor-parallel shard of a UNet tree (the port's layout,
    ``convert.unet_torch_layout``): output-channel dims split over
    ``axis``, the rest replicated."""
    size, i = axis_size(mesh, axis), axis_index(mesh, axis)
    paths, leaves = flatten(params)
    out = []
    for x, dim in zip(leaves, tp_layout(params, size).values()):
        if dim is not None:
            step = x.shape[dim] // size
            x = x.narrow(dim, i * step, step)
        out.append(x)
    return unflatten(paths, out)


class _Enter(torch.autograd.Function):
    """The identity; the backward sums the gradient over the axis (each
    rank's layer saw only its output channels)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis), \
            None, None


class _Gather(torch.autograd.Function):
    """The channel shards gathered along the last dim; the backward keeps
    this rank's slice of the gradient (every rank's is the same: the
    computation after the gather is replicated)."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.c, ctx.i = y.shape[-1], axis_index(mesh, axis)
        return all_gather(y, mesh, axis, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.i * ctx.c:(ctx.i + 1) * ctx.c], None, None


class _Layout:
    """The layout of one tensor-parallel call, as ``UNet.apply`` reads it
    (``tp=``): ``sharded`` holds the ids of the call's leaves that are this
    rank's slice of their output channels."""

    def __init__(self, sharded_ids, mesh, axis):
        self.sharded, self.mesh, self.axis = sharded_ids, mesh, axis

    def layer(self, weight, fn, *xs):
        """``fn(*xs)`` with all of its output channels: a layer whose
        ``weight`` is sharded computes this rank's slice and gathers."""
        if id(weight) not in self.sharded:
            return fn(*xs)
        return self._gather(fn(*(_Enter.apply(x, self.mesh, self.axis)
                                 if x.requires_grad else x for x in xs)))

    def whole(self, leaf):
        """A norm's sharded parameter with all of its channels."""
        return self._gather(leaf) if id(leaf) in self.sharded else leaf

    def _gather(self, y):
        if y.requires_grad:
            return _Gather.apply(y, self.mesh, self.axis)
        return all_gather(y, self.mesh, self.axis, dim=-1)


def make_tp_apply(apply_fn: Callable[..., torch.Tensor], params: Params,
                  mesh, axis: str = "model"):
    """``tp_apply(local_params, x, t, *labels, **kw)``: ``apply_fn`` (a
    ``UNet.apply``) run on this rank's :func:`shard_unet_tp` shard of
    ``params`` (the unsharded tree, read for its shapes only), computing
    on the channel shards. x and the output are replicated over ``axis``."""
    layout = tp_layout(params, axis_size(mesh, axis))

    def tp_apply(local_params, x, t, *labels, **kw):
        paths, leaves = flatten(local_params)
        ids = {id(leaf) for path, leaf in zip(paths, leaves)
               if layout[path] is not None}
        return apply_fn(local_params, x, t, *labels,
                        tp=_Layout(ids, mesh, axis), **kw)

    return tp_apply
