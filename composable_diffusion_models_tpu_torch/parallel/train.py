"""Sharded training steps: data-parallel and expert-parallel.

Port of ``composable_diffusion_models_tpu.parallel.train``. The K experts
of a composition are independent networks trained on disjoint data: their
parameters are stacked on an 'expert' mesh axis (each rank holds its
experts' shard) with batches sharded (expert, data). Gradients never cross
the expert axis: the only collective of a step is one all-reduce over
'data', which averages the gradients and the loss of each rank's experts
(all of them in one flat buffer).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..experts import stack_params, unstack_params
from ..rng import Draws, as_draws
from ..train import flatten, make_loss_fn, unflatten, value_and_grad
from .mesh import Sharding, all_reduce, axis_index, axis_size


class _Rows(Draws):
    """Draws of the global batch of which this rank keeps its rows: a draw
    of shape (b, ...) draws (b * count, ...) from the wrapped key, as the
    single-device step does, and returns rows [index * b, (index + 1) * b)."""

    def __init__(self, inner: Draws, index: int, count: int):
        self.inner, self.index, self.count = inner, index, count
        self.device = inner.device

    def fold_in(self, data: int) -> "_Rows":
        return _Rows(self.inner.fold_in(data), self.index, self.count)

    def split(self, num: int) -> list:
        return [_Rows(d, self.index, self.count)
                for d in self.inner.split(num)]

    def _rows(self, draw, shape):
        b = shape[0]
        full = draw((b * self.count,) + tuple(shape[1:]))
        return full[self.index * b:(self.index + 1) * b]

    def uniform(self, shape, low=0.0, high=1.0):
        return self._rows(lambda s: self.inner.uniform(s, low, high), shape)

    def randint(self, shape, high):
        return self._rows(lambda s: self.inner.randint(s, high), shape)

    def normal(self, shape, dtype=torch.float32):
        return self._rows(lambda s: self.inner.normal(s, dtype), shape)


def _mean_over_data(trees: list, losses: list, mesh):
    """Average every gradient tree and loss over the 'data' axis with one
    all-reduce of one flat buffer."""
    n = axis_size(mesh, "data")
    flat = [flatten(t) for t in trees]
    leaves = [x for _, ls in flat for x in ls] + [l.reshape(1) for l in losses]
    buf = all_reduce(torch.cat([x.reshape(-1).float() for x in leaves]),
                     mesh, "data") / n
    out, off = [], 0
    for x in leaves:
        out.append(buf[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    trees_out, i = [], 0
    for paths, ls in flat:
        trees_out.append(unflatten(paths, out[i:i + len(ls)]))
        i += len(ls)
    return trees_out, [x.reshape(()) for x in out[i:]]


def make_dp_train_step(apply_fn, schedule, tx, mesh, time_first: bool = False,
                       uncond_prob: float = 0.0,
                       null_labels: Optional[Sequence[int]] = None,
                       snr_gamma: Optional[float] = None,
                       predict: str = "eps"):
    """Data-parallel step: params replicated, batch sharded on 'data'.

    ``step(params, opt_state, key, x0, labels=())`` with x0 and labels this
    rank's shard of the global batch (``shard_batch``). The loss draws t,
    the noise and the label dropout for the GLOBAL batch from ``key``, as
    the single-device ``train.make_train_step`` does, and keeps this rank's
    rows; gradients and loss are averaged over 'data'. So the step gives
    the single-device step's result up to summation order. ``tx`` is the
    optimizer (``train.Adam``); ``uncond_prob`` / ``null_labels`` (CFG
    dropout), ``snr_gamma`` and ``predict`` as in ``make_loss_fn``."""
    loss_fn = make_loss_fn(apply_fn, schedule, time_first=time_first,
                           uncond_prob=uncond_prob, null_labels=null_labels,
                           snr_gamma=snr_gamma, predict=predict)
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")

    def step(params, opt_state, key, x0, labels=()):
        draws = _Rows(as_draws(key, x0.device), i, n)
        loss, grads = value_and_grad(loss_fn, params, draws, x0,
                                     tuple(labels))
        (grads,), (loss,) = _mean_over_data([grads], [loss], mesh)
        params, opt_state = tx.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def make_expert_parallel_train_step(apply_fn, schedule, tx, mesh,
                                    time_first: bool = False,
                                    uncond_prob: float = 0.0,
                                    null_labels: Optional[Sequence[int]]
                                    = None,
                                    snr_gamma: Optional[float] = None,
                                    predict: str = "eps"):
    """Expert- and data-parallel step over STACKED expert params.

    ``step(stacked_params, stacked_opt, key, batch, labels=())``: this
    rank's expert shard of the stacked params and optimizer states (leading
    K_local = K / expert size; ``stack_params`` of ``tx.init`` per expert),
    its (expert, data) shard of the (K, B, ...) batch and of each (K, B)
    label array (``shard_expert_batch``). The rank folds its 'expert' and
    then its 'data' coordinate into ``key`` and splits one key per local
    expert; each expert's gradients and loss are averaged over 'data' only.
    Returns the updated stacks and the per-expert losses (K_local,)."""
    loss_fn = make_loss_fn(apply_fn, schedule, time_first=time_first,
                           uncond_prob=uncond_prob, null_labels=null_labels,
                           snr_gamma=snr_gamma, predict=predict)
    e, d = axis_index(mesh, "expert"), axis_index(mesh, "data")

    def step(stacked_params, stacked_opt, key, batch, labels=()):
        k_local = batch.shape[0]
        keys = as_draws(key, batch.device).fold_in(e).fold_in(d).split(k_local)
        params = unstack_params(stacked_params, k_local)
        opts = unstack_params(stacked_opt, k_local)
        grads, losses = [], []
        for j in range(k_local):
            loss, g = value_and_grad(loss_fn, params[j], keys[j], batch[j],
                                     tuple(lab[j] for lab in labels))
            grads.append(g)
            losses.append(loss)
        grads, losses = _mean_over_data(grads, losses, mesh)
        new = [tx.update(g, o, p) for g, o, p in zip(grads, opts, params)]
        return (stack_params([p for p, _ in new]),
                stack_params([o for _, o in new]), torch.stack(losses))

    return step


def shard_expert_batch(batch: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's (expert, data) shard of a (K, B, ...) batch."""
    return Sharding(mesh, ("expert", "data")).shard(batch)
