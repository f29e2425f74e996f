"""Device mesh, placements and collectives on ``torch.distributed``.

Port of ``composable_diffusion_models_tpu.parallel.mesh``. One process per
rank; a ``DeviceMesh`` with named dims stands for ``jax.sharding.Mesh``:

  * ``data``   — batch-dim data parallelism for training and sampling;
  * ``expert`` — the K stacked expert networks placed across ranks; the
    eps blend at the composition point is one all-reduce over the axis.

Where JAX places one global array with a ``NamedSharding``, each rank here
holds its own shard as an ordinary tensor: :class:`Sharding` is the slicing
rule a placement stands for, and the collectives that XLA inserted are
explicit calls of this module (:func:`all_reduce`, :func:`all_gather`,
:func:`ppermute`, and the broadcasts of :func:`replicate_pytree`). Each
call appends (kind, axis, numel) to :data:`COLLECTIVES`, so a test counts
exactly what a step communicates.

:func:`initialize_distributed` starts a rank (NCCL for CUDA tensors, gloo
for CPU ones unless the caller names the backend); :func:`run_ranks`
spawns a world of ranks, each running one function, and returns what each
returned.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device
from ..train import tree_map

# (kind, axis, numel) of every collective this module issued in the process
COLLECTIVES: List[Tuple[str, str, int]] = []


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_backend(backend: str, world_size: int, device) -> None:
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("the NCCL backend needs CUDA tensors: pass a "
                             "CUDA device or backend='gloo'")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise RuntimeError(
                f"NCCL puts one rank on a card: a world of {world_size} ranks "
                f"needs {world_size} CUDA devices, this host has {cards} "
                "(ask for backend='gloo' explicitly to share one card)")


def initialize_distributed(rank: int, world_size: int, init_method: str,
                           backend: Optional[str] = None,
                           device=None) -> torch.device:
    """Join the process group as ``rank`` of ``world_size`` (a thin wrapper
    over ``init_process_group``). ``init_method`` is the rendezvous
    (``file://...`` or ``tcp://host:port``); ``backend`` defaults to
    :func:`default_backend` of ``device`` (``None``: the CUDA card, raises
    without one). An NCCL rank takes card ``rank``; a gloo world on CUDA
    tensors shares the card it is given. Returns the rank's device."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend, world_size, dev)
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dev


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None):
    """A named ``DeviceMesh`` over ``devices`` (ranks; default: every rank
    of the world). ``axis_sizes`` maps axis name -> size with at most one
    -1, which absorbs the remaining ranks. Default: all ranks on 'data'.
    Raises when the mesh needs more ranks than there are. Every rank of
    the world must call it (it creates one process group per axis)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n = len(ranks)
    if axis_sizes is None:
        axis_sizes = {"data": n}
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"mesh {axis_sizes}: at most one axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total > n or total < 1:
        raise ValueError(f"mesh {axis_sizes} needs {total} ranks, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks[:total]).reshape(sizes),
                      mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_local_rank(axis))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A placement: ``spec[d]`` names the mesh axis that dim d is split over
    (None: replicated along it), as a ``PartitionSpec`` does. :meth:`shard`
    returns this rank's slice of a global tensor."""

    mesh: Any
    spec: Tuple[Optional[str], ...] = ()

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            n, i = axis_size(self.mesh, axis), axis_index(self.mesh, axis)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"divide the {axis!r} axis of size {n}")
            step = x.shape[d] // n
            x = x.narrow(d, i * step, step)
        return x


def data_sharding(mesh, ndim: int = 1, axis: str = "data") -> Sharding:
    """Shard the leading (batch) dim over ``axis``, replicate the rest."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def expert_sharding(mesh, ndim: int = 1, axis: str = "expert") -> Sharding:
    """Shard the leading (expert-stack) dim over ``axis``."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's slice of the batch dim by its ``axis`` coordinate."""
    return data_sharding(mesh, x.dim(), axis).shard(x)


def shard_pytree_leading(tree, mesh, axis: str):
    """This rank's slice of every leaf's leading dim over ``axis`` (e.g.
    stacked expert params over the 'expert' axis)."""
    return tree_map(lambda x: expert_sharding(mesh, x.dim(), axis).shard(x),
                    tree)


def replicate_pytree(tree, mesh):
    """Every leaf as the mesh's first rank holds it (one broadcast a leaf):
    the value a replicated placement gives every rank."""
    src = int(mesh.mesh.flatten()[0])
    group = dist.group.WORLD

    def bcast(x):
        x = x.clone()
        COLLECTIVES.append(("broadcast", "*", x.numel()))
        dist.broadcast(x, src=src, group=group)
        return x
    return tree_map(bcast, tree)


# ------------------------------------------------------------ collectives
def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axis`` (``lax.psum``), in place
    when ``x`` may be written (else on a copy); returns the sum."""
    if not x.is_contiguous() or (x.is_inference()
                                 and not torch.is_inference_mode_enabled()):
        x = x.clone(memory_format=torch.contiguous_format)
    COLLECTIVES.append(("all_reduce", axis, x.numel()))
    dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of ``x`` along ``axis`` concatenated on ``dim``, in axis
    order."""
    n = axis_size(mesh, axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    COLLECTIVES.append(("all_gather", axis, x.numel()))
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def ppermute(tensors: Sequence[torch.Tensor], mesh, axis: str,
             shift: int = 1) -> List[torch.Tensor]:
    """``lax.ppermute`` around the ring of ``axis``: position i sends each
    tensor to i + shift and receives the one of i - shift (mod the size).
    The identity on an axis of size 1."""
    n = axis_size(mesh, axis)
    if n == 1:
        return [t.clone() for t in tensors]
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    i = axis_index(mesh, axis)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    out = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
           for t in tensors]
    ops = []
    for t, buf in zip(tensors, out):
        COLLECTIVES.append(("ppermute", axis, t.numel()))
        ops += [dist.P2POp(dist.isend, t.contiguous(), dst, group),
                dist.P2POp(dist.irecv, buf, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` whose backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, mesh, axis, shift, *tensors):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return tuple(ppermute(tensors, mesh, axis, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        back = ppermute(grads, ctx.mesh, ctx.axis, -ctx.shift)
        return (None, None, None, *back)


def ppermute_grad(tensors: Sequence[torch.Tensor], mesh, axis: str,
                  shift: int = 1) -> Tuple[torch.Tensor, ...]:
    """Differentiable :func:`ppermute`: all tensors hop in one exchange, so
    every rank runs the backward exchanges in the same order."""
    return _PPermute.apply(mesh, axis, shift, *tensors)


class _SumReplicated(torch.autograd.Function):
    """All-reduce sum whose result every rank then uses alike (a replicated
    loss): each rank's gradient reaches its own summand unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _SumReplicated.apply(x, mesh, axis)


# ------------------------------------------------------------------ ranks
def _rank_main(fn, rank, world_size, backend, device, store, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = initialize_distributed(rank, world_size, f"file://{store}/store",
                                 backend, device)
    result = fn(dev, *args)
    dist.barrier()
    dist.destroy_process_group()
    torch.save(result, os.path.join(store, f"rank{rank}.pt"))


def run_ranks(fn: Callable, world_size: int, *args, backend: Optional[str]
              = None, device=None, timeout: float = 600.0) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` fresh processes (the
    ``spawn`` start method: the caller may have initialised CUDA), each
    rank r of a new process group that rendezvouses through a file in a
    temporary directory, ``device`` its own (:func:`initialize_distributed`).
    Returns each rank's return value, in rank order, on the CPU.
    ``device=None`` is the CUDA card (raises without one); ``backend``
    defaults to :func:`default_backend`. A rank that fails (non-zero exit)
    ends the others and raises here; so does ``timeout`` seconds without
    the world ending. ``fn`` must be importable by name."""
    import torch.multiprocessing as mp
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    _check_backend(backend, world_size, dev)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as store:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, str(dev),
                                   store, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {world_size} failed (exit code "
                        f"{procs[bad[0]].exitcode}); see its traceback above")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the world of {world_size} ranks did "
                                       f"not end within {timeout:.0f} s")
                procs[0].join(0.05)
            bad = [r for r, p in enumerate(procs) if p.exitcode]
            if bad:
                raise RuntimeError(
                    f"rank {bad[0]} of {world_size} failed (exit code "
                    f"{procs[bad[0]].exitcode}); see its traceback above")
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        return [torch.load(os.path.join(store, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
