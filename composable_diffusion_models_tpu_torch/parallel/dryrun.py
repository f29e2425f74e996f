"""The multichip dry run: every parallel path once, at tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package's
entry): over a world of ranks, an expert- and data-parallel train step and
expert-parallel DDIM on a base-8 UNet, expert-parallel DDIM through the
folded DiT (``fused_dit_block`` on the card), a data x tensor-parallel
train step, a pipeline over DiT blocks held against the blocks applied in
order, and ring attention held against full attention. Every rank runs on
the device it is given; nothing moves to the CPU.

    python -m composable_diffusion_models_tpu_torch.parallel.dryrun [WORLD]
"""

from __future__ import annotations

import sys

import torch

from .. import convert, resolve_device
from ..experts import stack_params, unstack_params
from ..models.dit import DiT, make_folded_apply
from ..models.unet import UNet
from ..ops.attention import flash_attention_ref
from ..rng import Draws
from ..samplers import ddim
from ..schedules import VPSchedule
from ..train import Adam, tree_map
from .mesh import (axis_size, make_mesh, run_ranks, shard_batch,
                   shard_pytree_leading)
from .pp import make_pipeline_apply, shard_stage_params, stack_stage_params
from .sample import make_expert_parallel_eps_fn
from .sp import make_ring_attention
from .tp import make_tp_apply, shard_unet_tp
from .train import (make_dp_train_step, make_expert_parallel_train_step,
                    shard_expert_batch)


def _tree(cfg, seed: int, device, unet: bool = False):
    tree = convert.from_flax(convert.init_params(cfg, seed=seed))
    if unet:
        tree = convert.unet_torch_layout(tree)
    return tree_map(lambda a: a.to(device), tree)


def dryrun_rank(device: torch.device) -> dict:
    """One rank's part of the dry run (the world is already joined)."""
    world = torch.distributed.get_world_size()
    key = Draws(0, device)
    schedule = VPSchedule()
    k_experts = 2 if world % 2 == 0 else 1
    mesh = make_mesh({"expert": k_experts, "data": world // k_experts})
    n_data = axis_size(mesh, "data")

    # expert- and data-parallel training of a base-8 UNet stack
    model = UNet(in_channels=1, base_dim=8, channel_mults=(1, 2))
    stacked = shard_pytree_leading(
        stack_params([_tree(model, i, device, unet=True)
                      for i in range(k_experts)]), mesh, "expert")
    tx = Adam(1e-3)
    k_local = k_experts // axis_size(mesh, "expert")
    opt = stack_params([tx.init(p) for p in unstack_params(stacked, k_local)])
    step = make_expert_parallel_train_step(model.apply, schedule, tx, mesh)
    batch = shard_expert_batch(
        key.fold_in(1).normal((k_experts, 2 * n_data, 16, 16, 1)), mesh)
    new_params, _, losses = step(stacked, opt, 0, batch)
    assert bool(torch.isfinite(losses).all()), "non-finite loss in dryrun"

    # expert-parallel composed sampling: the trained stack, DDIM
    weights = torch.ones(k_experts, device=device)
    x_init = shard_batch(key.fold_in(99).normal((2 * n_data, 16, 16, 1)),
                         mesh)
    eps_fn = make_expert_parallel_eps_fn(model.apply, mesh, new_params,
                                         weights, device=device)
    samples = ddim(eps_fn, schedule, x_init, n_steps=4)
    assert bool(torch.isfinite(samples).all()), "non-finite sample in dryrun"

    # the same through the folded DiT serving transform
    dit = DiT(patch=4, dim=32, depth=1, n_heads=2, in_channels=1,
              qkv_fused=True, img_size=16)
    dit_stacked = shard_pytree_leading(
        stack_params([_tree(dit, 50 + i, device) for i in range(k_experts)]),
        mesh, "expert")
    dit_eps = make_expert_parallel_eps_fn(make_folded_apply(dit), mesh,
                                          dit_stacked, weights, device=device)
    dit_samples = ddim(dit_eps, schedule, x_init, n_steps=4)
    assert bool(torch.isfinite(dit_samples).all()), \
        "non-finite folded-DiT EP sample in dryrun"

    # data x tensor parallel: output channels split over 'model'
    tp_model = UNet(in_channels=1, base_dim=16, channel_mults=(1, 2))
    tp_mesh = make_mesh({"data": world // 2, "model": 2} if world % 2 == 0
                        else {"data": world, "model": 1})
    tp_full = _tree(tp_model, 7, device, unet=True)
    tp_params = shard_unet_tp(tp_full, tp_mesh, "model")
    tp_step = make_dp_train_step(
        make_tp_apply(tp_model.apply, tp_full, tp_mesh, "model"), schedule,
        tx, tp_mesh)
    tp_batch = shard_batch(
        key.fold_in(2).normal((2 * axis_size(tp_mesh, "data"), 16, 16, 1)),
        tp_mesh)
    _, _, tp_loss = tp_step(tp_params, tx.init(tp_params), 0, tp_batch)
    assert bool(torch.isfinite(tp_loss)), "non-finite TP loss in dryrun"

    # pipeline over DiT blocks, the conditioning vector riding the
    # activation as one extra token row, against the blocks in order
    n_stages = 2 if world % 2 == 0 else 1
    pp_mesh = make_mesh({"stage": n_stages, "data": world // n_stages})
    dim, n_tok = 8, 4
    cfg = DiT(patch=4, dim=dim, depth=1, n_heads=2)
    stages = [_tree(cfg, 60 + i, device)["params"]["block_0"]
              for i in range(n_stages)]

    def stage_fn(p, xx):
        return torch.cat([cfg._block(p, xx[:, :-1], xx[:, -1]),
                          xx[:, -1:]], dim=1)

    xs = key.fold_in(60).normal((4, 2, n_tok + 1, dim))
    ref = xs
    for p in stages:
        ref = torch.stack([stage_fn(p, mb) for mb in ref])
    pipe = make_pipeline_apply(stage_fn, pp_mesh, n_stages)
    pp_out = pipe(shard_stage_params(stack_stage_params(stages), pp_mesh),
                  xs)
    assert torch.allclose(pp_out, ref, rtol=2e-5, atol=2e-5), \
        "pipeline output != sequential DiT-block reference"

    # ring attention with the token axis sharded over 'seq'
    sp_mesh = make_mesh({"seq": world})
    q = key.fold_in(70).normal((1, 1, 4 * world, 8))
    q_local = shard_batch(q.transpose(0, 2), sp_mesh, "seq").transpose(0, 2)
    ring_out = make_ring_attention(sp_mesh)(q_local, q_local, q_local)
    ref_ring = shard_batch(flash_attention_ref(q, q, q).transpose(0, 2),
                           sp_mesh, "seq").transpose(0, 2)
    assert torch.allclose(ring_out, ref_ring, rtol=2e-5, atol=2e-5), \
        "ring attention != full attention"

    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "losses": losses.tolist(), "sampled": tuple(samples.shape),
            "ep_folded_dit": tuple(dit_samples.shape),
            "tp_mesh": dict(zip(tp_mesh.mesh_dim_names, tp_mesh.mesh.shape)),
            "tp_loss": float(tp_loss), "pp_stages": n_stages,
            "ring_seq": world}


def dryrun_multichip(world_size: int, backend=None, device=None) -> list:
    """Run :func:`dryrun_rank` on ``world_size`` new ranks (``device=None``:
    the CUDA card, raises without one; NCCL there, gloo on the CPU, unless
    ``backend`` says otherwise). Returns each rank's summary. gloo has no
    all-gather or point-to-point exchange for CUDA tensors, so a world of
    more than one rank on the card needs NCCL, one card a rank."""
    dev = resolve_device(device)
    if (backend == "gloo" and dev.type == "cuda" and world_size > 1):
        raise ValueError("the dry run's tensor, pipeline and ring paths need "
                         "all-gather and send/recv, which gloo lacks for CUDA "
                         "tensors: use NCCL (one card a rank) or the CPU")
    out = run_ranks(dryrun_rank, world_size, backend=backend, device=dev)
    print(f"dryrun_multichip ok: {out[0]}", flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
