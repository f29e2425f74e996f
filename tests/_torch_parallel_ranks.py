"""Rank-side cases of ``tests/test_torch_parallel.py``.

Each function runs inside one rank of a gloo world on the CPU
(``parallel.mesh.run_ranks``), imports only the PyTorch port and returns
numpy arrays; the test compares them with the JAX package's sharded
functions and with the port's single-process computations.
"""

import numpy as np
import torch

from composable_diffusion_models_tpu_torch import convert, samplers, train
from composable_diffusion_models_tpu_torch.experts import (pad_expert_stack,
                                                           stack_params)
from composable_diffusion_models_tpu_torch.models.dit import DiT
from composable_diffusion_models_tpu_torch.models.unet import UNet
from composable_diffusion_models_tpu_torch.parallel import mesh as pmesh
from composable_diffusion_models_tpu_torch.parallel.mesh import (
    Sharding, make_mesh, replicate_pytree, shard_batch,
    shard_pytree_leading)
from composable_diffusion_models_tpu_torch.parallel.pp import (
    make_pipeline_apply, shard_stage_params, stack_stage_params)
from composable_diffusion_models_tpu_torch.parallel.sample import (
    make_expert_parallel_eps_fn, sample_expert_parallel)
from composable_diffusion_models_tpu_torch.parallel.sp import (
    make_ring_attention)
from composable_diffusion_models_tpu_torch.parallel.tp import (
    make_tp_apply, shard_unet_tp)
from composable_diffusion_models_tpu_torch.parallel.train import (
    make_dp_train_step, make_expert_parallel_train_step, shard_expert_batch)
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

UNET8 = UNet(in_channels=1, base_dim=8, channel_mults=(1, 2))
UNET8_LAB = UNet(in_channels=1, base_dim=8, channel_mults=(1, 2),
                 num_classes=(3,))
UNET8_NULL = UNet(in_channels=1, base_dim=8, channel_mults=(1, 2),
                  num_classes=(3,), null_token=True)
UNET16 = UNet(in_channels=1, base_dim=16, channel_mults=(1, 2))
UNET16_XATTN = UNet(in_channels=1, base_dim=16, channel_mults=(1, 2),
                    num_classes=(3,), cross_attn=True, attn_heads=2)
PP_DIT = DiT(patch=4, dim=16, depth=1, n_heads=2)
# narrow stand-ins of the served experts (entry.FLAGSHIP, entry.SHAPES_UNET)
SERVE_DIT = DiT(patch=7, dim=64, depth=1, n_heads=4, in_channels=1,
                qkv_fused=True, img_size=28)
SERVE_UNET = UNet(in_channels=3, base_dim=8, channel_mults=(1, 2),
                  num_classes=(3,))


class SGD:
    """``optax.sgd(lr)``: p - lr g, no state."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return {}

    def update(self, grads, state, params):
        return train.tree_map(lambda p, g: p - self.lr * g, params,
                              grads), state


def unet_tree(tree):
    return convert.unet_torch_layout(convert.from_flax(tree))


def leaves(tree):
    return [x.detach().numpy() for x in train.flatten(tree)[1]]


def colls():
    return list(pmesh.COLLECTIVES)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------ the world of 4 (2 x 2)
def world_expert_data(device, inp):
    """expert 2 x data 2: the EP eps function (labels; driving DDIM), the
    EP train step with CFG dropout and the JAX draws replayed, make_mesh's
    -1 and its errors, replicate_pytree."""
    rank = torch.distributed.get_rank()
    out = {"rank": rank}
    mesh = make_mesh({"expert": 2, "data": -1})
    out["mesh_shape"] = tuple(mesh.mesh.shape)
    out["mesh_names"] = mesh.mesh_dim_names
    out["expert"], out["data"] = (int(mesh.get_local_rank("expert")),
                                  int(mesh.get_local_rank("data")))
    for bad in ({"data": 8}, {"a": -1, "b": -1}):
        try:
            make_mesh(bad)
            out[f"raised {bad}"] = False
        except ValueError:
            out[f"raised {bad}"] = True

    e = inp["eps"]
    local = shard_pytree_leading(stack_params(
        [unet_tree(t) for t in e["trees"]]), mesh, "expert")
    labs = (Sharding(mesh, ("expert", "data")).shard(_t(e["labels"])),)
    fn = make_expert_parallel_eps_fn(UNET8_LAB.apply, mesh, local,
                                     _t(e["w"]), labs, device=device)
    pmesh.COLLECTIVES.clear()
    out["eps"] = fn(shard_batch(_t(e["x"]), mesh), torch.tensor(0.5)).numpy()
    out["eps_colls"] = colls()

    d = inp["ddim"]
    local = shard_pytree_leading(stack_params(
        [unet_tree(t) for t in d["trees"]]), mesh, "expert")
    fn = make_expert_parallel_eps_fn(UNET8.apply, mesh, local,
                                     torch.ones(2), device=device)
    pmesh.COLLECTIVES.clear()
    out["ddim"] = samplers.ddim(fn, VPSchedule(),
                                shard_batch(_t(d["x"]), mesh), 4).numpy()
    out["ddim_colls"] = colls()

    t = inp["ep_train"]
    local = shard_pytree_leading(stack_params(
        [unet_tree(tr) for tr in t["trees"]]), mesh, "expert")
    tx = SGD(1e-2)
    opt = stack_params([tx.init(None)])
    step = make_expert_parallel_train_step(
        UNET8_NULL.apply, VPSchedule(), tx, mesh, uncond_prob=0.5,
        null_labels=(3,))
    pmesh.COLLECTIVES.clear()
    new, _, losses = step(
        local, opt, Replay(t["draws"][rank]),
        shard_expert_batch(_t(t["batch"]), mesh),
        (shard_expert_batch(_t(t["labels"]), mesh),))
    out["ep_train_colls"] = colls()
    out["ep_train_params"] = leaves(new)
    out["ep_train_losses"] = losses.numpy()

    mine = {"a": torch.full((3,), float(rank))}
    out["replicated"] = replicate_pytree(mine, mesh)["a"].numpy()
    return out


# ------------------------------------------------------ the world of 2
def _dp(device, case):
    model = UNET8_NULL if case["labels"] is not None else UNET8
    mesh = make_mesh({"data": 2})
    step = make_dp_train_step(model.apply, VPSchedule(), SGD(1e-2), mesh,
                              **case["kw"])
    labels = (() if case["labels"] is None
              else (shard_batch(_t(case["labels"]), mesh),))
    pmesh.COLLECTIVES.clear()
    new, _, loss = step(unet_tree(case["tree"]), {}, Replay(case["draws"]),
                        shard_batch(_t(case["batch"]), mesh), labels)
    return {"params": leaves(new), "loss": float(loss), "colls": colls()}


def _tp(device, inp):
    rank = torch.distributed.get_rank()
    mesh = make_mesh({"data": 1, "model": 2})
    out = {}
    full = unet_tree(inp["tree"])
    local = shard_unet_tp(full, mesh, "model")
    out["init_conv_rows"] = local["params"]["init_conv"]["weight"].shape[0]
    x, t = _t(inp["x"]), _t(inp["t"])
    out["apply"] = make_tp_apply(UNET16.apply, full, mesh)(
        local, shard_batch(x, mesh), t).numpy()

    full = unet_tree(inp["xattn_tree"])
    local = shard_unet_tp(full, mesh, "model")
    apply = make_tp_apply(UNET16_XATTN.apply, full, mesh)
    lab = _t(inp["labels"])
    out["xattn"] = apply(local, x, t, lab).numpy()
    loss, grads = train.value_and_grad(
        lambda p: (apply(p, x, t, lab) ** 2).mean(), local)
    out["xattn_loss"] = float(loss)
    out["xattn_grads"] = leaves(grads)

    trees = [unet_tree(tr) for tr in inp["experts"]]
    locals_ = [shard_unet_tp(tr, mesh, "model") for tr in trees]
    applies = [make_tp_apply(UNET16.apply, tr, mesh) for tr in trees]

    def eps_fn(xx, tt):
        return sum(a(p, xx, tt) for a, p in zip(applies, locals_)) / 2.0
    out["ddim"] = samplers.ddim(eps_fn, VPSchedule(), _t(inp["x_init"]),
                                4).numpy()

    # one data x tensor parallel step (SGD) from the JAX draws
    step = make_dp_train_step(make_tp_apply(UNET16.apply, trees[0], mesh),
                              VPSchedule(), SGD(1e-2), mesh)
    new, _, loss = step(locals_[0], {}, Replay(inp["step_draws"]),
                        shard_batch(_t(inp["batch"]), mesh))
    out["step_params"] = leaves(new)
    out["step_loss"] = float(loss)
    out["rank"] = rank
    return out


def _pp(device, inp):
    mesh = make_mesh({"stage": 2})
    out = {}

    def dense_stage(p, x):
        return torch.tanh(x @ p["kernel"] + p["bias"])

    def dit_stage(p, x):
        return torch.cat([PP_DIT._block(p, x[:, :-1], x[:, -1]),
                          x[:, -1:]], dim=1)

    for name, stage_fn in (("dense", dense_stage), ("dit", dit_stage)):
        ps = [convert.from_flax(p) for p in inp[name]["params"]]
        pipe = make_pipeline_apply(stage_fn, mesh, 2)
        local = shard_stage_params(stack_stage_params(ps), mesh)
        xs = _t(inp[name]["xs"])
        out[name] = pipe(local, xs).numpy()
        _, grads = train.value_and_grad(
            lambda st: (pipe(st, xs) ** 2).sum(), local)
        out[name + "_grads"] = leaves(grads)
    return out


def _ring(device, inp):
    mesh = make_mesh({"seq": 2})
    ring = make_ring_attention(mesh)

    def local(a):
        return shard_batch(_t(a).transpose(0, 2), mesh, "seq") \
            .transpose(0, 2).contiguous().requires_grad_(True)
    q, k, v = (local(inp[n]) for n in "qkv")
    with torch.enable_grad():
        out = ring(q, k, v)
        grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    return {"out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def _padded(device, inp):
    mesh = make_mesh({"expert": 2, "data": 1})
    stacked = stack_params([unet_tree(t) for t in inp["trees"]])
    padded, w, labs = pad_expert_stack(stacked, _t(inp["w"]), 2,
                                       (_t(inp["labels"]),))
    local = shard_pytree_leading(padded, mesh, "expert")
    labs = [Sharding(mesh, ("expert", "data")).shard(lab) for lab in labs]
    fn = make_expert_parallel_eps_fn(UNET8_LAB.apply, mesh, local, w, labs,
                                     device=device)
    refused = {}
    for name, args in (("unpadded", (stacked, _t(inp["w"]))),
                       ("whole stack", (padded, w))):
        try:
            make_expert_parallel_eps_fn(UNET8_LAB.apply, mesh, *args,
                                        device=device)
            refused[name] = None
        except ValueError as err:
            refused[name] = str(err)
    return {"w": w.numpy(), "refused": refused,
            "eps": fn(_t(inp["x"]), torch.tensor(0.5)).numpy()}


def _serve(device, inp):
    dit = sample_expert_parallel(
        [convert.from_flax(t) for t in inp["dit_trees"]], inp["dit_x"],
        make_mesh({"expert": 2, "data": 1}), SERVE_DIT, n_steps=3,
        dtype=torch.float32, device=device)
    unet = sample_expert_parallel(
        [convert.from_flax(t) for t in inp["unet_trees"]], inp["unet_x"],
        make_mesh({"expert": 1, "data": 2}), SERVE_UNET,
        labels=inp["unet_labels"], n_steps=3, dtype=torch.float32,
        device=device)
    return {"dit": dit.numpy(), "unet": unet.numpy()}


def world_pairs(device, inp):
    """Worlds of 2: DP (plain, CFG dropout, min-SNR), TP (apply, the
    cross-attention UNet and its gradients, a composed DDIM, a DP x TP
    step), PP (dense + tanh and DiT blocks, with gradients), ring attention
    (with gradients), K = 3 experts padded on an expert axis of 2, and the
    served compositions (K = 3 folded DiTs over expert 2, two UNets over
    data 2)."""
    return {"dp": [_dp(device, c) for c in inp["dp"]],
            "serve": _serve(device, inp["serve"]),
            "tp": _tp(device, inp["tp"]), "pp": _pp(device, inp["pp"]),
            "ring": _ring(device, inp["ring"]),
            "padded": _padded(device, inp["padded"]),
            "rank": torch.distributed.get_rank()}


def fails_on_rank_1(device):
    """Rank 1 raises; rank 0 then waits in a collective that never ends."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    torch.distributed.barrier()


def served_on_card(device, trees, x, n_steps):
    """The flagship's expert-parallel composition at world 1 (NCCL) and the
    rank's fused_dit_block launches."""
    from composable_diffusion_models_tpu_torch import entry
    from composable_diffusion_models_tpu_torch.ops import kernels
    kernels.fused_dit_block.launches = 0
    out = sample_expert_parallel(trees, x, make_mesh({"expert": 1,
                                                      "data": 1}),
                                 entry.FLAGSHIP, n_steps=n_steps,
                                 device=device)
    return {"out": out, "launches": kernels.fused_dit_block.launches}
