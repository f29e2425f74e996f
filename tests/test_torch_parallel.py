"""Port parity for ``parallel/``: the expert-parallel eps function, the
data- and expert-parallel train steps, tensor, pipeline and ring-attention
parallelism, the served compositions and the dry run, each in gloo worlds
of CPU ranks (``parallel.mesh.run_ranks``; the ranks' code is in
``_torch_parallel_ranks.py`` and imports only the port) against the JAX
package's sharded functions on the 8 virtual CPU devices and against the
port's single-process computations, on the same numpy inputs and
converted trees. Two worlds carry the cases: one of 4 ranks (expert 2 x
data 2) and one of 2; the dry run and a failing rank have one more each."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_ranks as R
from composable_diffusion_models_tpu import compose as jcompose
from composable_diffusion_models_tpu import experts as jexperts
from composable_diffusion_models_tpu import samplers as jsamplers
from composable_diffusion_models_tpu.models import UNet as JUNet
from composable_diffusion_models_tpu.models.dit import DiTBlock
from composable_diffusion_models_tpu.parallel import (
    make_expert_parallel_eps_fn as jep_eps, make_mesh as jmesh,
    shard_batch as jshard, shard_pytree_leading as jshard_leading,
    shard_unet_tp as jshard_tp)
from composable_diffusion_models_tpu.parallel.pp import (
    make_pipeline_apply as jpipeline, shard_stage_params as jshard_stages,
    stack_stage_params as jstack_stages)
from composable_diffusion_models_tpu.parallel.sp import (
    make_ring_attention as jring)
from composable_diffusion_models_tpu.parallel.tp import _spec_for
from composable_diffusion_models_tpu.parallel.train import (
    make_dp_train_step as jdp_step,
    make_expert_parallel_train_step as jep_step,
    shard_expert_batch as jshard_expert_batch)
from composable_diffusion_models_tpu.schedules import VPSchedule as JaxVP
from composable_diffusion_models_tpu_torch import (compose, convert, entry,
                                                   experts, samplers, train)
from composable_diffusion_models_tpu_torch.ops.attention import (
    flash_attention_ref)
from composable_diffusion_models_tpu_torch.parallel import mesh as pmesh
from composable_diffusion_models_tpu_torch.parallel.dryrun import (
    dryrun_multichip)
from composable_diffusion_models_tpu_torch.parallel.tp import tp_layout
from composable_diffusion_models_tpu_torch.rng import Replay
from composable_diffusion_models_tpu_torch.schedules import VPSchedule

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_sharding.py's bar


def _jax_unet(cfg):
    """The flax module of a port UNet configuration."""
    return JUNet(in_channels=cfg.in_channels, base_dim=cfg.base_dim,
                 channel_mults=cfg.channel_mults,
                 num_classes=cfg.num_classes, null_token=cfg.null_token,
                 cross_attn=cfg.cross_attn, attn_heads=cfg.attn_heads)


def _flax(cfg, seed):
    return convert.init_params(cfg, seed=seed)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port_leaves(flax_tree):
    """A flax UNet tree's leaves in the port's layout and order."""
    return R.leaves(R.unet_tree(jax.tree_util.tree_map(np.asarray,
                                                       flax_tree)))


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh(axes, devices=jax.devices()[:n])


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _loss_draws(key, bs, x_shape, drop=False):
    """The draws the JAX loss takes from ``key``: t, the noise, the
    dropout uniforms (``tests/test_torch_train.py``'s order)."""
    kt, ke, kd = jax.random.split(key, 3)
    out = [jax.random.uniform(kt, (bs,), minval=1e-3, maxval=1.0),
           jax.random.normal(ke, x_shape, jnp.float32)]
    if drop:
        out.append(jax.random.uniform(kd, (bs,)))
    return [np.asarray(a) for a in out]


def _ddim_tol(eps_fn, x, n_steps=4):
    """The single-process composed DDIM and four times its sensitivity to
    one float32 rounding of eps (eps scaled by 1 + 2^-23 at every step):
    the first steps divide eps by alpha(t) ~ 6e-3, so a trajectory carries
    one rounding of eps as ~1e-4, above the per-call 2e-5, and the sharded
    forwards round a few times differently (the all-reduce sums the blend
    in its own order; a tensor-parallel layer's GEMM, split by output
    channels, takes its own reduction order)."""
    x = torch.from_numpy(x)
    ref = samplers.ddim(eps_fn, VPSchedule(), x, n_steps).numpy()
    bumped = samplers.ddim(lambda xx, tt: eps_fn(xx, tt) * (1 + 2.0 ** -23),
                           VPSchedule(), x, n_steps).numpy()
    return ref, 4.0 * float(np.abs(bumped - ref).max())


def _close_leaves(got, ref, rel=None, atol=None):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if rel is not None:
            scale = max(float(np.abs(r).max()), 1e-30)
            assert float(np.abs(g - r).max()) <= rel * scale
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=atol)


# ------------------------------------------------------ the world of 4
@pytest.fixture(scope="module")
def world4():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(5)
    ep_draws = []
    for r in range(4):  # rank r sits at (expert r // 2, data r % 2)
        k = jax.random.fold_in(jax.random.fold_in(key, r // 2), r % 2)
        ep_draws.append(_loss_draws(jax.random.split(k, 1)[0], 4,
                                    (4, 16, 16, 1), drop=True))
    inp = {
        "eps": {"trees": [_flax(R.UNET8_LAB, i) for i in range(2)],
                "labels": np.stack([np.zeros(8, np.int32),
                                    np.ones(8, np.int32)]),
                "w": np.array([1.0, 3.0], np.float32),
                "x": _normal(rng, 8, 16, 16, 1)},
        "ddim": {"trees": [_flax(R.UNET8, 10 + i) for i in range(2)],
                 "x": _normal(rng, 8, 16, 16, 1)},
        "ep_train": {"trees": [_flax(R.UNET8_NULL, 20 + i)
                               for i in range(2)],
                     "batch": _normal(rng, 2, 8, 16, 16, 1),
                     "labels": rng.integers(0, 3, (2, 8)).astype(np.int32),
                     "draws": ep_draws}}
    res = pmesh.run_ranks(R.world_expert_data, 4, inp, device="cpu")
    return inp, res, key


def test_make_mesh_and_replicate(world4):
    """make_mesh's -1 takes the remaining ranks (expert 2 x data 2, rank r
    at (r // 2, r % 2)); a mesh larger than the world, or two -1s, raise;
    replicate_pytree gives every rank the first rank's leaves."""
    _, res, _ = world4
    for r, out in enumerate(res):
        assert out["mesh_shape"] == (2, 2)
        assert out["mesh_names"] == ("expert", "data")
        assert (out["expert"], out["data"]) == (r // 2, r % 2)
        assert out["raised {'data': 8}"] and out["raised {'a': -1, 'b': -1}"]
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))


def test_ep_eps_matches_jax_and_single_process(world4):
    """The expert-parallel blend with per-expert labels sharded (expert,
    data) equals the single-process ExpertStack blend and JAX's shard_map
    eps function (2e-5, test_sharding.py:212); the call issues exactly one
    all-reduce, over the expert axis, of one local eps shard (B / data x
    H x W x C), as the JAX program's one collective does."""
    inp, res, _ = world4
    e = inp["eps"]
    trees = [R.unet_tree(t) for t in e["trees"]]
    x, w = torch.from_numpy(e["x"]), torch.from_numpy(e["w"])
    ref = compose.weighted(experts.ExpertStack(R.UNET8_LAB.apply, trees)(
        x, torch.full((8,), 0.5), experts.per_expert(
            torch.from_numpy(e["labels"]))), w).numpy()
    mesh = _mesh({"expert": 2, "data": 2})
    jm = _jax_unet(R.UNET8_LAB)
    with mesh:
        fn = jep_eps(jm.apply, mesh, jshard_leading(
            jexperts.stack_params([_jtree(t) for t in e["trees"]]), mesh,
            "expert"), jnp.asarray(e["w"]), (jnp.asarray(e["labels"]),))
        jref = np.asarray(jax.jit(fn)(jshard(jnp.asarray(e["x"]), mesh),
                                      jnp.float32(0.5)))
    np.testing.assert_allclose(jref, ref, **TOL)
    for out in res:
        rows = slice(4 * out["data"], 4 * out["data"] + 4)
        np.testing.assert_allclose(out["eps"], ref[rows], **TOL)
        np.testing.assert_allclose(out["eps"], jref[rows], **TOL)
        assert out["eps_colls"] == [("all_reduce", "expert", 4 * 16 * 16)]


def test_ep_eps_drives_ddim(world4):
    """The sharded eps function drops into samplers.ddim unchanged: each
    rank's rows equal the single-process composed DDIM and JAX's EP DDIM
    within four times the trajectory's sensitivity to one rounding of eps
    (:func:`_ddim_tol`), with one expert-axis all-reduce a step."""
    inp, res, _ = world4
    d = inp["ddim"]
    stack = experts.ExpertStack(R.UNET8.apply,
                                [R.unet_tree(t) for t in d["trees"]])
    ref, tol = _ddim_tol(lambda x, t: compose.weighted(stack(x, t),
                                                       torch.ones(2)), d["x"])
    mesh = _mesh({"expert": 2, "data": 2})
    jm = _jax_unet(R.UNET8)
    with mesh:
        fn = jep_eps(jm.apply, mesh, jshard_leading(
            jexperts.stack_params([_jtree(t) for t in d["trees"]]), mesh,
            "expert"), jnp.ones((2,)))
        jref = np.asarray(jax.jit(
            lambda x: jsamplers.ddim(fn, JaxVP(), x, 4))(
                jshard(jnp.asarray(d["x"]), mesh)))
    for out in res:
        rows = slice(4 * out["data"], 4 * out["data"] + 4)
        for r in (ref[rows], jref[rows]):
            np.testing.assert_allclose(out["ddim"], r, rtol=0, atol=tol)
        assert out["ddim_colls"] == [("all_reduce", "expert", 1024)] * 4


def test_ep_train_step_with_cfg_dropout_matches_jax(world4):
    """The expert-parallel step with per-expert labels and CFG null-token
    dropout, each rank replaying the draws that JAX's shard_map step takes
    at its (expert, data) position: per-expert losses rtol 1e-4 and the
    updated stacks atol 1e-4 (SGD, as test_sharding.py:43-58 holds DP);
    its only collective is one all-reduce inside the data group."""
    inp, res, key = world4
    t = inp["ep_train"]
    mesh = _mesh({"expert": 2, "data": 2})
    jm = _jax_unet(R.UNET8_NULL)
    tx = optax.sgd(1e-2)
    stacked = jexperts.stack_params([_jtree(tr) for tr in t["trees"]])
    step = jep_step(jm.apply, JaxVP(), tx, mesh, uncond_prob=0.5,
                    null_labels=(3,))
    with mesh:
        new, _, losses = step(
            jshard_leading(stacked, mesh, "expert"),
            jax.vmap(tx.init)(stacked), key,
            jshard_expert_batch(jnp.asarray(t["batch"]), mesh),
            (jshard_expert_batch(jnp.asarray(t["labels"]), mesh),))
    losses = np.asarray(losses)
    for out in res:
        e = out["expert"]
        np.testing.assert_allclose(out["ep_train_losses"], losses[e:e + 1],
                                   rtol=1e-4)
        ref = _port_leaves(jax.tree_util.tree_map(lambda a: a[e], new))
        _close_leaves([p[0] for p in out["ep_train_params"]], ref,
                      atol=1e-4)
        assert len(out["ep_train_colls"]) == 1
        kind, axis, _ = out["ep_train_colls"][0]
        assert (kind, axis) == ("all_reduce", "data")
    # the two experts moved independently
    assert not np.allclose(res[0]["ep_train_params"][0],
                           res[2]["ep_train_params"][0])


# ------------------------------------------------------ the world of 2
DP_CASES = {"plain": dict(kw={}, labels=False),
            "cfg": dict(kw=dict(uncond_prob=0.5, null_labels=(3,)),
                        labels=True),
            "snr": dict(kw=dict(snr_gamma=5.0), labels=False)}


@pytest.fixture(scope="module")
def world2():
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    dp = []
    for i, (name, case) in enumerate(DP_CASES.items()):
        cfg = R.UNET8_NULL if case["labels"] else R.UNET8
        dp.append({"tree": _flax(cfg, 30 + i), "kw": case["kw"],
                   "batch": _normal(rng, 16, 16, 16, 1),
                   "labels": (rng.integers(0, 3, 16).astype(np.int32)
                              if case["labels"] else None),
                   "draws": _loss_draws(key, 16, (16, 16, 16, 1),
                                        drop=case["labels"])})
    tp = {"tree": _flax(R.UNET16, 40), "x": _normal(rng, 4, 16, 16, 1),
          "t": np.ones(4, np.float32),
          "xattn_tree": _flax(R.UNET16_XATTN, 41),
          "labels": rng.integers(0, 3, 4).astype(np.int64),
          "experts": [_flax(R.UNET16, 42 + i) for i in range(2)],
          "x_init": _normal(rng, 4, 16, 16, 1),
          "batch": _normal(rng, 4, 16, 16, 1),
          "step_draws": _loss_draws(key, 4, (4, 16, 16, 1))}
    pp = {"dense": {"params": [{"kernel": _normal(rng, 16, 16) / 4.0,
                                "bias": 0.1 * _normal(rng, 16)}
                               for _ in range(2)],
                    "xs": _normal(rng, 6, 8, 16)},
          "dit": {"params": [_flax(R.PP_DIT, 50 + i)["params"]["block_0"]
                             for i in range(2)],
                  "xs": _normal(rng, 6, 2, 5, 16)}}
    ring = {n: _normal(rng, 2, 2, 64, 16) for n in "qkv"}
    padded = {"trees": [_flax(R.UNET8_LAB, 60 + i) for i in range(3)],
              "w": np.array([1.0, 2.0, 3.0], np.float32),
              "labels": rng.integers(0, 3, (3, 8)).astype(np.int32),
              "x": _normal(rng, 8, 16, 16, 1)}
    serve = {"dit_trees": [_flax(R.SERVE_DIT, 70 + i) for i in range(3)],
             "dit_x": _normal(rng, 4, 28, 28, 1),
             "unet_trees": [_flax(R.SERVE_UNET, 80 + i) for i in range(2)],
             "unet_x": _normal(rng, 4, 16, 16, 3),
             "unet_labels": rng.integers(0, 3, (2, 4)).astype(np.int32)}
    inp = {"dp": dp, "tp": tp, "pp": pp, "ring": ring, "padded": padded,
           "serve": serve}
    res = pmesh.run_ranks(R.world_pairs, 2, inp, device="cpu")
    return inp, res, key


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_step_matches_single_device_and_jax(world2, case):
    """The data-parallel step (batch sharded on data 2, the JAX draws of
    the global batch replayed) equals the single-device step and JAX's DP
    step: loss rtol 1e-4, params atol 1e-4 (test_sharding.py:43-58, SGD),
    with CFG dropout and min-SNR weighting too (:304, :492). Its one
    collective averages the gradients and the loss over 'data'."""
    inp, res, key = world2
    c = inp["dp"][list(DP_CASES).index(case)]
    cfg = R.UNET8_NULL if c["labels"] is not None else R.UNET8
    labels_t = (() if c["labels"] is None
                else (torch.from_numpy(c["labels"]),))
    step = train.make_train_step(
        train.make_loss_fn(cfg.apply, VPSchedule(), **c["kw"]), R.SGD(1e-2))
    p1, _, loss1 = step(R.unet_tree(c["tree"]), {}, Replay(c["draws"]),
                        torch.from_numpy(c["batch"]), labels_t)
    mesh = _mesh({"data": 2})
    tx = optax.sgd(1e-2)
    params = _jtree(c["tree"])
    jstep = jdp_step(_jax_unet(cfg).apply, JaxVP(), tx, mesh, **c["kw"])
    labels_j = (() if c["labels"] is None
                else (jshard(jnp.asarray(c["labels"]), mesh),))
    with mesh:
        pj, _, lossj = jstep(params, tx.init(params), key,
                             jshard(jnp.asarray(c["batch"]), mesh), labels_j)
    n_params = sum(int(np.prod(p.shape)) for p in R.leaves(p1))
    for out in res:
        o = out["dp"][list(DP_CASES).index(case)]
        for ref_loss in (float(loss1), float(lossj)):
            np.testing.assert_allclose(o["loss"], ref_loss, rtol=1e-4)
        _close_leaves(o["params"], R.leaves(p1), atol=1e-4)
        _close_leaves(o["params"], _port_leaves(pj), atol=1e-4)
        assert o["colls"] == [("all_reduce", "data", n_params + 1)]


def _rank_slice(full_leaves, layout_dims, rank, size=2):
    out = []
    for x, dim in zip(full_leaves, layout_dims):
        if dim is not None:
            step = x.shape[dim] // size
            x = np.take(x, range(rank * step, (rank + 1) * step), axis=dim)
        out.append(x)
    return out


def test_tp_apply_matches_unsharded_and_jax(world2):
    """The tensor-parallel UNet (output channels over model 2, computed on
    the shards) equals the unsharded UNet and JAX's GSPMD-partitioned
    apply (2e-5, test_sharding.py:324-350); the convolutions really are
    split (init_conv holds 8 of 16 output channels a rank)."""
    inp, res, _ = world2
    tp = inp["tp"]
    x, t = torch.from_numpy(tp["x"]), torch.from_numpy(tp["t"])
    ref = R.UNET16.apply(R.unet_tree(tp["tree"]), x, t).numpy()
    mesh = _mesh({"data": 2, "model": 4})
    jm = _jax_unet(R.UNET16)
    with mesh:
        jref = np.asarray(jax.jit(jm.apply)(
            jshard_tp(_jtree(tp["tree"]), mesh, "model"),
            jshard(jnp.asarray(tp["x"]), mesh, "data"), jnp.asarray(tp["t"])))
    for out in res:
        assert out["tp"]["init_conv_rows"] == 8
        np.testing.assert_allclose(out["tp"]["apply"], ref, **TOL)
        np.testing.assert_allclose(out["tp"]["apply"], jref, **TOL)


def test_tp_cross_attention_unet_and_gradients(world2):
    """The labelled cross-attention UNet (label embeddings, LayerNorm,
    attention projections all split) equals the unsharded one (2e-5);
    the gradients of a loss on it, taken through the shards, equal each
    rank's slice of the unsharded gradients (1e-5 of each leaf's scale)."""
    inp, res, _ = world2
    tp = inp["tp"]
    full = R.unet_tree(tp["xattn_tree"])
    x, t = torch.from_numpy(tp["x"]), torch.from_numpy(tp["t"])
    lab = torch.from_numpy(tp["labels"])
    ref = R.UNET16_XATTN.apply(full, x, t, lab).numpy()
    loss, grads = train.value_and_grad(
        lambda p: (R.UNET16_XATTN.apply(p, x, t, lab) ** 2).mean(), full)
    dims = list(tp_layout(full, 2).values())
    for out in res:
        o = out["tp"]
        np.testing.assert_allclose(o["xattn"], ref, **TOL)
        np.testing.assert_allclose(o["xattn_loss"], float(loss), rtol=1e-5)
        _close_leaves(o["xattn_grads"],
                      _rank_slice(R.leaves(grads), dims, o["rank"]),
                      rel=1e-5)


def test_tp_composed_sampler_and_step(world2):
    """Two tensor-parallel experts drive the composed DDIM (against the
    unsharded sampler and JAX's on TP-placed trees, within four times the
    trajectory's one-rounding sensitivity; test_sharding.py:353-372 checks
    that it is finite); a data x tensor-parallel SGD step from the
    JAX draws equals the single-device step sliced to the rank (atol
    1e-4)."""
    inp, res, _ = world2
    tp = inp["tp"]
    trees = [R.unet_tree(tr) for tr in tp["experts"]]
    ref, tol = _ddim_tol(
        lambda xx, tt: sum(R.UNET16.apply(p, xx, tt) for p in trees) / 2.0,
        tp["x_init"])
    mesh = _mesh({"data": 2, "model": 4})
    jm = _jax_unet(R.UNET16)
    with mesh:
        ps = [jshard_tp(_jtree(tr), mesh, "model") for tr in tp["experts"]]
        jref = np.asarray(jax.jit(lambda x: jsamplers.ddim(
            lambda xx, tt: jcompose.weighted(
                jnp.stack([jm.apply(p, xx, tt) for p in ps]), jnp.ones(2)),
            JaxVP(), x, 4))(jshard(jnp.asarray(tp["x_init"]), mesh)))
    step = train.make_train_step(
        train.make_loss_fn(R.UNET16.apply, VPSchedule()), R.SGD(1e-2))
    p1, _, loss1 = step(trees[0], {}, Replay(tp["step_draws"]),
                        torch.from_numpy(tp["batch"]))
    dims = list(tp_layout(trees[0], 2).values())
    for out in res:
        o = out["tp"]
        for r in (ref, jref):
            np.testing.assert_allclose(o["ddim"], r, rtol=0, atol=tol)
        np.testing.assert_allclose(o["step_loss"], float(loss1), rtol=1e-4)
        _close_leaves(o["step_params"],
                      _rank_slice(R.leaves(p1), dims, o["rank"]), atol=1e-4)


def _pp_stage_fns():
    def dense(p, x):
        return torch.tanh(x @ p["kernel"] + p["bias"])

    def jdense(p, x):
        return jnp.tanh(x @ p["kernel"] + p["bias"])

    block = DiTBlock(dim=16, n_heads=2)

    def dit(p, x):
        return torch.cat([R.PP_DIT._block(p, x[:, :-1], x[:, -1]),
                          x[:, -1:]], dim=1)

    def jdit(p, x):
        return jnp.concatenate([block.apply({"params": p}, x[:, :-1],
                                            x[:, -1]), x[:, -1:]], axis=1)
    return {"dense": (dense, jdense), "dit": (dit, jdit)}


@pytest.mark.parametrize("name", ["dense", "dit"])
def test_pipeline_matches_sequential_and_jax(world2, name):
    """The fill-drain pipeline over 2 stages (dense + tanh, and DiT blocks
    with the conditioning riding as one extra token row) equals the
    stages applied in order and JAX's pipeline (2e-5,
    test_sharding.py:374-460); its gradients, taken through the hops,
    equal each stage's gradients of the sequential loss (1e-5 of scale)."""
    inp, res, _ = world2
    c = inp["pp"][name]
    fn, jfn = _pp_stage_fns()[name]
    ps = [convert.from_flax(p) for p in c["params"]]
    xs = torch.from_numpy(c["xs"])

    def seq(params):
        y = xs
        for p in params:
            y = torch.stack([fn(p, mb) for mb in y])
        return y
    ref = seq(ps).numpy()
    stage_grads = [train.value_and_grad(
        lambda p, s=s: (seq(ps[:s] + [p] + ps[s + 1:]) ** 2).sum(), ps[s])[1]
        for s in range(2)]
    mesh = _mesh({"stage": 2, "data": 4})
    stacked = jstack_stages([_jtree(p) for p in c["params"]])
    with mesh:
        jref = np.asarray(jpipeline(jfn, mesh, 2)(
            jshard_stages(stacked, mesh), jnp.asarray(c["xs"])))
    np.testing.assert_allclose(jref, ref, **TOL)
    for s, out in enumerate(res):
        np.testing.assert_allclose(out["pp"][name], ref, **TOL)
        _close_leaves([g[0] for g in out["pp"][name + "_grads"]],
                      R.leaves(stage_grads[s]), rel=1e-5)


def test_ring_attention_matches_full_and_jax(world2):
    """Ring attention over seq 2 equals full softmax attention
    (flash_attention_ref) and JAX's ring (2e-5, test_sharding.py:463-490);
    the gradients of q, k, v through the rotations equal each rank's
    token slice of the full attention's (1e-5 of scale)."""
    inp, res, _ = world2
    q, k, v = (torch.from_numpy(inp["ring"][n]).requires_grad_(True)
               for n in "qkv")
    with torch.enable_grad():
        ref = flash_attention_ref(q, k, v)
        grads = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    ref = ref.detach().numpy()
    mesh = _mesh({"seq": 2})
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, None, "seq", None))
    with mesh:
        jref = np.asarray(jring(mesh)(*(jax.device_put(
            jnp.asarray(inp["ring"][n]), spec) for n in "qkv")))
    np.testing.assert_allclose(jref, ref, **TOL)
    for r, out in enumerate(res):
        rows = slice(32 * r, 32 * r + 32)
        np.testing.assert_allclose(out["ring"]["out"], ref[:, :, rows], **TOL)
        _close_leaves(out["ring"]["grads"],
                      [g.numpy()[:, :, rows] for g in grads], rel=1e-5)


def test_uneven_expert_count_pads_to_axis(world2):
    """K = 3 labelled experts on an expert axis of 2: pad_expert_stack adds
    a zero-weight copy of expert 0 (and its labels), and the blend equals
    the 3-expert blend and JAX's padded EP blend (2e-5,
    test_sharding.py:240-271)."""
    inp, res, _ = world2
    c = inp["padded"]
    trees = [R.unet_tree(t) for t in c["trees"]]
    ref = compose.weighted(experts.ExpertStack(R.UNET8_LAB.apply, trees)(
        torch.from_numpy(c["x"]), torch.full((8,), 0.5),
        experts.per_expert(torch.from_numpy(c["labels"]))),
        torch.from_numpy(c["w"])).numpy()
    mesh = _mesh({"expert": 2, "data": 4})
    padded, w, labs = jexperts.pad_expert_stack(
        jexperts.stack_params([_jtree(t) for t in c["trees"]]),
        jnp.asarray(c["w"]), 2, (jnp.asarray(c["labels"]),))
    with mesh:
        fn = jep_eps(_jax_unet(R.UNET8_LAB).apply, mesh,
                     jshard_leading(padded, mesh, "expert"), w, labs)
        jref = np.asarray(jax.jit(fn)(jshard(jnp.asarray(c["x"]), mesh),
                                      jnp.float32(0.5)))
    for out in res:
        np.testing.assert_array_equal(out["padded"]["w"], [1, 2, 3, 0])
        np.testing.assert_allclose(out["padded"]["eps"], ref, **TOL)
        np.testing.assert_allclose(out["padded"]["eps"], jref, **TOL)


def test_ep_eps_refuses_a_stack_it_cannot_split(world2):
    """K = 3 on an expert axis of 2 without padding, and the whole stack
    where the rank's shard belongs, raise instead of blending the wrong
    experts (shard_map refuses both in JAX)."""
    _, res, _ = world2
    for out in res:
        refused = out["padded"]["refused"]
        assert "pad_expert_stack" in refused["unpadded"]
        assert "this rank's shard" in refused["whole stack"]


def test_served_compositions_match_entry_points(world2):
    """sample_expert_parallel serves entry.sample's composition (three
    folded DiTs, K = 3 padded over expert 2) and entry.sample_shapes'
    (two labelled UNets, the batch over data 2): float32, 3 DDIM steps,
    against the single-process entry points (2e-5)."""
    inp, res, _ = world2
    s = inp["serve"]
    ref_dit = entry.sample(
        [convert.from_flax(t) for t in s["dit_trees"]], s["dit_x"],
        n_steps=3, device="cpu", dtype=torch.float32,
        model=R.SERVE_DIT).numpy()
    ref_unet = entry.sample_shapes(
        [convert.from_flax(t) for t in s["unet_trees"]], s["unet_x"],
        s["unet_labels"], n_steps=3, device="cpu", dtype=torch.float32,
        model=R.SERVE_UNET).numpy()
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["serve"]["dit"], ref_dit, **TOL)
        np.testing.assert_allclose(out["serve"]["unet"],
                                   ref_unet[2 * r:2 * r + 2], **TOL)


# ------------------------------------------------------- no world needed
def test_stack_unstack_pad_match_jax():
    """stack_params / unstack_params / pad_expert_stack against the JAX
    package's, bit for bit, labels included; padding is a no-op when the
    axis divides K."""
    trees = [_flax(R.UNET8_LAB, i) for i in range(3)]
    labels = np.arange(12, dtype=np.int32).reshape(3, 4)
    w = np.array([1.0, 2.0, 3.0], np.float32)
    jst = jexperts.stack_params([_jtree(t) for t in trees])
    st = experts.stack_params([convert.from_flax(t) for t in trees])
    for got, ref in zip(R.leaves(st), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    for one, ref in zip(experts.unstack_params(st, 3), trees):
        for got, r in zip(R.leaves(one), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(got, r)
    for multiple in (1, 2, 3, 4):
        jp, jw, jl = jexperts.pad_expert_stack(jst, jnp.asarray(w), multiple,
                                               (jnp.asarray(labels),))
        p, pw, pl = experts.pad_expert_stack(st, torch.from_numpy(w),
                                             multiple,
                                             (torch.from_numpy(labels),))
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(pl[0].numpy(), np.asarray(jl[0]))
        for got, ref in zip(R.leaves(p), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(got, np.asarray(ref))
        if 3 % multiple == 0:
            assert p is st and pw.shape == (3,)


@pytest.mark.parametrize("size", [2, 3, 4])
def test_tp_layout_matches_jax_rule(size):
    """The port's layout (output channels: dim 0 of an OIHW convolution
    weight, else the trailing dim) shards exactly the leaves that JAX's
    ``_spec_for`` shards in the flax tree, at every axis size."""
    tree = _flax(R.UNET16_XATTN, 0)
    port = tp_layout(R.unet_tree(tree), size)
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    for path, leaf in zip(paths, jax.tree_util.tree_leaves(tree)):
        spec = _spec_for(jnp.asarray(leaf), "model", size)
        port_path = (path[:-1] + ("weight",) if leaf.ndim == 4 else path)
        assert (port[port_path] is not None) == (len(spec) > 0), path


def test_backend_checks(monkeypatch):
    """NCCL needs CUDA tensors and one card a rank: a larger world raises
    (it never falls back to another backend); gloo takes any world."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        pmesh._check_backend("nccl", 1, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        pmesh._check_backend("nccl", 2, "cuda")
    pmesh._check_backend("gloo", 2, "cuda")
    assert pmesh.default_backend("cpu") == "gloo"
    assert pmesh.default_backend("cuda") == "nccl"


def test_failing_rank_fails_the_world():
    """A rank that raises ends the world: run_ranks kills the rank left
    waiting in its collective and raises."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        pmesh.run_ranks(R.fails_on_rank_1, 2, device="cpu", timeout=120)


def test_dryrun_multichip_world_2():
    """The dry run at world 2 on the CPU: EP train step and EP DDIM (expert
    2), EP DDIM through the folded DiT, a DP x TP step (model 2), PP over
    2 DiT-block stages against the blocks in order, ring attention (seq
    2) against full attention; every rank reports the same run."""
    out = dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    for o in out:
        assert o["mesh"] == {"expert": 2, "data": 1}
        assert o["tp_mesh"] == {"data": 1, "model": 2}
        assert o["pp_stages"] == 2 and o["ring_seq"] == 2
        assert o["sampled"] == o["ep_folded_dit"] == (2, 16, 16, 1)
        assert np.isfinite(o["tp_loss"])
    assert out[0]["tp_loss"] == out[1]["tp_loss"]
