"""Port parity: the weight bridge and the folded DiT against the JAX
package's ``make_folded_apply`` and ``DiT.apply``, on the same numpy weights
and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from composable_diffusion_models_tpu.models import DiT as JaxDiT
from composable_diffusion_models_tpu.models import (
    make_folded_apply as jax_folded)
from composable_diffusion_models_tpu_torch import convert
from composable_diffusion_models_tpu_torch.models import DiT, make_folded_apply

torch.set_num_threads(1)


def _pair(qkv_fused=True, dtype=None, **kw):
    """The same configuration as a JAX module and a port config."""
    cfg = dict(patch=7, dim=64, depth=2, n_heads=4, in_channels=1,
               qkv_fused=qkv_fused, **kw)
    jdt = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    return JaxDiT(**cfg, dtype=jdt), DiT(**cfg, dtype=dtype)


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch_tree(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: a.to(dtype),
                                  convert.from_flax(tree))


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


# ------------------------------------------------------------------ convert
@pytest.mark.parametrize("qkv_fused", [True, False])
def test_from_flax_round_trip(qkv_fused):
    jm, _ = _pair(qkv_fused, num_classes=(3,), null_token=True)
    x = jnp.zeros((1, 28, 28, 1))
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x, jnp.ones((1,)),
                            jnp.zeros((1,), jnp.int32)))
    conv = convert.from_flax(tree)
    assert _shapes(conv) == _shapes(tree)
    for a, b in zip(jax.tree_util.tree_leaves(conv),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    # bf16 leaves (ml_dtypes arrays) convert exactly
    bf = jax.tree_util.tree_map(lambda a: np.asarray(
        jnp.asarray(a, jnp.bfloat16)), tree)
    conv_bf = convert.from_flax(bf)
    leaf = conv_bf["params"]["patchify"]["kernel"]
    assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        leaf.float().numpy(), bf["params"]["patchify"]["kernel"].astype(
            np.float32))


@pytest.mark.parametrize("kw", [
    dict(patch=14, dim=256, depth=4, n_heads=8, qkv_fused=True),  # flagship
    dict(patch=7, dim=64, depth=2, n_heads=4, qkv_fused=False,
         num_classes=(3, 4), null_token=True)])
def test_init_params_matches_flax_tree(kw):
    jm = JaxDiT(in_channels=1, **kw)
    labels = [jnp.zeros((1,), jnp.int32)] * len(kw.get("num_classes", ()))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 28, 28, 1)), jnp.ones((1,)), *labels)
    got = convert.init_params(DiT(in_channels=1, **kw), seed=0)
    assert _shapes(got) == _shapes(ref)
    for a in jax.tree_util.tree_leaves(got):
        assert a.dtype == np.float32 and float(np.std(a)) > 0.0


def test_folded_adaln_zero_at_flax_init():
    """The flax init (zero adaLN and head) through the bridge gives exactly
    zero, as in the JAX package."""
    jm, cfg = _pair()
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 1)).astype(
        np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                            jnp.ones((1,))))
    out = make_folded_apply(cfg)(convert.from_flax(params),
                                 torch.from_numpy(x), torch.tensor([0.5]))
    assert float(out.abs().max()) == 0.0


# ------------------------------------------------------------ folded apply
@pytest.mark.parametrize("qkv_fused", [True, False])
@pytest.mark.parametrize("fused_block", [True, False])
def test_folded_fp32_parity(qkv_fused, fused_block):
    """fp32: port == JAX folded path == JAX DiT.apply to < 1e-4 (the
    TestFoldedDiT bar), on both attention layouts and both block paths."""
    jm, cfg = _pair(qkv_fused)
    tree = convert.init_params(cfg, seed=1)
    x = np.random.default_rng(1).standard_normal((3, 28, 28, 1)).astype(
        np.float32)
    t = np.full((1,), 0.37, np.float32)
    got = make_folded_apply(cfg, fused_block)(
        _torch_tree(tree), torch.from_numpy(x), torch.from_numpy(t)).numpy()
    ref_folded = np.asarray(jax_folded(jm)(_jax_tree(tree), jnp.asarray(x),
                                           jnp.asarray(t)))
    ref_module = np.asarray(jm.apply(_jax_tree(tree), jnp.asarray(x),
                                     jnp.asarray(t)))
    assert got.shape == x.shape
    assert float(np.abs(ref_folded).max()) > 0.1  # not the zero function
    assert float(np.abs(got - ref_folded).max()) < 1e-4
    assert float(np.abs(got - ref_module).max()) < 1e-4


@pytest.mark.parametrize("fused_block", [True, False])
def test_folded_bf16_parity(fused_block):
    """bf16 compute: rounding sites differ from the unfolded module, so the
    bar is relative < 0.05 of the output scale (TestFoldedDiT's)."""
    jm, cfg = _pair(dtype=torch.bfloat16)
    tree = convert.init_params(cfg, seed=2)
    x = np.random.default_rng(2).standard_normal((3, 28, 28, 1)).astype(
        np.float32)
    t = np.full((1,), 0.37, np.float32)
    got = make_folded_apply(cfg, fused_block)(
        _torch_tree(tree, torch.bfloat16), torch.from_numpy(x),
        torch.from_numpy(t)).float().numpy()
    jt = _jax_tree(tree, jnp.bfloat16)
    for ref in (jax_folded(jm)(jt, jnp.asarray(x), jnp.asarray(t)),
                jm.apply(jt, jnp.asarray(x), jnp.asarray(t))):
        ref = np.asarray(ref, np.float32)
        rel = float(np.abs(got - ref).max()) / (float(np.abs(ref).max())
                                                + 1e-6)
        assert rel < 0.05, rel


def test_folded_conditional_labels_and_batch1():
    """Batch-constant labels fold (fp32 parity < 1e-4); per-sample labels
    and per-sample t are rejected."""
    jm, cfg = _pair(num_classes=(3, 4))
    tree = convert.init_params(cfg, seed=3)
    x = np.random.default_rng(3).standard_normal((2, 28, 28, 1)).astype(
        np.float32)
    lab = (np.zeros((1,), np.int32), np.ones((1,), np.int32))
    ref = np.asarray(jm.apply(_jax_tree(tree), jnp.asarray(x),
                              jnp.full((1,), 0.5), *map(jnp.asarray, lab)))
    apply = make_folded_apply(cfg)
    params = _torch_tree(tree)
    got = apply(params, torch.from_numpy(x), torch.tensor(0.5),
                *map(torch.from_numpy, lab)).numpy()
    assert float(np.abs(got - ref).max()) < 1e-4
    with pytest.raises(ValueError, match="batch-constant"):
        apply(params, torch.from_numpy(x), torch.tensor(0.5),
              torch.zeros(2, dtype=torch.int32), torch.from_numpy(lab[1]))
    with pytest.raises(ValueError, match="batch-constant"):
        apply(params, torch.from_numpy(x), torch.full((2,), 0.5),
              *map(torch.from_numpy, lab))
    with pytest.raises(ValueError, match="label slots"):
        apply(params, torch.from_numpy(x), torch.tensor(0.5))
