"""Port parity: the two kernels' plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU) and their XLA fallbacks, on the
same numpy inputs; and the wrappers' CPU dispatch and input checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composable_diffusion_models_tpu.ops import pallas_kernels as pk
from composable_diffusion_models_tpu_torch.ops import kernels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode():
    # CPU backend: run the Pallas kernels in the interpreter
    with pltpu.force_tpu_interpret_mode():
        yield


def _block_args(rng, b, t, d, scale=0.1):
    shapes = [(b, t, d), (d, 3 * d), (3 * d,), (d, d), (d,), (d, 4 * d),
              (4 * d,), (4 * d, d), (d,)]
    return [rng.standard_normal(s).astype(np.float32) * (1.0 if i == 0
                                                         else scale)
            for i, s in enumerate(shapes)]


# ------------------------------------------------------ short_seq_attention
@pytest.mark.parametrize("b,t,d,h", [(8, 16, 64, 2), (6, 16, 32, 4),
                                     (4, 49, 32, 2), (3, 8, 16, 1),
                                     (5, 4, 256, 8)])  # serving shape
@pytest.mark.parametrize("use_pallas", [True, False])
def test_short_seq_attention_ref_matches_jax(b, t, d, h, use_pallas):
    qkv = np.random.default_rng(b * t + d).standard_normal(
        (b, t, 3 * d)).astype(np.float32)
    ref = np.asarray(pk.short_seq_attention(jnp.asarray(qkv), h,
                                            use_pallas=use_pallas))
    got = kernels.short_seq_attention_ref(torch.from_numpy(qkv), h).numpy()
    # fp32 end to end; only the summation order differs
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # on a CPU tensor the wrapper is the plain version
    wrapped = kernels.short_seq_attention(torch.from_numpy(qkv), h).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_short_seq_attention_no_cross_image_leakage():
    """Image i's output depends on image i's tokens only."""
    b, t, d, h = 8, 16, 32, 2
    qkv = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, t, 3 * d)).astype(np.float32))
    out = kernels.short_seq_attention(qkv, h)
    qkv2 = qkv.clone()
    qkv2[0] *= -3.0
    out2 = kernels.short_seq_attention(qkv2, h)
    torch.testing.assert_close(out2[1:], out[1:], rtol=0, atol=0)
    assert float((out2[0] - out[0]).abs().max()) > 1e-3


def test_short_seq_attention_bf16_matches_pallas():
    """bf16: fp32 scores and softmax, probabilities rounded to bf16 before
    the value product, one output rounding -- the Pallas kernel's sites.
    Bound: a couple of bf16 ulps of the O(1) outputs."""
    qkv = np.random.default_rng(2).standard_normal(
        (6, 4, 3 * 256)).astype(np.float32)
    ref = np.asarray(pk.short_seq_attention(
        jnp.asarray(qkv, jnp.bfloat16), 8, use_pallas=True).astype(
            jnp.float32))
    got = kernels.short_seq_attention_ref(
        torch.from_numpy(qkv).bfloat16(), 8).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("bad", ["hd", "rank", "dtype", "contig"])
def test_short_seq_attention_rejects(bad):
    qkv = torch.zeros(2, 4, 3 * 64)
    h = 4
    if bad == "hd":  # head width 24 / 8 = 3
        qkv = torch.zeros(2, 4, 3 * 24)
        h = 8
    elif bad == "rank":
        qkv = torch.zeros(8, 3 * 64)
    elif bad == "dtype":
        qkv = qkv.half()
    else:
        qkv = torch.zeros(2, 3 * 64, 4).transpose(1, 2)
    with pytest.raises(ValueError):
        kernels.short_seq_attention(qkv, h)


# ---------------------------------------------------------- fused_dit_block
@pytest.mark.parametrize("b,t,d,h", [(8, 16, 64, 2), (4, 49, 32, 2),
                                     (4, 64, 32, 2),
                                     (3, 4, 256, 8)])  # serving shape
@pytest.mark.parametrize("use_pallas", [True, False])
def test_fused_dit_block_ref_matches_jax(b, t, d, h, use_pallas):
    args = _block_args(np.random.default_rng(b + t + d), b, t, d)
    ref = np.asarray(pk.fused_dit_block(*map(jnp.asarray, args), h,
                                        use_pallas=use_pallas))
    got = kernels.fused_dit_block_ref(*map(torch.from_numpy, args),
                                      h).numpy()
    # fp32 end to end (the JAX tests' own bar for kernel vs fallback)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    wrapped = kernels.fused_dit_block(*map(torch.from_numpy, args),
                                      h).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_fused_dit_block_bf16_matches_pallas():
    """bf16 at the serving shape against the Pallas kernel's bf16 rounding
    sites. Both round every GEMM output, GELU and residual to bf16, so they
    differ by accumulation order flipping a bf16 rounding now and then
    (measured: 1 ulp of the ~6-magnitude stream). Bar: 4 bf16 ulps
    (2^-8 relative each) of the output scale."""
    args = _block_args(np.random.default_rng(3), 4, 4, 256, scale=0.06)
    ref = np.asarray(pk.fused_dit_block(
        *(jnp.asarray(a, jnp.bfloat16) for a in args), 8,
        use_pallas=True).astype(jnp.float32))
    got = kernels.fused_dit_block_ref(
        *(torch.from_numpy(a).bfloat16() for a in args), 8).float().numpy()
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 4 * 2.0 ** -8 * scale


@pytest.mark.parametrize("dtype,t,d,rows", [
    (torch.bfloat16, 4, 256, 64), (torch.bfloat16, 49, 256, 64),
    (torch.float32, 4, 256, 32), (torch.float32, 16, 64, 64),
    (torch.float32, 49, 64, 64)])
def test_block_rows_fit_shared_memory(dtype, t, d, rows):
    assert kernels.block_rows(dtype, t, d) == rows
    assert kernels.block_smem_bytes(dtype, rows, d) <= 232448


def test_fused_dit_block_rejects():
    args = [torch.from_numpy(a) for a in
            _block_args(np.random.default_rng(4), 2, 4, 64)]
    with pytest.raises(ValueError, match="head width"):
        kernels.fused_dit_block(*args, 8)  # head width 8
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_dit_block(torch.zeros(1, 49, 256), *(
            torch.zeros(s) for s in [(256, 768), (768,), (256, 256), (256,),
                                     (256, 1024), (1024,), (1024, 256),
                                     (256,)]), 8)
    bad = list(args)
    bad[3] = bad[3].bfloat16()
    with pytest.raises(ValueError, match="dtype"):
        kernels.fused_dit_block(*bad, 2)
    bad = list(args)
    bad[1] = bad[1][:, :96]
    with pytest.raises(ValueError, match="shape"):
        kernels.fused_dit_block(*bad, 2)
