"""The port's CUDA kernels on the card: each against its plain version, the
launch counts, and the serving path driving them. Needs an NVIDIA card and
nvcc; skips without a card. Imports no JAX, so it runs where only the port
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from composable_diffusion_models_tpu_torch import convert, entry
from composable_diffusion_models_tpu_torch.ops import attention, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    # the plain versions are compared in true float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _block_args(b, t, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [(b, t, d), (d, 3 * d), (3 * d,), (d, d), (d,), (d, 4 * d),
              (4 * d,), (4 * d, d), (d,)]
    return [(torch.randn(s, generator=g) * (1.0 if i == 0 else 0.1)).to(
        "cuda", dtype) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,h", [(37, 16, 64, 2), (9, 4, 256, 8),
                                     (3, 49, 64, 4), (2, 64, 32, 2)])
def test_kernels_match_plain_versions(dtype, b, t, d, h):
    """fp32: summation order only (2e-4 / 1e-5 of scale, the JAX tests'
    bars). bf16: same rounding sites, an accumulation-order flip of one
    intermediate rounding allowed: 4 bf16 ulps of scale."""
    args = _block_args(b, t, d, dtype, seed=b + t)
    n0 = kernels.fused_dit_block.launches
    got = kernels.fused_dit_block(*args, h)
    assert kernels.fused_dit_block.launches == n0 + 1
    ref = kernels.fused_dit_block_ref(*args, h)
    qkv = torch.randn(b, t, 3 * d, device="cuda").to(dtype)
    got_a = kernels.short_seq_attention(qkv, h)
    ref_a = kernels.short_seq_attention_ref(qkv, h)
    torch.cuda.synchronize()
    bf16_tol = 4 * 2.0 ** -8
    for g, r, fp32_tol in ((got, ref, 2e-4), (got_a, ref_a, 1e-5)):
        scale = max(1.0, float(r.float().abs().max()))
        tol = (fp32_tol if dtype == torch.float32 else bf16_tol) * scale
        assert float((g.float() - r.float()).abs().max()) <= tol


def test_serving_path_launches_the_block_kernel():
    trees = [convert.from_flax(convert.init_params(entry.FLAGSHIP, seed=i))
             for i in range(entry.N_EXPERTS)]
    x = torch.randn(8, 28, 28, 1, device="cuda")
    n0 = kernels.fused_dit_block.launches
    out = entry.sample(trees, x, n_steps=2)
    torch.cuda.synchronize()
    assert kernels.fused_dit_block.launches - n0 == 4 * entry.N_EXPERTS * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    n0 = kernels.short_seq_attention.launches
    entry.sample(trees, x, n_steps=2, fused_block=False)
    torch.cuda.synchronize()
    assert kernels.short_seq_attention.launches - n0 == 4 * entry.N_EXPERTS * 2


def _tol(dtype, ref, fp32_tol):
    scale = max(1.0, float(ref.float().abs().max()))
    return (fp32_tol if dtype == torch.float32 else 4 * 2.0 ** -8) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((16, 64, 64, 64), 8), ((16, 16, 16, 256), 8), ((6, 28, 28, 64), 8),
    ((3, 7, 7, 24), 4), ((2, 5, 3, 8), 2), ((1, 9, 9, 1024), 8)])
def test_groupnorm_silu_matches_plain_version(dtype, shape, groups):
    """fp32: summation order of the statistics only (1e-5 of scale);
    bf16: one rounding at the store, within the shared 4-ulp bar."""
    g = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to("cuda", dtype)
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    n0 = kernels.groupnorm_silu.launches
    got = kernels.groupnorm_silu(x, scale, bias, groups)
    torch.cuda.synchronize()
    assert kernels.groupnorm_silu.launches == n0 + 1
    ref = kernels.groupnorm_silu_ref(x, scale, bias, groups)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(
        dtype, ref, 1e-5)


def test_groupnorm_silu_rejects_on_the_card():
    """A CUDA tensor outside the kernel's limits raises; it never takes
    the plain version."""
    scale, bias = torch.ones(16).cuda(), torch.zeros(16).cuda()
    nchw_view = torch.zeros(2, 16, 4, 4, device="cuda").permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.groupnorm_silu(nchw_view, scale, bias, 8)
    with pytest.raises(ValueError, match="multiple"):
        kernels.groupnorm_silu(torch.zeros(2, 4, 4, 6, device="cuda"),
                               scale[:6], bias[:6], 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,nq,nk,d", [
    (6, 4, 784, 2, 16), (6, 4, 49, 2, 64), (2, 2, 128, 128, 64),
    (1, 2, 128, 200, 32), (1, 1, 128, 384, 32), (3, 2, 77, 33, 128),
    (1, 1, 4096, 4096, 64)])
def test_flash_attention_matches_plain_version(dtype, b, h, nq, nk, d):
    """Transposed (B, N, H, D) views, as the UNet hands them over, and
    their contiguous copies. fp32: summation order only (1e-5 of scale)."""
    g = torch.Generator().manual_seed(nq + nk + d)
    q, k, v = (torch.randn(b, n, h, d, generator=g).to("cuda", dtype)
               .transpose(1, 2) for n in (nq, nk, nk))
    n0 = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v)
    got_c = attention.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == n0 + 2
    assert got.stride() == q.stride()  # transposes back without a copy
    ref = attention.flash_attention_ref(q, k, v)
    for out in (got, got_c):
        assert float((out.float() - ref.float()).abs().max()) <= _tol(
            dtype, ref, 1e-5)


def test_flash_attention_rejects_on_the_card():
    q = torch.zeros(1, 2, 8, 24, device="cuda")
    with pytest.raises(ValueError, match="D=24"):
        attention.flash_attention(q, q, q)
    strided = torch.zeros(1, 2, 8, 32, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="stride 1"):
        attention.flash_attention(strided, strided, strided)


def test_unet_paths_launch_their_kernels():
    """Full width, small batch, 2 steps: 8 groupnorm_silu launches per
    UNet forward, 5 flash_attention launches per cross-attention forward."""
    trees = [convert.from_flax(convert.init_params(entry.SHAPES_UNET, seed=i))
             for i in range(entry.N_SHAPES_EXPERTS)]
    x = torch.randn(4, 64, 64, 3, device="cuda")
    n0 = kernels.groupnorm_silu.launches
    out = entry.sample_shapes(trees, x, torch.zeros(2, 4, dtype=torch.long),
                              n_steps=2)
    torch.cuda.synchronize()
    assert kernels.groupnorm_silu.launches - n0 == 8 * 2 * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    tree = convert.from_flax(convert.init_params(entry.CFG_UNET, seed=2))
    x = torch.randn(4, 28, 28, 3, device="cuda")
    n0, f0 = kernels.groupnorm_silu.launches, attention.flash_attention.launches
    out = entry.sample_cfg(tree, x, 3, 1, n_steps=2)
    ein = entry.sample_cfg(tree, x, 3, 1, n_steps=2, flash_attn=False)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches - f0 == 5 * 2
    assert kernels.groupnorm_silu.launches - n0 == 8 * 2 * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    # two steps from t = 1 leave values of ~1/alpha(1) magnitude; both
    # branches are float32, so they differ by summation order only
    assert float((out - ein).abs().max()) <= 1e-4 * float(ein.abs().max())
