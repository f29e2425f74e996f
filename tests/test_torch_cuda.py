"""The port's CUDA kernels on the card: each against its plain version, the
launch counts, and the serving path driving them. Needs an NVIDIA card and
nvcc; skips without a card. Imports no JAX, so it runs where only the port
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from composable_diffusion_models_tpu_torch import convert, entry
from composable_diffusion_models_tpu_torch.ops import kernels

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
