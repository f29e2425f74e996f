"""The port's CUDA kernels on the card: each against its plain version, the
launch counts, and the serving path driving them. Needs an NVIDIA card and
nvcc; skips without a card. Imports no JAX, so it runs where only the port
is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

from unittest import mock

import pytest
import torch

from composable_diffusion_models_tpu_torch import compose, convert, entry
from composable_diffusion_models_tpu_torch.ops import attention, kernels, pca

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
                                     (3, 49, 64, 4), (2, 64, 32, 2),
                                     (2048, 4, 256, 8), (130, 8, 224, 7),
                                     (7, 3, 96, 3), (1, 1, 32, 1)])
def test_kernels_match_plain_versions(dtype, b, t, d, h):
    """fp32: summation order only (2e-4 / 1e-5 of scale, the JAX tests'
    bars). bf16: same rounding sites, an accumulation-order flip of one
    intermediate rounding allowed: 4 bf16 ulps of scale. The shapes cover
    the serving shape, tiles with rows past the last image, D below one
    64-column panel, N chunks narrower than 128 and every k-tile count of
    the bf16 kernel's register-resident LayerNorm (D = 32 .. 256)."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((16, 64, 64, 64), 8), ((40, 32, 32, 128), 8), ((6, 28, 28, 64), 8),
    ((3, 7, 7, 24), 4), ((2, 5, 3, 8), 2), ((1, 9, 9, 1024), 8)])
def test_groupnorm_silu_at_every_split_count(dtype, shape, groups):
    """The wrapper's own row splits and forced ones (1, 2, 32 blocks a
    sample): the same bars, and the same bits run to run (no atomics:
    nothing depends on the order of the blocks)."""
    g = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to("cuda", dtype)
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    ref = kernels.groupnorm_silu_ref(x, scale, bias, groups)
    for splits in (None, 1, 2, 32):
        pick = kernels.gn_splits if splits is None else (
            lambda *a, n=splits: n)
        with mock.patch.object(kernels, "gn_splits", pick):
            got = kernels.groupnorm_silu(x, scale, bias, groups)
            again = kernels.groupnorm_silu(x, scale, bias, groups)
        torch.cuda.synchronize()
        assert float((got.float() - ref.float()).abs().max()) <= _tol(
            dtype, ref, 1e-5), splits
        assert torch.equal(got, again), splits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bhw,chans,groups", [
    ((8, 32, 32), (256, 128), 8),   # path A's first up block: groups of 48
    ((8, 64, 64), (128, 64), 8),    # its second: groups of 24
    ((6, 14, 14), (256, 128), 8), ((6, 28, 28), (128, 64), 8),  # path B's
    ((3, 5, 7), (16, 8), 4),        # groups of 6: group 2 straddles
    ((2, 3, 3), (8, 24), 2),        # group 0 covers part 0 and half of 1
    ((2, 9, 9), (40,), 5),          # one part only
    ((4, 8, 8), (8, 8), 1)])        # one group over both parts
def test_groupnorm_silu_split_matches_plain_version(dtype, bhw, chans,
                                                    groups):
    """The two-part kernel against its plain version and against the plain
    single-tensor version on the concatenation, twice for the same bits;
    one launch counted per call, none for ``groupnorm_silu``."""
    g = torch.Generator().manual_seed(sum(bhw) + sum(chans))
    c = sum(chans)
    parts = [(torch.randn(*bhw, cc, generator=g) * 2 + 0.5).to("cuda", dtype)
             for cc in chans]
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    refs = kernels.groupnorm_silu_split_ref(parts, scale, bias, groups)
    whole = kernels.groupnorm_silu_ref(torch.cat(parts, -1), scale, bias,
                                       groups)
    tol = _tol(dtype, whole, 1e-5)
    n0, s0 = (kernels.groupnorm_silu_split.launches,
              kernels.groupnorm_silu.launches)
    got = kernels.groupnorm_silu_split(parts, scale, bias, groups)
    again = kernels.groupnorm_silu_split(parts, scale, bias, groups)
    torch.cuda.synchronize()
    for o, o2, r, p in zip(got, again, refs, parts):
        assert o.dtype == dtype and o.shape == p.shape
        assert float((o.float() - r.float()).abs().max()) <= tol
        assert torch.equal(o, o2)
    assert float((torch.cat(got, -1).float() - whole.float()).abs()
                 .max()) <= tol
    assert kernels.groupnorm_silu_split.launches == n0 + 2
    assert kernels.groupnorm_silu.launches == s0


def test_groupnorm_silu_split_rejects_on_the_card():
    """CUDA parts outside the kernel's limits raise; they never take the
    plain version."""
    scale, bias = torch.ones(24).cuda(), torch.zeros(24).cuda()
    a, b = (torch.zeros(2, 4, 4, c, device="cuda") for c in (16, 8))
    with pytest.raises(ValueError, match="one or two"):
        kernels.groupnorm_silu_split([a, b[..., :4], b[..., 4:]], scale, bias,
                                     4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.groupnorm_silu_split(
            [a, torch.zeros(2, 4, 4, 16, device="cuda")[..., :8]], scale,
            bias, 4)
    with pytest.raises(ValueError, match="multiple"):
        kernels.groupnorm_silu_split(
            [a, torch.zeros(2, 4, 4, 6, device="cuda")], scale[:22],
            bias[:22], 2)
    with pytest.raises(ValueError, match="expected"):
        kernels.groupnorm_silu_split([a, b.bfloat16()], scale, bias, 4)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24, 48, 80, 100])
def test_flash_attention_pads_the_head_width(dtype, d):
    """A head width other than 16, 32, 64 or 128 runs padded with zero
    columns to the next of them, the scale from the true D, in one launch;
    the result has q's shape and layout. Against the plain version at the
    true D: 1e-5 of scale in float32, 4 bf16 ulps in bf16."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(3, n, 4, d, generator=g).to("cuda", dtype)
               .transpose(1, 2) for n in (100, 37, 37))
    n0 = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == n0 + 1
    assert got.shape == q.shape and got.stride() == q.stride()
    ref = attention.flash_attention_ref(q, k, v)
    assert float((got.float() - ref.float()).abs().max()) <= _tol(
        dtype, ref, 1e-5)


def test_flash_attention_rejects_on_the_card():
    q = torch.zeros(1, 2, 8, 160, device="cuda")
    with pytest.raises(ValueError, match="D=160"):
        attention.flash_attention(q, q, q)
    strided = torch.zeros(1, 2, 8, 32, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="stride 1"):
        attention.flash_attention(strided, strided, strided)


def test_unet_paths_launch_their_kernels():
    """Full width, small batch, 2 steps: 8 groupnorm_silu and 2
    groupnorm_silu_split launches per UNet forward, 5 flash_attention
    launches per cross-attention forward; ``fused_gn=False`` launches no
    GroupNorm kernel."""
    trees = [convert.from_flax(convert.init_params(entry.SHAPES_UNET, seed=i))
             for i in range(entry.N_SHAPES_EXPERTS)]
    x = torch.randn(4, 64, 64, 3, device="cuda")
    labels = torch.zeros(2, 4, dtype=torch.long)
    n0, s0 = (kernels.groupnorm_silu.launches,
              kernels.groupnorm_silu_split.launches)
    out = entry.sample_shapes(trees, x, labels, n_steps=2)
    torch.cuda.synchronize()
    assert kernels.groupnorm_silu.launches - n0 == 8 * 2 * 2
    assert kernels.groupnorm_silu_split.launches - s0 == 2 * 2 * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    n0, s0 = (kernels.groupnorm_silu.launches,
              kernels.groupnorm_silu_split.launches)
    off = entry.sample_shapes(trees, x, labels, n_steps=2, fused_gn=False)
    torch.cuda.synchronize()
    assert kernels.groupnorm_silu.launches == n0
    assert kernels.groupnorm_silu_split.launches == s0
    # bf16 both ways, and the kernels round where the PyTorch ops round; two
    # steps from t = 1 leave values of ~1/alpha(1) magnitude, so the two are
    # held together relative to that scale
    assert bool(torch.isfinite(off).all())
    assert float((out - off).abs().mean()) <= 0.05 * float(off.abs().mean())
    tree = convert.from_flax(convert.init_params(entry.CFG_UNET, seed=2))
    x = torch.randn(4, 28, 28, 3, device="cuda")
    n0, f0 = kernels.groupnorm_silu.launches, attention.flash_attention.launches
    s0 = kernels.groupnorm_silu_split.launches
    out = entry.sample_cfg(tree, x, 3, 1, n_steps=2)
    ein = entry.sample_cfg(tree, x, 3, 1, n_steps=2, flash_attn=False)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches - f0 == 5 * 2
    assert kernels.groupnorm_silu.launches - n0 == 8 * 2 * 2
    assert kernels.groupnorm_silu_split.launches - s0 == 2 * 2 * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    # two steps from t = 1 leave values of ~1/alpha(1) magnitude; both
    # branches are float32, so they differ by summation order only
    assert float((out - ein).abs().max()) <= 1e-4 * float(ein.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 512, 2), (3, 64, 28, 28, 1), (2, 8, 64, 64, 3), (3, 7, 5), (2, 1, 1),
    (1, 9, 33), (5, 1000, 3)])
def test_blend_eps_matches_plain_version(dtype, shape):
    """The kernel keeps the plain version's order and rounding sites:
    1e-6 of scale in float32 (a fused multiply-add on either side), the
    shared 4-ulp bar in bf16; 1e-5 from ``compose.weighted`` in float32."""
    g = torch.Generator().manual_seed(sum(shape))
    eps = torch.randn(*shape, generator=g).to("cuda", dtype)
    w = (torch.rand(shape[0], generator=g) + 0.5).cuda()
    n0 = kernels.blend_eps.launches
    got = kernels.blend_eps(eps, w)
    torch.cuda.synchronize()
    assert kernels.blend_eps.launches == n0 + 1
    ref = kernels.blend_eps_ref(eps, w)
    assert got.dtype == dtype and got.shape == eps.shape[1:]
    assert float((got.float() - ref.float()).abs().max()) <= _tol(
        dtype, ref, 1e-6)
    if dtype == torch.float32:
        assert float((got - compose.weighted(eps, w)).abs().max()) <= _tol(
            dtype, ref, 1e-5)


def test_blend_eps_rejects_on_the_card():
    eps = torch.zeros(2, 4, 6, device="cuda")
    with pytest.raises(ValueError, match="compose.weighted"):
        kernels.blend_eps(eps, torch.ones(2, 4, device="cuda"))
    with pytest.raises(ValueError, match="on cpu"):
        kernels.blend_eps(eps, torch.ones(2))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.blend_eps(eps.transpose(1, 2), torch.ones(2, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (10000, 4096, 2), (512, 2, 4096), (64, 2, 784), (2048, 640, 64),
    (300, 200, 1100), (64, 32, 48), (130, 784, 2), (1, 1, 1), (7, 129, 3),
    (33, 5, 65), (5, 0, 3)])
def test_matmul_matches_plain_version(dtype, m, k, n):
    """float32: two sums of K products in different orders,
    2 * 2^-23 sqrt(K) of scale; bf16: one rounding at the store, the
    shared 4-ulp bar. Contiguous operands, and each one as a transposed
    view."""
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=g).to("cuda", dtype)
    b = torch.randn(k, n, generator=g).to("cuda", dtype)
    n0 = kernels.matmul.launches
    got = kernels.matmul(a, b)
    got_t = kernels.matmul(a, b.t().contiguous().t())
    got_at = kernels.matmul(a.t().contiguous().t(), b)
    torch.cuda.synchronize()
    assert kernels.matmul.launches == n0 + 3
    ref = kernels.matmul_ref(a, b)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    tol = _tol(dtype, ref, 2 * 2.0 ** -23 * max(1, k) ** 0.5)
    for out in (got, got_t, got_at):
        assert float((out.float() - ref.float()).abs().max()) <= tol


def _views(t, major):
    """t itself (rows contiguous) or the same values as a transposed view
    of a column-major copy (columns contiguous)."""
    return t if major == "row" else t.t().contiguous().t()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("a_major,b_major", [("row", "row"), ("row", "col"),
                                             ("col", "row"), ("col", "col")])
@pytest.mark.parametrize("m,k,n", [
    (512, 1, 4096), (512, 2, 4096), (333, 8, 1000), (100, 9, 130),
    (100, 16, 130), (129, 64, 257), (200, 72, 136), (136, 1000, 264),
    (1000, 1000, 1000), (64, 128, 64), (2048, 256, 2048)])
def test_matmul_routes_match_plain_version(dtype, a_major, b_major, m, k, n):
    """Every route at its edges: K at and past the small-K limit, bf16 M,
    N and K that are no tile multiples on the tensor cores, each operand
    in either major; the bars of ``test_matmul_matches_plain_version``."""
    g = torch.Generator().manual_seed(m * k + n)
    a = _views(torch.randn(m, k, generator=g).to("cuda", dtype), a_major)
    b = _views(torch.randn(k, n, generator=g).to("cuda", dtype), b_major)
    route = kernels.matmul_route(dtype, m, k, n, a.stride(), b.stride())
    if (dtype == torch.bfloat16 and k >= 64
            and m % 8 == k % 8 == n % 8 == 0):
        assert route == "wgmma"  # rows 16-byte aligned in either major
    got = kernels.matmul(a, b)
    torch.cuda.synchronize()
    ref = kernels.matmul_ref(a, b)
    tol = _tol(dtype, ref, 2 * 2.0 ** -23 * max(1, k) ** 0.5)
    assert float((got.float() - ref.float()).abs().max()) <= tol, route


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,nq,nk,d", [
    (3, 4, 100, 4, 16), (3, 4, 100, 5, 16), (2, 2, 70, 4, 64),
    (2, 3, 130, 3, 32), (1, 128, 9, 2, 16), (1, 129, 9, 2, 16),
    (2, 2, 70, 31, 64), (2, 2, 70, 32, 64), (2, 3, 65, 127, 16),
    (2, 3, 65, 128, 16), (1, 2, 200, 300, 32), (1, 2, 200, 300, 64),
    (1, 2, 200, 300, 128), (1, 1, 1, 1000, 64)])
def test_flash_attention_routes_match_plain_version(dtype, b, h, nq, nk, d):
    """Each route at its edges: Nk at the short route's limit and one past
    it, more heads than its block holds, Nk * D at the tensor cores' limit
    and one short of it, bf16 long contexts on the tensor cores with q
    split (D = 32, 128) and exact (D = 16, 64), Nq no multiple of 64;
    (B, N, H, D) views and contiguous tensors. fp32 1e-5 of scale, bf16 4
    ulps."""
    g = torch.Generator().manual_seed(nq * nk + d)
    q, k, v = (torch.randn(b, n, h, d, generator=g).to("cuda", dtype)
               .transpose(1, 2) for n in (nq, nk, nk))
    ref = attention.flash_attention_ref(q, k, v)
    for args in ((q, k, v), (q.contiguous(), k.contiguous(), v.contiguous())):
        got = attention.flash_attention(*args)
        torch.cuda.synchronize()
        assert float((got.float() - ref.float()).abs().max()) <= _tol(
            dtype, ref, 1e-5)


def test_path_b_launches_and_routes():
    """Path B at its serving width (batch 64: 192 rows of 28 x 28 through
    the CFG sampler), float32, 2 steps: 5 flash_attention launches per
    forward, the two at D = 16 on the short route and the three at D = 32
    and 64 on the tiles route, and 8 + 2 GroupNorm launches, as before."""
    tree = convert.from_flax(convert.init_params(entry.CFG_UNET, seed=2))
    x = torch.randn(64, 28, 28, 3, device="cuda")
    routes = []
    pick = attention.flash_route

    def spy(dtype, h, nk, d, strides):
        routes.append((d, pick(dtype, h, nk, d, strides)))
        return routes[-1][1]

    f0 = attention.flash_attention.launches
    n0 = kernels.groupnorm_silu.launches
    s0 = kernels.groupnorm_silu_split.launches
    with mock.patch.object(attention, "flash_route", spy):
        out = entry.sample_cfg(tree, x, 3, 1, n_steps=2)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches - f0 == 5 * 2
    assert sorted(routes) == [(16, "short")] * 4 + [(32, "tiles")] * 4 + [
        (64, "tiles")] * 2
    assert kernels.groupnorm_silu.launches - n0 == 8 * 2
    assert kernels.groupnorm_silu_split.launches - s0 == 2 * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_latent_path_launches_its_kernels():
    """Full width, small data, 3 steps: one blend_eps launch per step for
    ddim and em, none for avg and ito; one matmul launch per encode and
    per decode."""
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand(256, 16, 16, 1, generator=g).cuda()
    n0 = kernels.matmul.launches
    codec = pca.fit_pca(imgs, 2)
    z_all = codec.encode(imgs)
    assert kernels.matmul.launches == n0 + 1 and z_all.shape == (256, 2)
    trees = [convert.from_flax(convert.init_params(entry.SHAPES_LATENT_MLP,
                                                   seed=i)) for i in range(2)]
    z0 = torch.randn(32, 2, generator=g)
    for op in entry.LATENT_OPS:
        b0, m0 = kernels.blend_eps.launches, kernels.matmul.launches
        z, out = entry.sample_latent(trees, codec, z0, op=op, n_steps=3)
        torch.cuda.synchronize()
        assert kernels.blend_eps.launches - b0 == (
            3 if op in ("ddim", "em") else 0)
        assert kernels.matmul.launches - m0 == 1
        assert z.is_cuda and out.shape == (32, 16, 16, 1)
        assert bool(torch.isfinite(out).all())
    z_k, _ = entry.sample_latent(trees, codec, z0, op="ddim", n_steps=3,
                                 weights=(0.7, 1.9))
    z_p, _ = entry.sample_latent(trees, codec, z0, op="ddim", n_steps=3,
                                 weights=(0.7, 1.9), fused_blend=False)
    # float32 both ways; at most a rounding per blend differs
    assert float((z_k - z_p).abs().max()) <= 1e-4 * float(z_p.abs().max())


# ------------------------------------------- the discrete-DDPM paths (K4)
@pytest.mark.parametrize("shape", [
    (64, 28, 28, 64), (64, 14, 14, 128), (64, 7, 7, 256),   # GUIDED_UNET
    (128, 28, 28, 64), (192, 28, 28, 64),                    # K x B rows
    (4, 64, 64, 64), (4, 32, 32, 128), (4, 16, 16, 256),     # bbox, batch 4
    (64, 64, 64, 64)])                                       # bbox, batch 64
def test_groupnorm_silu_at_the_ddpm_paths_shapes(shape):
    """float32, as those paths compute: summation order of the statistics
    only, 1e-5 of scale."""
    g = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).cuda()
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    got = kernels.groupnorm_silu(x, scale, bias, 8)
    torch.cuda.synchronize()
    ref = kernels.groupnorm_silu_ref(x, scale, bias, 8)
    assert float((got - ref).abs().max()) <= _tol(torch.float32, ref, 1e-5)


@pytest.mark.parametrize("bhw,chans", [
    ((64, 14, 14), (256, 128)), ((64, 28, 28), (128, 64)),
    ((4, 32, 32), (256, 128)), ((4, 64, 64), (128, 64))])
def test_groupnorm_silu_split_at_the_ddpm_paths_shapes(bhw, chans):
    g = torch.Generator().manual_seed(sum(bhw) + sum(chans))
    c = sum(chans)
    parts = [(torch.randn(*bhw, cc, generator=g) * 2 + 0.5).cuda()
             for cc in chans]
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    got = kernels.groupnorm_silu_split(parts, scale, bias, 8)
    torch.cuda.synchronize()
    whole = kernels.groupnorm_silu_ref(torch.cat(parts, -1), scale, bias, 8)
    assert float((torch.cat(got, -1) - whole).abs().max()) <= _tol(
        torch.float32, whole, 1e-5)


def _guided(k=2, b=4):
    trees = entry.load_unets(
        [convert.from_flax(convert.init_params(entry.GUIDED_UNET, seed=i))
         for i in range(k)], dtype=torch.float32)
    x = torch.randn(b, 28, 28, 3, device="cuda")
    labels = torch.tensor([[3, 10], [7, 2], [1, 1]][:k], device="cuda")
    return trees, x, labels


def test_ddpm_samplers_make_no_host_sync():
    """A warm call of SUPERDIFF OR and of the rigorous AND (the K x K
    solve) waits on the card nowhere: under sync debug mode "error" a
    synchronising call would raise. The mode does catch what the repairs
    removed: ``torch.linalg.solve``'s error check and reading a scalar back
    from the card."""
    trees, x, labels = _guided()
    runs = [lambda: entry.sample_superdiff(trees, x, labels, num_timesteps=3),
            lambda: entry.sample_superdiff(trees, x, labels, operation="AND",
                                           rigorous_and=True,
                                           num_timesteps=3)]
    for run in runs:
        run()  # the first call fills the caches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(torch.isfinite(out).all())
    a = torch.eye(2, device="cuda").expand(3, 2, 2)
    for synchronising in (lambda: torch.linalg.solve(a, a[..., :1]),
                          lambda: float(torch.zeros((), device="cuda"))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with pytest.raises(RuntimeError):
                synchronising()
        finally:
            torch.cuda.set_sync_debug_mode(0)


def test_ddpm_paths_launch_groupnorm_silu():
    """Eight single-tensor and two two-part K4 launches per UNet forward:
    K experts x T steps forwards on each DDPM path, none with
    fused_gn=False."""
    trees, x, labels = _guided()
    shapes = entry.load_unets(
        [convert.from_flax(convert.init_params(entry.SHAPES_UNET, seed=i))
         for i in range(3)], dtype=torch.float32)
    x64 = torch.randn(2, 64, 64, 3, device="cuda")
    lab3 = torch.zeros(3, 2, dtype=torch.long, device="cuda")
    gray = entry.load_unets([convert.from_flax(convert.init_params(
        entry.GRAY_UNET, seed=9))], dtype=torch.float32)[0]
    cases = [
        (lambda **kw: entry.sample_superdiff(trees, x, labels,
                                             num_timesteps=3, **kw), 6),
        (lambda **kw: entry.sample_superdiff(
            trees, x, labels, operation="AND", rigorous_and=True,
            num_timesteps=3, **kw), 6),
        (lambda **kw: entry.sample_layout(trees, x, num_timesteps=3, **kw),
         6),
        (lambda **kw: entry.sample_ancestral(shapes, x64, lab3,
                                             num_timesteps=3, **kw), 9),
        (lambda **kw: entry.sample_gray_color(
            gray, shapes[0], x64, lab3[0], lab3[1], op="proj",
            gray_protocol="luma_norm", n_steps=3, **kw), 6)]
    for run, forwards in cases:
        for fused in (True, False):
            n0 = (kernels.groupnorm_silu.launches,
                  kernels.groupnorm_silu_split.launches)
            out = run(fused_gn=fused)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(out).all())
            want = (8 * forwards, 2 * forwards) if fused else (0, 0)
            assert (kernels.groupnorm_silu.launches - n0[0],
                    kernels.groupnorm_silu_split.launches - n0[1]) == want


@pytest.mark.parametrize("b", [1, 5, 64])
def test_block_kernel_at_the_shapes_gate_width(b):
    """K1 at the shapes gate's DiT cells: 64 tokens (dit_p8_d256_l8 at
    64 x 64, one image a block) of width 256, 8 heads, bf16: 4 bf16 ulps
    of the scale."""
    args = _block_args(b, 64, 256, torch.bfloat16, seed=b)
    got = kernels.fused_dit_block(*args, 8)
    ref = kernels.fused_dit_block_ref(*args, 8)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= \
        4 * 2.0 ** -8 * scale


def test_shapes_gate_dit_cell_launches_the_block_kernel():
    """The gate's DiT candidate served as its cells are: two experts,
    batch-constant (2, 1) labels, depth 8 x 2 experts launches a step."""
    _, serve = entry.shapes_gate_model("dit_p8_d256_l8", 64)
    trees = [convert.from_flax(convert.init_params(serve, seed=i))
             for i in range(2)]
    x = torch.randn(4, 64, 64, 3, device="cuda")
    n0 = kernels.fused_dit_block.launches
    out = entry.sample(trees, x, n_steps=2, model=serve,
                       labels=(torch.tensor([[0], [2]]),))
    torch.cuda.synchronize()
    assert kernels.fused_dit_block.launches - n0 == 8 * 2 * 2
    assert out.shape == x.shape and bool(torch.isfinite(out).all())


def test_wrappers_refuse_autodiff_on_the_card():
    """A CUDA input that requires grad under grad mode, or a forward-mode
    dual, raises before any launch; under no_grad the kernel launches."""
    x = torch.randn(2, 8, 8, 16, device="cuda", requires_grad=True)
    s, b = torch.ones(16, device="cuda"), torch.zeros(16, device="cuda")
    n0 = kernels.groupnorm_silu.launches
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.groupnorm_silu(x, s, b, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        torch.func.jvp(lambda v: kernels.groupnorm_silu(v, s, b, 8),
                       (x.detach(),), (torch.ones_like(x),))
    assert kernels.groupnorm_silu.launches == n0
    with torch.no_grad():
        kernels.groupnorm_silu(x, s, b, 8)
    assert kernels.groupnorm_silu.launches == n0 + 1


# ------------------------------------ the config-driven paths (K3, K4)
@pytest.mark.parametrize("shape", [(2, 64, 28, 28, 1), (2, 16, 10)])
def test_blend_eps_at_the_config_paths_shapes(shape):
    """K3 at ``compose_scores``' blend (two ``mnist_image`` experts, batch
    64) and ``compose_latent_vae``'s (two digits, 16 latents of 10),
    float32: 1e-6 of the scale from its plain version."""
    g = torch.Generator().manual_seed(len(shape))
    eps = torch.randn(*shape, generator=g).cuda()
    w = torch.ones(shape[0], device="cuda")
    got = kernels.blend_eps(eps, w)
    ref = kernels.blend_eps_ref(eps, w)
    assert float((got - ref).abs().max()) <= _tol(torch.float32, ref, 1e-6)


def _launches():
    return (kernels.groupnorm_silu.launches,
            kernels.groupnorm_silu_split.launches, kernels.blend_eps.launches)


def _saved_experts(tmp_path, preset, overrides, names):
    from composable_diffusion_models_tpu_torch import builders
    from composable_diffusion_models_tpu_torch.checkpoint import \
        CheckpointManager
    from composable_diffusion_models_tpu_torch.utils.config import get_config
    cfg = get_config(preset, overrides)
    mgr = CheckpointManager(str(tmp_path), cfg.name)
    for i, name in enumerate(names):
        mgr.save(name, {"params": convert.from_flax(convert.init_params(
            builders.build_model(cfg), seed=i)), "step": 0})


def test_config_paths_launch_their_kernels(tmp_path):
    """``sample_image`` (ddim, 3 steps): 8 + 2 K4 launches a forward;
    ``compose_scores`` (em, 3 steps, 2 experts): the same per expert and
    one K3 a step, none with ``fused_blend=False``; ``train_image`` runs
    no kernel."""
    ov = ["--model.base_dim=8", "--sample.n_steps=3",
          "--sample.batch_size=4"]
    _saved_experts(tmp_path, "mnist_image", ov, ["expert_a", "expert_b"])
    n0 = _launches()
    out = entry.sample_image("mnist_image", "expert_a", sampler="ddim",
                             out=str(tmp_path), overrides=ov)
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(n0, _launches())) == (24, 6, 0)
    assert out.is_cuda and out.shape == (4, 28, 28, 1)
    for fused, blends in ((True, 3), (False, 0)):
        n0 = _launches()
        out = entry.compose_scores("mnist_image", ["expert_a", "expert_b"],
                                   out=str(tmp_path), overrides=ov,
                                   fused_blend=fused)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(n0, _launches())) == (48, 12,
                                                                 blends)
        assert bool(torch.isfinite(out).all())
    n0 = _launches()
    _, losses, _ = entry.train_image(
        "colored_mnist_guided", "g", conditional=True, sanity=True,
        out=str(tmp_path), overrides=["--model.base_dim=8",
                                      "--train.steps=3"])
    assert _launches() == n0 and losses.is_cuda and losses.shape == (3,)


def test_compose_latent_vae_launches_blend_eps(tmp_path):
    """``weighted``: one K3 launch a step, 300 a call; ``cfg`` and
    ``fused_blend=False`` none; the images decoded on the card."""
    from composable_diffusion_models_tpu_torch.checkpoint import \
        CheckpointManager
    from composable_diffusion_models_tpu_torch.models import BetaVAE
    CheckpointManager(str(tmp_path), "mnist_image_vae").save("vae", {
        "vae": convert.from_flax(convert.init_params(BetaVAE(), seed=1)),
        "mlp": convert.from_flax(convert.init_params(
            entry.vae_latent_mlp(10), seed=2)), "latent_dim": 10})
    for mode, fused, want in (("weighted", True, 300), ("weighted", False, 0),
                              ("cfg", True, 0)):
        n0 = kernels.blend_eps.launches
        imgs = entry.compose_latent_vae(mode=mode, out=str(tmp_path),
                                        fused_blend=fused)
        torch.cuda.synchronize()
        assert kernels.blend_eps.launches - n0 == want
        assert imgs.is_cuda and imgs.shape == (16, 28, 28, 1)


def test_config_paths_need_the_card_by_default(monkeypatch):
    """``device=None`` means the card: with none visible, every new entry
    point raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: entry.train_image(sanity=True),
                 entry.sample_image, entry.compose_scores,
                 lambda: entry.train_vae(sanity=True),
                 entry.compose_latent_vae):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


EVAL_OV = ["--model.base_dim=8", "--model.channel_mults=(1,2)",
           "--data.img_size=16", "--train.steps=2", "--train.batch_size=4",
           "--data.n=27"]


def test_latent_2d_paths_launch_their_kernels(tmp_path):
    """``fit_pca`` no kernel; ``train_latent_2d`` one ``matmul`` launch
    (the encode) and no other; ``superposition_2d`` none."""
    ov = ["--data.n=256", "--train.steps=3", "--train.batch_size=16"]
    n0, m0 = _launches(), kernels.matmul.launches
    entry.fit_pca("shapes_latent", out=str(tmp_path),
                  overrides=ov + ["--data.img_size=16"])
    assert _launches() == n0 and kernels.matmul.launches == m0
    params, losses, _ = entry.train_latent_2d(
        "shapes_latent", out=str(tmp_path),
        overrides=ov + ["--data.img_size=16"])
    torch.cuda.synchronize()
    assert kernels.matmul.launches == m0 + 1 and _launches() == n0
    assert losses.is_cuda and losses.shape == (3,)
    res = entry.superposition_2d(steps=2, hidden=16, bs=8, n_sample_steps=3,
                                 out=str(tmp_path / "sp"))
    assert _launches() == n0 and kernels.matmul.launches == m0 + 1
    assert res["samples"].is_cuda and bool(torch.isfinite(res["ll"]).all())


def test_eval_composition_launches_per_operator(tmp_path):
    """Per call (9 combinations, 2 steps, 2 samples): ``avg`` 5 + 1 K4
    launches per expert forward (a UNet of two levels; 2 forwards a step)
    and one K3 a step; ``cfg`` and ``proj`` the K4 launches alone; ``ito``
    none; ``cg`` the experts' and the blend's, none from the probe's
    gradient."""
    from composable_diffusion_models_tpu_torch import eval_composition as ec
    kw = dict(samples_per_combo=2, probe_steps=2, n_steps=2,
              factor0_grayscale=True, gray_norm=True, out=str(tmp_path),
              overrides=EVAL_OV)
    fwd = 9 * 2 * 2
    for op, want in (("avg", (5 * fwd, fwd, 18)),
                     ("cfg", (5 * fwd, fwd, 0)),
                     ("proj", (5 * fwd, fwd, 0)), ("ito", (0, 0, 0)),
                     ("cg", (5 * fwd, fwd, 18))):
        n0 = _launches()
        rep = ec.eval_composition(op=op, **kw)
        torch.cuda.synchronize()
        assert tuple(b - a for a, b in zip(n0, _launches())) == want, op
        assert len(rep["ops"][op]["combos"]) == 9


def test_eval_superdiff_and_ito_launches(tmp_path):
    """The mixture protocol at its sanity sizes: 8 + 2 K4 launches per
    forward, 2 forwards a step, 3 jobs of T 8; ``compose_images_ito``
    none."""
    from composable_diffusion_models_tpu_torch import eval_superdiff as es
    from composable_diffusion_models_tpu_torch.checkpoint import \
        CheckpointManager
    from composable_diffusion_models_tpu_torch.models.unet import UNet
    n0 = _launches()
    rep = es.eval_superdiff(sanity=True, out=str(tmp_path))
    torch.cuda.synchronize()
    fwd = 3 * 2 * 8
    assert tuple(b - a for a, b in zip(n0, _launches())) == (8 * fwd,
                                                             2 * fwd, 0)
    assert set(rep["ops"]) == {"OR", "AND_heuristic", "AND_rigorous"}
    mgr = CheckpointManager(str(tmp_path), "shapes_ddim")
    for i, (name, ch) in enumerate((("shape_expert", 1),
                                    ("color_expert", 3))):
        m = UNet(in_channels=ch, base_dim=8, channel_mults=(1, 2),
                 num_classes=(3,))
        mgr.save(name, {"params": convert.unet_torch_layout(
            convert.from_flax(convert.init_params(m, seed=i))), "step": 0})
    n0 = _launches()
    out = entry.compose_images_ito(n_steps=2, out=str(tmp_path),
                                   overrides=EVAL_OV[:3])
    assert _launches() == n0 and out.is_cuda and out.shape == (9, 16, 16, 3)
