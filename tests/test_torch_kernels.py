"""Port parity: the kernels' plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU) and their XLA fallbacks, on the
same numpy inputs; and the wrappers' CPU dispatch and input checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from composable_diffusion_models_tpu.ops import pallas_kernels as pk
from composable_diffusion_models_tpu.ops.attention import (
    flash_attention as jax_flash)
from composable_diffusion_models_tpu_torch.ops import attention, kernels

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


@pytest.mark.parametrize("b,t,d,h", [(2, 256, 256, 8),   # dit_p4_d256_l8
                                     (3, 81, 64, 2)])    # a partial block
@pytest.mark.parametrize("use_pallas", [True, False])
def test_fused_dit_block_ref_matches_jax_long_images(b, t, d, h, use_pallas):
    """Images of more than 64 tokens (the cluster route's, in bf16 on the
    card): the plain version in float32 against the Pallas kernel (one
    256-row program an image) and its XLA fallback, to the JAX tests' own
    2e-4. The float32 kernel takes no such image, on either device."""
    args = _block_args(np.random.default_rng(b + t + d), b, t, d)
    ref = np.asarray(pk.fused_dit_block(*map(jnp.asarray, args), h,
                                        use_pallas=use_pallas))
    got = kernels.fused_dit_block_ref(*map(torch.from_numpy, args),
                                      h).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_dit_block(*map(torch.from_numpy, args), h)


def test_fused_dit_block_bf16_long_image_matches_pallas():
    """bf16 at the shapes gate's dit_p4_d256_l8 shape, 256 tokens at
    D = 256: the plain version against the Pallas kernel's bf16 rounding
    sites to 4 bf16 ulps of the output scale (as at the serving shape), and
    the wrapper on CPU tensors returns the plain version bit for bit."""
    args = _block_args(np.random.default_rng(5), 2, 256, 256, scale=0.06)
    ref = np.asarray(pk.fused_dit_block(
        *(jnp.asarray(a, jnp.bfloat16) for a in args), 8,
        use_pallas=True).astype(jnp.float32))
    targs = [torch.from_numpy(a).bfloat16() for a in args]
    plain = kernels.fused_dit_block_ref(*targs, 8)
    got = plain.float().numpy()
    assert float(np.abs(got - ref).max()) <= \
        4 * 2.0 ** -8 * float(np.abs(ref).max())
    wrapped = kernels.fused_dit_block(*targs, 8)
    assert wrapped.dtype == torch.bfloat16
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("t", [65, 81, 128, 192, 256])
def test_block_cluster_route(t, d):
    """bf16 images of 65-256 tokens at D <= 256 take the cluster route:
    ceil(T / 64) blocks of 64 rows an image, each in the wgmma route's
    shared-memory layout with the wide buffer grown, where 4D columns are
    fewer, to the 3D columns of qkv and four staging panels of attention,
    B x n blocks a launch."""
    n = -(-t // 64)
    assert kernels.block_route(torch.bfloat16, t, d) == "cluster"
    assert kernels.block_cluster(torch.bfloat16, t, d) == n
    assert kernels.block_rows(torch.bfloat16, t, d) == 64
    assert kernels.block_grid(torch.bfloat16, 64, t, d) == 64 * n
    assert kernels.block_smem_bytes(torch.bfloat16, 64, d) == (
        1024 + 4 * d // 64 * 8192 + 8 * 8192 + 64 * (d + 8) * 2 + 512 + 192)
    nbytes = kernels.block_smem_bytes(torch.bfloat16, 64, d, n)
    assert nbytes == (1024 + (3 * d // 64 + 4) * 8192 + 8 * 8192
                      + 64 * (d + 8) * 2 + 512 + 192)
    assert nbytes <= 232448
    # the one-block routes keep one block an image or less
    assert kernels.block_cluster(torch.bfloat16, 64, d) == 1
    assert kernels.block_route(torch.bfloat16, 64, d) == "wgmma"
    assert kernels.block_grid(torch.bfloat16, 64, 16, d) == 16
    assert kernels.block_cluster(torch.float32, 16, d) == 1


@pytest.mark.parametrize("d", [32, 64, 96, 128, 160, 192, 224, 256])
def test_block_smem_bytes_cluster_route_fits(d):
    """The cluster route's block fits at every D it takes: its wide buffer
    is the wgmma route's 4D columns or, where more, ceil(3D / 64) panels
    of qkv and four 8 KB staging panels (two for each consumer
    warpgroup); at D = 256 the two are the same 16 panels."""
    one = kernels.block_smem_bytes(torch.bfloat16, 64, d)
    for n in (2, 3, 4):
        nbytes = kernels.block_smem_bytes(torch.bfloat16, 64, d, n)
        assert nbytes <= 232448
        assert nbytes - one == 8192 * max(0, -(-3 * d // 64) + 4
                                          - 4 * d // 64)
    assert (kernels.block_smem_bytes(torch.bfloat16, 64, d, 4) == one) == (
        d == 256)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_block_cluster_route_limit(d):
    """Past 256 tokens (a cluster of 4 blocks) a bf16 image raises before
    the CPU branch, naming the limit; so does the wrapper."""
    for helper in (kernels.block_cluster, kernels.block_rows,
                   kernels.block_route):
        with pytest.raises(ValueError, match="limit of 256 tokens"):
            helper(torch.bfloat16, 257, d)
    args = [torch.from_numpy(a).bfloat16() for a in
            _block_args(np.random.default_rng(d), 1, 257, d)]
    with pytest.raises(ValueError, match="limit of 256 tokens"):
        kernels.fused_dit_block(*args, d // 32)


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


# ----------------------------------------------------------- groupnorm_silu
def _gn_inputs(rng, shape):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 8),
                                          ((3, 7, 7, 24), 4),
                                          ((2, 16, 16, 8), 8),
                                          ((1, 4, 6, 64), 8)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_groupnorm_silu_ref_matches_jax(shape, groups, use_pallas):
    x, scale, bias = _gn_inputs(np.random.default_rng(sum(shape)), shape)
    ref = np.asarray(pk.groupnorm_silu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        groups=groups, use_pallas=use_pallas))
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = kernels.groupnorm_silu_ref(*args, groups=groups).numpy()
    # fp32 end to end (the JAX tests' own bar for kernel vs fallback)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    wrapped = kernels.groupnorm_silu(*args, groups=groups).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_groupnorm_silu_bf16_matches_pallas():
    """bf16 in and out, float32 statistics and arithmetic on both sides,
    one rounding at the store: at most one bf16 ulp (2^-8 relative) of the
    output scale apart, where the float32 results straddle a rounding
    boundary."""
    x, scale, bias = _gn_inputs(np.random.default_rng(7), (2, 8, 8, 16))
    ref = np.asarray(pk.groupnorm_silu(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias),
        groups=8, use_pallas=True).astype(jnp.float32))
    got = kernels.groupnorm_silu_ref(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
        torch.from_numpy(bias), groups=8)
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -8 * float(np.abs(ref).max())
    assert float(np.abs(got.float().numpy() - ref).max()) <= tol


def test_groupnorm_silu_clamps_the_variance():
    """A constant sample far from 0: E[x^2] - E[x]^2 cancels to a value
    that may be negative in float32. The port clamps it (as the JAX
    package's XLA path does), so the output is finite: SiLU(bias)."""
    x = torch.full((1, 4, 4, 8), 4097.3)
    out = kernels.groupnorm_silu(x, torch.ones(8), torch.full((8,), 0.5), 2)
    assert bool(torch.isfinite(out).all())
    y = torch.tensor(0.5)
    torch.testing.assert_close(out, (y * torch.sigmoid(y)).expand_as(out),
                               rtol=0, atol=0.2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_split_matches_jax(dtype):
    """Two parts of 16 and 8 channels under 4 groups of 6: the third group
    (channels 12-17) straddles the parts. Also against the concatenated
    plain version."""
    rng = np.random.default_rng(11)
    a, scale, bias = _gn_inputs(rng, (2, 4, 4, 24))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    parts = [a[..., :16], a[..., 16:]]
    ref = pk.groupnorm_silu_split(
        [jnp.asarray(p, jdt) for p in parts], jnp.asarray(scale),
        jnp.asarray(bias), groups=4)
    got = kernels.groupnorm_silu_split(
        [torch.from_numpy(np.ascontiguousarray(p)).to(dtype) for p in parts],
        torch.from_numpy(scale), torch.from_numpy(bias), groups=4)
    whole = kernels.groupnorm_silu_ref(
        torch.from_numpy(a).to(dtype), torch.from_numpy(scale),
        torch.from_numpy(bias), groups=4).float().numpy()
    # fp32: summation order; bf16: one ulp of the output scale
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -8 * float(
        np.abs(whole).max())
    for g, r, w in zip(got, ref, (whole[..., :16], whole[..., 16:])):
        assert g.dtype == dtype
        g = g.float().numpy()
        assert float(np.abs(g - np.asarray(r.astype(jnp.float32))).max()) <= tol
        assert float(np.abs(g - w).max()) <= tol


@pytest.mark.parametrize("hw,chans,groups", [
    ((4, 4), (16, 8), 4),      # 4 groups of 6: group 2 straddles the parts
    ((5, 3), (8, 24), 2),      # 2 groups of 16: group 0 spans part 0 and on
    ((6, 6), (40,), 5),        # one part
    ((3, 3), (12, 12, 24), 8),  # three parts, groups of 6 inside each
    ((2, 7), (48, 24), 8),     # the up blocks' 2 : 1 ratio, groups of 9
    ((4, 2), (8, 8), 1)])      # one group over everything
def test_groupnorm_silu_split_ref_matches_jax(hw, chans, groups):
    """The plain version against the JAX ``groupnorm_silu_split`` and against
    the plain single-tensor version on the concatenation, float32: summation
    order only (1e-5)."""
    rng = np.random.default_rng(sum(chans) + groups)
    a, scale, bias = _gn_inputs(rng, (2, *hw, sum(chans)))
    edges = np.cumsum((0,) + chans)
    parts = [np.ascontiguousarray(a[..., lo:hi])
             for lo, hi in zip(edges[:-1], edges[1:])]
    ref = pk.groupnorm_silu_split([jnp.asarray(p) for p in parts],
                                  jnp.asarray(scale), jnp.asarray(bias),
                                  groups=groups)
    tparts = [torch.from_numpy(p) for p in parts]
    got = kernels.groupnorm_silu_split_ref(
        tparts, torch.from_numpy(scale), torch.from_numpy(bias), groups=groups)
    whole = kernels.groupnorm_silu_ref(
        torch.from_numpy(a), torch.from_numpy(scale), torch.from_numpy(bias),
        groups=groups).numpy()
    assert len(got) == len(parts)
    for g, r, lo, hi in zip(got, ref, edges[:-1], edges[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), whole[..., lo:hi], rtol=0,
                                   atol=1e-5)
    if len(parts) <= 2:  # the wrapper takes what the kernel takes
        wrapped = kernels.groupnorm_silu_split(
            tparts, torch.from_numpy(scale), torch.from_numpy(bias),
            groups=groups)
        for w, g in zip(wrapped, got):
            np.testing.assert_array_equal(w.numpy(), g.numpy())


def test_groupnorm_silu_split_ref_keeps_each_parts_dtype():
    parts = [torch.randn(2, 3, 3, 8), torch.randn(2, 3, 3, 16).bfloat16()]
    outs = kernels.groupnorm_silu_split_ref(parts, torch.ones(24),
                                            torch.zeros(24), groups=4)
    assert [o.dtype for o in outs] == [torch.float32, torch.bfloat16]
    assert [o.shape for o in outs] == [p.shape for p in parts]


@pytest.mark.parametrize("bad", ["three_parts", "no_parts", "strided_part",
                                 "batch", "hw", "groups", "mixed_dtype",
                                 "rank", "dtype", "scale_shape"])
def test_groupnorm_silu_split_rejects(bad):
    """The wrapper raises on what the kernel does not take, on the CPU as on
    the card; it never hands such input to the plain version."""
    parts = [torch.zeros(2, 4, 4, 16), torch.zeros(2, 4, 4, 8)]
    scale, bias, groups = torch.ones(24), torch.zeros(24), 4
    if bad == "three_parts":
        parts.append(torch.zeros(2, 4, 4, 8))
        scale, bias = torch.ones(32), torch.zeros(32)
    elif bad == "no_parts":
        parts = []
    elif bad == "strided_part":  # a channel slice of a wider tensor
        parts[1] = torch.zeros(2, 4, 4, 16)[..., :8]
    elif bad == "batch":
        parts[1] = torch.zeros(3, 4, 4, 8)
    elif bad == "hw":
        parts[1] = torch.zeros(2, 4, 2, 8)
    elif bad == "groups":
        groups = 5
    elif bad == "mixed_dtype":
        parts[1] = parts[1].bfloat16()
    elif bad == "rank":
        parts = [torch.zeros(2, 16, 16), torch.zeros(2, 16, 8)]
    elif bad == "dtype":
        parts = [p.half() for p in parts]
    else:
        scale = torch.ones(16)
    with pytest.raises(ValueError):
        kernels.groupnorm_silu_split(parts, scale, bias, groups)


@pytest.mark.parametrize("bad", ["nchw_view", "rank", "dtype", "groups",
                                 "scale_shape", "scale_dtype"])
def test_groupnorm_silu_rejects(bad):
    x, scale, bias, groups = torch.zeros(2, 4, 4, 16), torch.ones(16), \
        torch.zeros(16), 8
    if bad == "nchw_view":  # C is not the fastest axis in memory
        x = torch.zeros(2, 16, 4, 4).permute(0, 2, 3, 1)
    elif bad == "rank":
        x = torch.zeros(2, 16, 16)
    elif bad == "dtype":
        x = x.half()
    elif bad == "groups":
        groups = 5
    elif bad == "scale_shape":
        scale = torch.ones(8)
    else:
        scale = scale.bfloat16()
    with pytest.raises(ValueError):
        kernels.groupnorm_silu(x, scale, bias, groups)


@pytest.mark.parametrize("dtype,n,hw,c,splits", [
    (torch.bfloat16, 128, 4096, 64, 8), (torch.bfloat16, 128, 1024, 128, 4),
    (torch.bfloat16, 192, 784, 64, 2), (torch.float32, 128, 4096, 64, 16),
    (torch.float32, 192, 49, 256, 2), (torch.bfloat16, 3, 49, 24, 1),
    (torch.float32, 1, 4096, 1024, 32),
    # the two-part launches, by their widest part: paths A (bf16) and B
    (torch.bfloat16, 128, 1024, 256, 8), (torch.bfloat16, 128, 4096, 128, 16),
    (torch.float32, 192, 196, 256, 2), (torch.float32, 192, 784, 128, 6),
    # 192 x 3 blocks would spill over one wave of 528: cut back to 2
    (torch.float32, 192, 784, 64, 2), (torch.float32, 600, 784, 64, 3),
    (torch.float32, 600, 49, 256, 1),
    (torch.float32, 100, 784, 64, 5), (torch.float32, 128, 1536, 64, 4)])
def test_gn_splits(dtype, n, hw, c, splits):
    assert kernels.gn_splits(dtype, n, hw, c) == splits
    # a split is never thinner than the rows of one block iteration
    rows_per_iter = 256 // (c * (2 if dtype == torch.bfloat16 else 4) // 16)
    assert 1 <= splits <= max(1, min(32, hw // rows_per_iter))
    # never a grid between one wave and one and a half
    assert not 528 < n * splits < 792 or splits == 1


@pytest.mark.parametrize("d", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("t", [1, 4, 16, 49, 64])
def test_block_smem_bytes_fit_at_every_supported_shape(t, d):
    """bfloat16: 64 rows at every D the kernel takes (a multiple of 32 up to
    256). float32: the rows block_rows picks fit; where no tile holds one
    image it raises."""
    assert kernels.block_rows(torch.bfloat16, t, d) == 64
    nbytes = kernels.block_smem_bytes(torch.bfloat16, 64, d)
    assert nbytes <= 232448
    # the ring, the alignment slack, the statistics and the barriers are
    # always there, beside 64 rows of 4D + D elements
    assert nbytes >= 8 * 32 * 128 * 2 + 1024 + 512 + 192 + 64 * 5 * d * 2
    try:
        rows = kernels.block_rows(torch.float32, t, d)
    except ValueError:
        assert all(t > r or kernels.block_smem_bytes(torch.float32, r, d)
                   > 232448 for r in (64, 32, 16))
    else:
        assert t <= rows
        assert kernels.block_smem_bytes(torch.float32, rows, d) <= 232448


def test_block_smem_bytes_bf16_is_the_kernels_layout():
    """At D = 256: 1024 to align, 16 panels of 8 KB, 8 stages of 8 KB, the
    residual [64][264], 2 x 64 float32 statistics and 24 mbarriers. Past
    D = 256 the wide route: X and LN(x) [32][D + 8] and the wide buffer
    [32][4D + 8], two bytes each, 8 mbarriers, 1024 to align the ring and
    its 3 stages of 32 x 384 bf16; an image of more than 32 tokens fits no
    tile there."""
    assert kernels.block_smem_bytes(torch.bfloat16, 64, 256) == (
        1024 + 16 * 8192 + 8 * 8192 + 64 * 264 * 2 + 512 + 192)
    with pytest.raises(ValueError, match="64 rows"):
        kernels.block_smem_bytes(torch.bfloat16, 32, 256)
    assert kernels.block_rows(torch.bfloat16, 4, 288) == 32
    assert kernels.block_smem_bytes(torch.bfloat16, 32, 384) == (
        2 * (2 * 32 * 392 + 32 * 1544) + 64 + 1024 + 3 * 32 * 384 * 2)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.block_rows(torch.bfloat16, 49, 288)


@pytest.mark.parametrize("d,ring,nbytes", [
    (288, (384, 3), 186944),   # 112,128 + 64 + 1024 + 3 x 24,576
    (384, (384, 3), 223808),   # the frontier's dit_p14_d384_l6
    (416, (320, 3), 223808),
    (480, (192, 3), 223808),
    (544, (64, 3), 223808),
    (576, (64, 2), 232000)])   # 222,720 + 64 + 1024 + 2 x 4,096
def test_block_wide_route_layout(d, ring, nbytes):
    """The wide route (bf16 past D = 256): 32 rows a block, the weight ring
    the widest chunk of 384 .. 64 columns whose three stages of 32 k-rows
    fit beside the tile, else two of 64 (D = 576); the bytes are the
    kernel's (csrc/fused_dit_block.cu smem_bytes_wide) and fit. Past 32
    tokens, or past D = 576, nothing fits."""
    assert kernels.block_route(torch.bfloat16, 4, d) == "wide"
    assert kernels.block_rows(torch.bfloat16, 32, d) == 32
    assert kernels.block_cluster(torch.bfloat16, 32, d) == 1
    assert kernels.block_ring(d) == ring
    assert kernels.block_smem_bytes(torch.bfloat16, 32, d) == nbytes
    assert nbytes <= 232448
    with pytest.raises(ValueError, match="32 rows"):
        kernels.block_smem_bytes(torch.bfloat16, 64, d)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.block_rows(torch.bfloat16, 33, d)
    assert kernels.block_ring(608) is None
    with pytest.raises(ValueError, match="shared memory"):
        kernels.block_rows(torch.bfloat16, 4, 608)
    # float32 keeps the rows route
    assert kernels.block_route(torch.float32, 4, 384) == "rows"
    assert kernels.block_split(torch.float32, 256, 4, 384, 8) == 1


@pytest.mark.parametrize("b,t,d,h,n", [
    (256, 4, 384, 8, 2),    # the frontier: 32 tiles x 4 would be two waves
    (128, 4, 384, 8, 4),    # 16 tiles: one wave of clusters of 4
    (7, 4, 384, 8, 4),      # one tile, 7 images
    (512, 4, 384, 8, 2),    # 64 tiles: one wave of 66 clusters of 2
    (2048, 4, 384, 8, 1),   # 256 tiles: 2 waves of 132 single blocks
    (33, 16, 384, 6, 3),    # heads of 64: 3 divides 6, 4 does not
    (3, 32, 288, 9, 3),     # one image a tile
    (2, 4, 320, 5, 1),      # 5 heads: no cluster
    (9, 4, 576, 12, 4), (3, 16, 576, 36, 4), (4, 8, 448, 7, 1)])
def test_block_split_and_grid_wide_route(b, t, d, h, n):
    """Blocks a tile on the wide route: n divides the heads and is at most
    4, and of those the one whose waves x per-block cost (n + 6) / n is
    least at an H100's 132 / 66 / 39 / 30 clusters of 1 / 2 / 3 / 4; the
    grid is the tiles x n. The grid needs the heads there."""
    assert kernels.block_split(torch.bfloat16, b, t, d, h) == n
    tiles = -(-b // (32 // t))
    assert kernels.block_grid(torch.bfloat16, b, t, d, h) == tiles * n
    with pytest.raises(ValueError, match="n_heads"):
        kernels.block_grid(torch.bfloat16, b, t, d)
    # the other routes take no split
    assert kernels.block_split(torch.bfloat16, b, 4, 256, 8) == 1
    assert kernels.block_grid(torch.bfloat16, 64, 16, 256) == 16


@pytest.mark.parametrize("use_pallas", [True, False])
def test_fused_dit_block_ref_matches_jax_at_the_frontier_width(use_pallas):
    """The frontier's dit_p14_d384_l6 block (4 tokens of 384, 8 heads of
    48; the wide route in bf16 on the card): the plain version in float32
    against the Pallas kernel in interpret mode and its XLA fallback, to
    the JAX tests' 2e-4, the CPU wrapper bit for bit."""
    args = _block_args(np.random.default_rng(384), 3, 4, 384)
    ref = np.asarray(pk.fused_dit_block(*map(jnp.asarray, args), 8,
                                        use_pallas=use_pallas))
    got = kernels.fused_dit_block_ref(*map(torch.from_numpy, args),
                                      8).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    wrapped = kernels.fused_dit_block(*map(torch.from_numpy, args),
                                      8).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_fused_dit_block_bf16_matches_pallas_at_the_frontier_width():
    """bf16 at (3, 4, 384) with heads of 48 against the Pallas kernel's
    bf16 rounding sites: 4 bf16 ulps of the output scale, as at D = 256."""
    args = _block_args(np.random.default_rng(48), 3, 4, 384, scale=0.05)
    ref = np.asarray(pk.fused_dit_block(
        *(jnp.asarray(a, jnp.bfloat16) for a in args), 8,
        use_pallas=True).astype(jnp.float32))
    got = kernels.fused_dit_block_ref(
        *(torch.from_numpy(a).bfloat16() for a in args), 8).float().numpy()
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 4 * 2.0 ** -8 * scale


# ---------------------------------------------------------- flash_attention
def _qkv(rng, b, h, nq, nk, d):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d))]


@pytest.mark.parametrize("b,h,nq,nk,d", [(1, 2, 128, 2, 32),     # label context
                                         (1, 2, 128, 200, 32),   # ragged keys
                                         (2, 2, 128, 128, 64),
                                         (2, 4, 49, 2, 16)])     # UNet site
@pytest.mark.parametrize("use_pallas", [True, False])
def test_flash_attention_ref_matches_jax(b, h, nq, nk, d, use_pallas):
    q, k, v = _qkv(np.random.default_rng(nq + nk + d), b, h, nq, nk, d)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               use_pallas=use_pallas))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention.flash_attention_ref(tq, tk, tv).numpy()
    # the JAX tests' own bar for kernel vs einsum
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    wrapped = attention.flash_attention(tq, tk, tv).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_flash_attention_bf16_and_scale():
    """bf16 inputs are widened, the probabilities stay float32 and the
    output is rounded once: one bf16 ulp of the O(1) outputs. An explicit
    scale is honoured."""
    q, k, v = _qkv(np.random.default_rng(5), 2, 2, 64, 3, 16)
    ref = np.asarray(jax_flash(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), scale=0.3,
                               use_pallas=True).astype(jnp.float32))
    got = attention.flash_attention_ref(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), scale=0.3)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - ref).max()) <= 2.0 ** -8 * float(
        np.abs(ref).max())


def test_flash_attention_reads_transposed_views():
    """(B, N, H, D) tensors transposed to (B, H, N, D), as the UNet's
    cross-attention hands them over, give what their contiguous copies
    give."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .transpose(1, 2) for s in ((2, 49, 4, 16), (2, 2, 4, 16),
                                          (2, 2, 4, 16)))
    assert not q.is_contiguous()
    out = attention.flash_attention(q, k, v)
    ref = attention.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed", "kv", "heads",
                                 "no_keys"])
def test_flash_attention_rejects(bad):
    q, k, v = torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 3, 16), \
        torch.zeros(2, 2, 3, 16)
    if bad == "rank":
        q = torch.zeros(2, 8, 16)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "kv":
        v = torch.zeros(2, 2, 4, 16)
    elif bad == "heads":
        k, v = torch.zeros(2, 4, 3, 16), torch.zeros(2, 4, 3, 16)
    else:
        k, v = torch.zeros(2, 2, 0, 16), torch.zeros(2, 2, 0, 16)
    with pytest.raises(ValueError):
        attention.flash_attention(q, k, v)


def _bnhd_strides(h, n, d):
    """(batch, head, row) strides of a (B, N, H, D) buffer seen as
    (B, H, N, D): the layout the UNet's cross-attention hands over."""
    return (n * h * d, d, h * d)


@pytest.mark.parametrize("dtype,h,nk,d,strides,route", [
    # path B's three sites: 2 label tokens, strided views; the short route
    # where a query row is at most 64 bytes
    (torch.float32, 4, 2, 16, _bnhd_strides(4, 784, 16) * 4, "short"),
    (torch.float32, 4, 2, 32, _bnhd_strides(4, 196, 32) * 4, "tiles"),
    (torch.float32, 4, 2, 64, _bnhd_strides(4, 49, 64) * 4, "tiles"),
    (torch.bfloat16, 4, 2, 16, _bnhd_strides(4, 784, 16) * 4, "short"),
    (torch.bfloat16, 4, 2, 32, _bnhd_strides(4, 196, 32) * 4, "short"),
    (torch.bfloat16, 4, 2, 64, _bnhd_strides(4, 49, 64) * 4, "tiles"),
    # the short route's limit and one past it; more heads than a block holds
    (torch.float32, 8, 4, 16, (2048, 1024, 16) * 4, "short"),
    (torch.float32, 8, 5, 16, (2048, 1024, 16) * 4, "tiles"),
    (torch.bfloat16, 128, 4, 16, (4096, 16, 2048) * 4, "short"),
    (torch.bfloat16, 129, 4, 16, (4128, 16, 2064) * 4, "tiles"),
    # bf16 on the tensor cores from Nk * D = 2048 on
    (torch.bfloat16, 8, 31, 64, (8192, 4096, 64) * 4, "tiles"),
    (torch.bfloat16, 8, 32, 64, (8192, 4096, 64) * 4, "wgmma"),
    (torch.bfloat16, 4, 127, 16, _bnhd_strides(4, 784, 16) * 4, "tiles"),
    (torch.bfloat16, 4, 128, 16, _bnhd_strides(4, 784, 16) * 4, "wgmma"),
    # long contexts: bf16 on the tensor cores, float32 on the CUDA cores
    (torch.bfloat16, 8, 4096, 64, (8 * 4096 * 64, 4096 * 64, 64) * 4,
     "wgmma"),
    (torch.bfloat16, 8, 4096, 128, _bnhd_strides(8, 4096, 128) * 4, "wgmma"),
    (torch.float32, 8, 4096, 64, (8 * 4096 * 64, 4096 * 64, 64) * 4,
     "tiles"),
    # bf16 rows that are 8 but not 16 bytes apart, in q, k or v
    (torch.bfloat16, 3, 100, 32, (3 * 100 * 20, 100 * 20, 20) * 4, "tiles"),
    (torch.bfloat16, 16, 100, 64, (4096, 1024, 64) * 2 + (4096, 1024, 68)
     + (4096, 1024, 64), "tiles"),
    # out's strides do not enter: its stores are 4 bytes wide
    (torch.bfloat16, 16, 100, 64, (4096, 1024, 64) * 3 + (4100, 1028, 68),
     "wgmma"),
])
def test_flash_route(dtype, h, nk, d, strides, route):
    assert attention.flash_route(dtype, h, nk, d, strides) == route


def _flash_wgmma_emulation(q, k, v, scale, bkv):
    """The arithmetic of flash_attention's bf16 tensor-core route on the
    CPU, before the output's rounding: q * scale split into two bf16 terms
    (qh + ql), S = qh k^T + ql k^T in float32; per tile of ``bkv`` keys the
    running max from -1e30, p = exp(s - m) split into ph + pl, O = O * alpha
    + ph v + pl v, float32 denominators; O / l in float32."""
    bf = torch.bfloat16
    qs = q.float() * scale
    qh = qs.to(bf).float()
    ql = (qs - qh).to(bf).float()
    kf, vf = k.float(), v.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, k.shape[2], bkv):
        kt, vt = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        s = qh @ kt.transpose(-1, -2) + ql @ kt.transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ph = p.to(bf).float()
        pl = (p - ph).to(bf).float()
        acc = acc * alpha + ph @ vt + pl @ vt
        m = m_new
    return acc / l


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_wgmma_split_arithmetic(d):
    """The bf16 tensor-core route's split products hold the plain version
    to the bf16 bar (4 ulps of scale) on the rounded output, and to 2^-12
    of scale before that rounding: what the split leaves out of each fp32
    product is below 2^-16 of it, where a single bf16 term of q * scale and
    of p would miss by up to 2^-9. D = 32 and 128 split q (their scale is
    not a power of two), D = 64 does not (ql is 0)."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(1, 2, n, d, generator=g).bfloat16()
               for n in (256, 512, 512))
    scale = 1.0 / d ** 0.5
    bkv = 128 if d <= 64 else 64
    emu = _flash_wgmma_emulation(q, k, v, scale, bkv)
    ref = attention.flash_attention_ref(q.float(), k.float(), v.float(),
                                        scale)
    bar = max(1.0, float(ref.abs().max()))
    assert float((emu - ref).abs().max()) <= 2.0 ** -12 * bar
    got16 = emu.to(torch.bfloat16).float()
    ref16 = attention.flash_attention_ref(q, k, v, scale).float()
    assert float((got16 - ref16).abs().max()) <= 4 * 2.0 ** -8 * bar
    qs = q.float() * scale
    assert bool((qs - qs.to(torch.bfloat16).float() == 0).all()) == (d == 64)


# ------------------------------------------- limits shared by CPU and card
def test_flash_head_dim_pads_to_the_kernel_widths():
    """The pure helper behind the card's padding: the next of 16, 32, 64,
    128 and 256; wider heads raise."""
    widths = {d: attention.flash_head_dim(d) for d in range(1, 257)}
    assert {widths[d] for d in range(1, 17)} == {16}
    assert {widths[d] for d in range(17, 33)} == {32}
    assert {widths[d] for d in range(33, 65)} == {64}
    assert {widths[d] for d in range(65, 129)} == {128}
    assert {widths[d] for d in range(129, 257)} == {256}
    with pytest.raises(ValueError, match="D=257"):
        attention.flash_head_dim(257)


@pytest.mark.parametrize("d", [8, 24, 100, 160, 300])
def test_flash_attention_cpu_takes_what_the_card_takes(d):
    """Any D up to 256 gives the plain version on the CPU (the card pads
    it); a D the card refuses, the CPU refuses too."""
    q, k, v = (torch.randn(2, 2, n, d) for n in (5, 3, 3))
    if d > 256:
        with pytest.raises(ValueError, match="D=300"):
            attention.flash_attention(q, k, v)
        return
    torch.testing.assert_close(attention.flash_attention(q, k, v),
                               attention.flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype,c", [(torch.float32, 6),
                                     (torch.bfloat16, 12),
                                     (torch.float32, 1028),
                                     (torch.bfloat16, 2056)])
def test_groupnorm_cpu_refuses_what_the_card_refuses(dtype, c):
    """C must be a multiple of 16 bytes of elements and at most 256 such
    vectors: checked before the CPU branch, for both wrappers."""
    x = torch.zeros(2, 2, 2, c, dtype=dtype)
    scale, bias = torch.ones(c), torch.zeros(c)
    with pytest.raises(ValueError, match=f"C={c}"):
        kernels.groupnorm_silu(x, scale, bias, 2)
    part = torch.zeros(2, 2, 2, 16, dtype=dtype)
    with pytest.raises(ValueError, match=f"C={c}"):
        kernels.groupnorm_silu_split([part, x], torch.ones(16 + c),
                                     torch.zeros(16 + c), 2)
