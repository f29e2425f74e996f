"""The DiT path's two kernels, the UNet's GroupNorm + SiLU kernel and the
latent path's expert blend and PCA-codec product, with their plain PyTorch
versions and wrappers (``flash_attention`` lives in ``ops/attention.py``, as
in the JAX package).

``short_seq_attention``, ``fused_dit_block``, ``groupnorm_silu``,
``blend_eps`` and ``matmul`` are hand-written CUDA C++ for Hopper
(``csrc/``), built with nvcc at first use and called through ctypes. Each
wrapper validates its inputs, and then:

* for tensors on the CPU, returns its plain version (``*_ref``);
* for tensors on the CUDA card, launches the kernel on the current stream,
  raises if the launch fails, and adds one to its ``launches`` count.

A CUDA tensor never takes the plain version. No kernel has a backward or a
forward-mode rule (nor has any TPU kernel), and a launch writes a fresh
tensor that carries neither: so every wrapper refuses, on every device, an
input that requires grad under grad mode or that carries a forward-mode
tangent (``torch.func.jvp``, a ``forward_ad`` dual), instead of dropping
the derivative. Differentiate the PyTorch-op paths (``fused_gn=False``,
``flash_attn=False``, ``pallas_attn=False``, ``compose.weighted``).

The plain versions follow the TPU kernels' rounding sites
(composable_diffusion_models_tpu/ops/pallas_kernels.py): fp32 scores and
softmax, probabilities rounded to the input type before the value product,
GEMMs accumulated in fp32 with the bias added in fp32 and one rounding
after it, residual adds in the stream type. Between two such roundings the
bfloat16 kernels evaluate the GELU (``fused_dit_block``) and the sigmoid
(``groupnorm_silu``) as x / (1 + exp(-z)) with the card's approximate exp
and reciprocal (~2 float32 ulps, far inside the bf16 rounding that
follows); the float32 kernels use the plain versions' tanh, exp and
division. On the card, compare them with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, likewise cudnn).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch._C._functorch import is_functorch_wrapped_tensor

from ._build import library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# fused_dit_block's shared-memory layout constants (csrc/fused_dit_block.cu)
_KT, _NC, _PAD = 32, 128, 8
_PANEL_BYTES, _STAGES = 64 * 128, 8
_ATTN_HEAD_DIMS = (8, 16, 32, 48, 64)
_BLOCK_HEAD_DIMS = (16, 32, 48, 64)
_WGMMA_MAX_D = 256  # widest bfloat16 stream of the 64-row wgmma route
_MAX_CLUSTER = 4    # blocks of an image or a tile (MAX_CLUSTER)
_WIDE_ROWS = 32     # token rows of a wide-route tile (MTW)
_WIDE_CHUNKS = (384, 320, 256, 192, 128, 64)  # its weight ring's stages
# Clusters of n wide-route blocks an H100 holds at once
# (cudaOccupancyMaxActiveClusters at 187-232 KB of shared memory a block, one
# block an SM; chip_smoke.py prints them), and the cost of a block at n
# blocks a tile, ~ (n + _WIDE_FIXED) / n: its weight stream shrinks with n,
# its LayerNorms, attention and exchanges do not (fitted to chip_smoke.py's
# times of the route at (128, 4, 384) with 4, 2 and 1 blocks a tile)
_WIDE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30}
_WIDE_FIXED = 6
# groupnorm_silu's launch geometry (csrc/groupnorm_silu.cu)
_GN_THREADS = 256
_GN_MAX_SPLITS = 32
_GN_WAVE = 132 * 4  # blocks an H100 runs at once: 4 to each of its 132 SMs


# ------------------------------------------------------------ plain versions
def ln_f32(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine: fp32 stats (one-pass variance, clamped at
    0), eps 1e-6, result in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def short_seq_attention_ref(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain version of :func:`short_seq_attention`."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = qkv.reshape(b, t, 3, n_heads, hd).float().unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / float(hd) ** 0.5)
    a = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", a, v)
    return o.reshape(b, t, d).to(qkv.dtype)


def fused_dit_block_ref(tok, w_qkv, b_qkv, w_pr, b_pr, w1, b1, w2, b2,
                        n_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_dit_block`."""
    cdt = tok.dtype

    def gemm(a, w, bias):
        return (a.float() @ w.float() + bias.float()).to(cdt)

    x = tok
    qkv = gemm(ln_f32(x), w_qkv, b_qkv)
    x = x + gemm(short_seq_attention_ref(qkv, n_heads), w_pr, b_pr)
    h = F.gelu(gemm(ln_f32(x), w1, b1).float(), approximate="tanh").to(cdt)
    return x + gemm(h, w2, b2)


# ------------------------------------------------------------------ checks
def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def no_autodiff(name: str, *tensors: torch.Tensor) -> None:
    """Raises where a launch would drop a derivative: an input that
    requires grad while grad mode is on, one wrapped by a ``torch.func``
    transform (``jvp``, ``grad``, ``vmap``), or a ``forward_ad`` dual."""
    grad = torch.is_grad_enabled()
    dual = fwAD._current_level >= 0
    for t in tensors:
        if ((grad and t.requires_grad) or is_functorch_wrapped_tensor(t)
                or (dual and fwAD.unpack_dual(t).tangent is not None)):
            raise RuntimeError(
                f"{name} has no backward or forward-mode rule, and an input "
                f"requires grad or carries a tangent: run it under "
                f"torch.no_grad() on plain tensors, or differentiate the "
                f"PyTorch-op path (fused_gn=False, flash_attn=False, "
                f"pallas_attn=False, compose.weighted)")


def _check_stream_tensor(name: str, t: torch.Tensor) -> None:
    if t.dim() != 3:
        raise ValueError(f"{name}: expected (B, T, C), got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: device {t.device} not supported")


def _stream_ptr(t: torch.Tensor) -> int:
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor) -> int:
    p = t.data_ptr()
    if p % 16:
        raise ValueError("kernel inputs must be 16-byte aligned")
    return p


# ------------------------------------------------------ short_seq_attention
@functools.cache
def _attention_fn():
    fn = library("short_seq_attention").short_seq_attention_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def short_seq_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Multi-head self-attention from a packed (B, T, 3D) qkv tensor
    (layout [q | k | v] x [head] x [head_dim]) -> (B, T, D): softmax over
    keys of q k^T / sqrt(hd), times v. No mask, no bias.

    Kernel limits: float32 or bfloat16, contiguous, head width in
    (8, 16, 32, 48, 64), any B and T."""
    no_autodiff("short_seq_attention", qkv)
    _check_stream_tensor("qkv", qkv)
    b, t, d3 = qkv.shape
    if d3 % 3 or (d3 // 3) % n_heads:
        raise ValueError(f"qkv width {d3} is not 3 x n_heads x head_dim "
                         f"for n_heads={n_heads}")
    d = d3 // 3
    hd = d // n_heads
    if hd not in _ATTN_HEAD_DIMS:
        raise ValueError(f"head width {hd} not in {_ATTN_HEAD_DIMS}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.device.type == "cpu":
        return short_seq_attention_ref(qkv, n_heads)
    out = torch.empty((b, t, d), dtype=qkv.dtype, device=qkv.device)
    if b * t == 0:
        return out
    rc = _attention_fn()(_DTYPE_CODE[qkv.dtype], _ptr(qkv), _ptr(out), b, t,
                         n_heads, hd, 1.0 / float(hd) ** 0.5,
                         _stream_ptr(qkv))
    if rc:
        raise RuntimeError(f"short_seq_attention kernel launch failed: CUDA "
                           f"error {rc}")
    short_seq_attention.launches += 1
    return out


short_seq_attention.launches = 0


# ---------------------------------------------------------- fused_dit_block
def _wide_tile_bytes(d: int) -> int:
    return (2 * (2 * _WIDE_ROWS * (d + _PAD) + _WIDE_ROWS * (4 * d + _PAD))
            + 8 * 8 + 1024)


def _wide_stage_bytes(nch: int) -> int:
    return 2 * _KT * nch


def block_ring(d: int):
    """The wide route's weight ring at width ``d`` (smem_bytes_wide): (the
    N-chunk columns a stage holds, stages), the widest chunk of 384, 320,
    .., 64 columns whose three stages of 32 x chunk bf16 fit beside the
    tile, else two stages of 64 columns; None where nothing fits."""
    for nch in _WIDE_CHUNKS:
        if _wide_tile_bytes(d) + 3 * _wide_stage_bytes(nch) <= _SMEM_LIMIT:
            return nch, 3
    if _wide_tile_bytes(d) + 2 * _wide_stage_bytes(64) <= _SMEM_LIMIT:
        return 64, 2
    return None


def block_smem_bytes(dtype: torch.dtype, rows: int, d: int,
                     n_cta: int = 1) -> int:
    """Shared memory of one fused_dit_block block holding ``rows`` token
    rows, ``n_cta`` blocks an image. The wgmma and cluster routes
    (bfloat16, D <= 256, 64 rows): up to 1024 bytes of alignment, the wide
    buffer as swizzled panels of 64 x 64 elements (4D columns; on the
    cluster route, n_cta > 1, at least the 3D columns of qkv and four
    staging panels of attention beyond them), a ring of 8 weight stages of
    32 x 128, the residual [64][D + 8], the rows' LayerNorm statistics and
    24 mbarriers. The wide route (bfloat16 wider than 256, 32 rows, any
    blocks a tile): the residual and LayerNorm tiles [32][D + 8], the
    4D-wide buffer [32][4D + 8], 8 mbarriers, up to 1024 bytes to align
    the ring and the :func:`block_ring` (two stages of 64 columns where
    none fits), bf16. The rows route (float32 at 64, 32 or 16 rows), in
    float32: the residual and LayerNorm tiles [rows][D + 8], the 4D-wide
    buffer [rows][4D + 8] and one weight k-tile [32][128 + 8]."""
    if dtype == torch.bfloat16 and d > _WGMMA_MAX_D:
        if rows != _WIDE_ROWS:
            raise ValueError(f"the bfloat16 kernel holds {_WIDE_ROWS} rows "
                             f"a block at D > {_WGMMA_MAX_D}")
        nch, stages = block_ring(d) or (64, 2)
        return _wide_tile_bytes(d) + stages * _wide_stage_bytes(nch)
    if dtype == torch.bfloat16:
        if rows != 64:
            raise ValueError("the bfloat16 kernel holds 64 rows a block at "
                             f"D <= {_WGMMA_MAX_D}")
        panels = -(-4 * d // 64)
        if n_cta > 1:
            panels = max(panels, -(-3 * d // 64) + 4)
        return (1024 + panels * _PANEL_BYTES
                + _STAGES * _KT * _NC * 2 + rows * (d + _PAD) * 2
                + 2 * rows * 4 + 3 * _STAGES * 8)
    if rows not in _block_row_choices(dtype, d):
        raise ValueError(f"the {dtype} rows route holds "
                         f"{_block_row_choices(dtype, d)} rows a block")
    return 4 * (rows * (d + _PAD) * 2 + rows * (4 * d + _PAD)
                + _KT * (_NC + _PAD))


def _block_row_choices(dtype: torch.dtype, d: int) -> tuple:
    if dtype == torch.bfloat16:
        return (64,) if d <= _WGMMA_MAX_D else (_WIDE_ROWS,)
    return (64, 32, 16)


def block_cluster(dtype: torch.dtype, t: int, d: int) -> int:
    """Blocks that hold one image: ceil(T / 64), 2 to 4, on the cluster
    route (bfloat16, D <= 256, 64 < T <= 256: one thread-block cluster an
    image, 64 rows a block); 1 on every other route. Raises for a bfloat16
    image past the cluster route's 256 tokens at D <= 256."""
    if dtype != torch.bfloat16 or d > _WGMMA_MAX_D or t <= 64:
        return 1
    if t > 64 * _MAX_CLUSTER:
        raise ValueError(f"fused_dit_block: an image of {t} tokens x {d} in "
                         f"{dtype} exceeds the cluster route's limit of "
                         f"{64 * _MAX_CLUSTER} tokens ({_MAX_CLUSTER} "
                         f"blocks of 64 rows)")
    return -(-t // 64)


def block_rows(dtype: torch.dtype, t: int, d: int) -> int:
    """Token rows a fused_dit_block block holds (whole images of T rows, or
    on the cluster route 64 rows of one image), which also names the route
    with :func:`block_cluster`: in bfloat16 64 (one warpgroup's wgmma M) up
    to D = 256, T <= 256; past D = 256 the wide route's tile of 32, T <=
    32, up to D = 576; in float32 the largest of 64, 32, 16 that fits.
    Raises if no route holds one image."""
    if block_cluster(dtype, t, d) > 1:
        return 64
    for rows in _block_row_choices(dtype, d):
        if t <= rows and block_smem_bytes(dtype, rows, d) <= _SMEM_LIMIT:
            return rows
    raise ValueError(f"fused_dit_block: an image of {t} tokens x {d} in "
                     f"{dtype} does not fit one block's shared memory")


def block_route(dtype: torch.dtype, t: int, d: int) -> str:
    """"wgmma" (the bfloat16 tensor-core kernel, whole images a block),
    "cluster" (the same kernel, one thread-block cluster an image of more
    than 64 tokens), "wide" (bfloat16 past D = 256: mma.sync GEMMs, one
    thread-block cluster a tile of 32 rows, each block an n-th of every
    GEMM's output columns) or "rows" (float32: fp32 FMAs over staged
    k-tiles): the route :func:`block_rows` and :func:`block_cluster`
    pick."""
    if block_cluster(dtype, t, d) > 1:
        return "cluster"
    block_rows(dtype, t, d)
    if dtype != torch.bfloat16:
        return "rows"
    return "wgmma" if d <= _WGMMA_MAX_D else "wide"


def block_split(dtype: torch.dtype, b: int, t: int, d: int,
                n_heads: int) -> int:
    """Blocks of one thread-block cluster on the wide route (1 on every
    other route): each computes an n-th of every GEMM's output columns and
    whole heads, so it reads an n-th of every weight. n divides ``n_heads``
    and is at most 4; of those, the n whose launch over B images takes
    least by a wave model of an H100: ceil(tiles / clusters of n it holds)
    waves of blocks that each cost ~ (n + 6) / n, the larger n on a tie.
    At the frontier's (256, 4, 384) H 8 that is 2: 32 tiles x 4 blocks
    would take two waves (30 clusters of 4 at once)."""
    if block_route(dtype, t, d) != "wide":
        return 1
    tiles = -(-b // (_WIDE_ROWS // t))
    return min((n for n in (4, 3, 2, 1) if n_heads % n == 0),
               key=lambda n: (-(-tiles // _WIDE_CLUSTERS[n])
                              * (n + _WIDE_FIXED) / n))


def block_grid(dtype: torch.dtype, b: int, t: int, d: int,
               n_heads: int | None = None) -> int:
    """Blocks one launch over B images runs: B x :func:`block_cluster` on
    the cluster route; the tiles (ceil(B / images a tile)) x
    :func:`block_split` on the wide route, which needs ``n_heads``; else
    ceil(B / images a block). Each reads every folded weight through L2,
    but on the wide route an n-th of each."""
    n = block_cluster(dtype, t, d)
    if n > 1:
        return b * n
    tiles = -(-b // (block_rows(dtype, t, d) // t))
    if block_route(dtype, t, d) != "wide":
        return tiles
    if n_heads is None:
        raise ValueError("fused_dit_block: the wide route's grid depends on "
                         "n_heads")
    return tiles * block_split(dtype, b, t, d, n_heads)


@functools.cache
def _block_fn():
    fn = library("fused_dit_block").fused_dit_block_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _clusters_fn():
    fn = library("fused_dit_block").fused_dit_block_max_clusters
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def block_max_clusters(d: int, n_heads: int, n_cta: int) -> int:
    """Clusters of ``n_cta`` blocks the card holds at once
    (``cudaOccupancyMaxActiveClusters``), of the cluster route at width
    ``d`` <= 256 or of the wide route past it; 0 means that such a cluster
    cannot launch. Card only."""
    out = ctypes.c_int(0)
    rc = _clusters_fn()(d, d // n_heads, n_cta, ctypes.byref(out))
    if rc:
        raise RuntimeError(f"fused_dit_block cluster occupancy query failed: "
                           f"CUDA error {rc}")
    return out.value


def fused_dit_block(tok, w_qkv, b_qkv, w_pr, b_pr, w1, b1, w2, b2,
                    n_heads: int) -> torch.Tensor:
    """One adaLN-folded DiT block over ``tok`` (B, T, D) with pre-folded
    weights: returns x + mlp(x) where x = tok + attn(tok), in tok's dtype.

    Kernel limits: float32 or bfloat16 (every weight in tok's dtype,
    contiguous), D a multiple of 32, head width D / n_heads in (16, 32, 48,
    64), and (:func:`block_rows`, :func:`block_cluster`): in bfloat16 up to
    D = 256 T <= 64 (the wgmma route, one image per block) or 64 < T <= 256
    (the cluster route, ceil(T / 64) blocks an image); past that the wide
    route, T <= 32 and D <= 576 (:func:`block_split` blocks a tile); in
    float32 the rows route, T * D small enough for shared memory (T <= 32
    at D = 256)."""
    no_autodiff("fused_dit_block", tok, w_qkv, b_qkv, w_pr, b_pr, w1, b1, w2,
                b2)
    _check_stream_tensor("tok", tok)
    b, t, d = tok.shape
    if d % 32 or d % n_heads or d // n_heads not in _BLOCK_HEAD_DIMS:
        raise ValueError(f"fused_dit_block: D={d} must be a multiple of 32 "
                         f"with head width D/n_heads in {_BLOCK_HEAD_DIMS}")
    rows = block_rows(tok.dtype, t, d)
    n_cta = (block_split(tok.dtype, b, t, d, n_heads)
             if block_route(tok.dtype, t, d) == "wide"
             else block_cluster(tok.dtype, t, d))
    for name, w, shape in (("w_qkv", w_qkv, (d, 3 * d)),
                           ("b_qkv", b_qkv, (3 * d,)),
                           ("w_pr", w_pr, (d, d)), ("b_pr", b_pr, (d,)),
                           ("w1", w1, (d, 4 * d)), ("b1", b1, (4 * d,)),
                           ("w2", w2, (4 * d, d)), ("b2", b2, (d,)),
                           ("tok", tok, (b, t, d))):
        _check(name, w, shape, tok.dtype, tok.device)
    if tok.device.type == "cpu":
        return fused_dit_block_ref(tok, w_qkv, b_qkv, w_pr, b_pr, w1, b1,
                                   w2, b2, n_heads)
    out = torch.empty_like(tok)
    if b * t == 0:
        return out
    hd = d // n_heads
    rc = _block_fn()(_DTYPE_CODE[tok.dtype], _ptr(tok), _ptr(w_qkv),
                     _ptr(b_qkv), _ptr(w_pr), _ptr(b_pr), _ptr(w1), _ptr(b1),
                     _ptr(w2), _ptr(b2), _ptr(out), b, t, d, hd, rows,
                     n_cta, 1.0 / float(hd) ** 0.5, _stream_ptr(tok))
    if rc:
        raise RuntimeError(f"fused_dit_block kernel launch failed: CUDA "
                           f"error {rc}")
    fused_dit_block.launches += 1
    return out


fused_dit_block.launches = 0


# ----------------------------------------------------------- groupnorm_silu
def _gn_check(x, scale, bias, groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x: dtype {x.dtype} not supported (float32 or "
                         f"bfloat16)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x: device {x.device} not supported")
    c = x.shape[-1]
    if groups < 1 or c % groups:
        raise ValueError(f"groups={groups} does not divide C={c}")
    _check("scale", scale, (c,), torch.float32, x.device)
    _check("bias", bias, (c,), torch.float32, x.device)


def _gn_affine(ch_sum, ch_sq, n: int, scale, bias, groups: int, eps: float):
    """Per-sample, per-channel (a, b) of y = x * a + b from (B, C) float32
    channel sums: group mean and one-pass variance (clamped at 0),
    a = rsqrt(var + eps) * scale, b = bias - mean * a."""
    b, c = ch_sum.shape
    cg = c // groups
    g_mean = ch_sum.reshape(b, groups, cg).sum(-1) / n
    g_sq = ch_sq.reshape(b, groups, cg).sum(-1) / n
    inv = torch.rsqrt(torch.clamp(g_sq - g_mean * g_mean, min=0.0) + eps)
    a = inv.repeat_interleave(cg, dim=1) * scale[None, :]
    return a, bias[None, :] - g_mean.repeat_interleave(cg, dim=1) * a


def groupnorm_silu_ref(x, scale, bias, groups: int = 8,
                       eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`groupnorm_silu`: x * a + b in one fused
    multiply-add (``addcmul``), as the kernel computes it."""
    b, h, w, c = x.shape
    xf = x.reshape(b, h * w, c).float()
    a, bb = _gn_affine(xf.sum(1), (xf * xf).sum(1), h * w * (c // groups),
                       scale, bias, groups, eps)
    y = torch.addcmul(bb[:, None, :], xf, a[:, None, :])
    return (y * torch.sigmoid(y)).to(x.dtype).reshape(b, h, w, c)


def gn_splits(dtype: torch.dtype, n: int, hw: int, c: int) -> int:
    """Row splits of a sample (blocks per sample and part) for
    groupnorm_silu's two grids: about 16 block iterations of rows per block,
    more splits where the batch alone would leave SMs without a block,
    never more than 32 or than one iteration's rows allow. A grid that
    spills a little over what the card runs at once pays a second, nearly
    empty wave: it is cut back to one wave (192 samples take 2 splits, not
    3). ``chip_smoke.py`` times the UNet's shapes at fixed split counts
    beside this choice. ``c`` is the widest part's channel count."""
    nvc = c * torch.empty((), dtype=dtype).element_size() // 16
    rows_per_iter = _GN_THREADS // nvc
    want = max(hw // (rows_per_iter * 16), _GN_WAVE // n)
    if _GN_WAVE < n * want < 1.5 * _GN_WAVE:
        want = _GN_WAVE // n
    return max(1, min(want, _GN_MAX_SPLITS, hw // rows_per_iter))


@functools.cache
def _gn_fn():
    fn = library("groupnorm_silu").groupnorm_silu_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _gn_channel_check(name: str, parts) -> None:
    """The kernel's channel limits, checked on every device so that the
    CPU refuses what the card refuses: each part's C a multiple of 16
    bytes of elements and at most 256 such vectors."""
    vec = 16 // parts[0].element_size()
    for p in parts:
        c = p.shape[-1]
        if c % vec or c // vec > _GN_THREADS:
            raise ValueError(f"{name}: C={c} must be a multiple of {vec} "
                             f"and at most {vec * _GN_THREADS} for "
                             f"{p.dtype}")


def _gn_launch(name: str, parts, scale, bias, groups: int, eps: float):
    """Launches the kernel once for CUDA ``parts`` ((B, H, W, C_p), one
    dtype, each contiguous, within :func:`_gn_channel_check`'s limits).
    Returns the outputs, one per part."""
    x = parts[0]
    b, h, w, _ = x.shape
    chans = [p.shape[-1] for p in parts]
    outs = [torch.empty_like(p) for p in parts]
    if x.numel() == 0:
        return outs
    hw = h * w
    splits = gn_splits(x.dtype, b, hw, max(chans))
    scratch = torch.empty((b, splits, len(parts), groups, 2),
                          dtype=torch.float32, device=x.device)
    x1, out1 = (parts[1], outs[1]) if len(parts) == 2 else (x, outs[0])
    rc = _gn_fn()(_DTYPE_CODE[x.dtype], len(parts), _ptr(x), _ptr(x1),
                  _ptr(outs[0]), _ptr(out1), chans[0],
                  chans[1] if len(parts) == 2 else 0, _ptr(scale), _ptr(bias),
                  _ptr(scratch), b, hw, groups, splits, eps, _stream_ptr(x))
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return outs


def groupnorm_silu(x, scale, bias, groups: int = 8,
                   eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)) over NHWC ``x`` (B, H, W, C): statistics per
    sample and per group of C / groups channels over (H, W, C / groups),
    one-pass float32 variance clamped at 0 (the TPU kernel does not clamp
    and returns NaN where cancellation drives it negative; the JAX package's
    XLA path clamps, as here), eps inside the rsqrt, ``scale`` and ``bias``
    (C,) float32, result in x's dtype.

    Kernel limits, checked on every device: float32 or bfloat16; x
    contiguous as (B, H, W, C), that is C fastest in memory (a permuted
    NCHW view raises: the kernel reads ``data_ptr()`` as (B, HW, C)); C a
    multiple of 16 bytes of elements (4 float32, 8 bfloat16) and at most
    256 such vectors."""
    no_autodiff("groupnorm_silu", x, scale, bias)
    _gn_check(x, scale, bias, groups)
    if not x.is_contiguous():
        raise ValueError(
            f"x must be contiguous as (B, H, W, C) with C fastest; got "
            f"strides {x.stride()} for shape {tuple(x.shape)}")
    _gn_channel_check("groupnorm_silu", (x,))
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, scale, bias, groups, eps)
    out, = _gn_launch("groupnorm_silu", (x,), scale, bias, groups, eps)
    if x.numel():
        groupnorm_silu.launches += 1
    return out


groupnorm_silu.launches = 0


def groupnorm_silu_split_ref(parts, scale, bias, groups: int = 8,
                             eps: float = 1e-5):
    """Plain version of :func:`groupnorm_silu_split`, in PyTorch ops on any
    device: per-part channel sums meet as (B, C) float32 arrays, the group
    statistics are combined there, and each part is normalised on its own.
    Any number of parts, each in its own dtype. With one part it is the
    unfused form of :func:`groupnorm_silu` (``fused_gn=False``)."""
    b = parts[0].shape[0]
    hw = parts[0].shape[1] * parts[0].shape[2]
    c = sum(p.shape[-1] for p in parts)
    if c % groups:
        raise ValueError(f"groups={groups} does not divide C={c}")
    sums, sqs = [], []
    for p in parts:
        if p.shape[0] != b or p.shape[1] * p.shape[2] != hw:
            raise ValueError(f"part {tuple(p.shape)} does not match "
                             f"(B={b}, HW={hw})")
        pf = p.reshape(b, hw, p.shape[-1]).float()
        sums.append(pf.sum(1))
        sqs.append((pf * pf).sum(1))
    a_all, b_all = _gn_affine(torch.cat(sums, -1), torch.cat(sqs, -1),
                              hw * (c // groups), scale, bias, groups, eps)
    outs, off = [], 0
    for p in parts:
        cc = p.shape[-1]
        y = torch.addcmul(b_all[:, None, None, off:off + cc], p.float(),
                          a_all[:, None, None, off:off + cc])
        outs.append((y * torch.sigmoid(y)).to(p.dtype))
        off += cc
    return outs


def groupnorm_silu_split(parts, scale, bias, groups: int = 8,
                         eps: float = 1e-5):
    """SiLU(GroupNorm(concat(parts, -1))) without materialising the concat:
    statistics per sample and per group of C / groups channels of the
    concatenation (a group may straddle two parts), each part normalised
    into an output of its own. ``parts`` are one or two NHWC tensors
    (B, H, W, C_p); ``scale`` and ``bias`` (C,) float32 with C the sum of
    the C_p. Returns the list of normalised parts.

    Port of the JAX package's ``groupnorm_silu_split`` (left to the compiler
    there). CUDA parts go through the ``groupnorm_silu`` kernel in one
    launch; CPU parts through :func:`groupnorm_silu_split_ref`.

    Kernel limits, checked on every device: at most two parts, all float32
    or all bfloat16, on one device, each contiguous as (B, H, W, C_p) with
    the same B, H and W; every C_p a multiple of 16 bytes of elements and
    at most 256 such vectors."""
    parts = tuple(parts)
    no_autodiff("groupnorm_silu_split", *parts, scale, bias)
    if not 1 <= len(parts) <= 2:
        raise ValueError(f"groupnorm_silu_split takes one or two parts, got "
                         f"{len(parts)}")
    x = parts[0]
    if x.dim() != 4:
        raise ValueError(f"part 0: expected (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    for i, p in enumerate(parts):
        if p.dim() != 4 or p.shape[:3] != x.shape[:3]:
            raise ValueError(f"part {i}: shape {tuple(p.shape)} does not "
                             f"match part 0's (B, H, W) = "
                             f"{tuple(x.shape[:3])}")
        if p.dtype != x.dtype or p.device != x.device:
            raise ValueError(f"part {i}: {p.dtype} on {p.device}, expected "
                             f"{x.dtype} on {x.device}")
        if not p.is_contiguous():
            raise ValueError(f"part {i} must be contiguous as (B, H, W, C) "
                             f"with C fastest; got strides {p.stride()}")
    c = sum(p.shape[-1] for p in parts)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"parts: dtype {x.dtype} not supported (float32 or "
                         f"bfloat16)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"parts: device {x.device} not supported")
    if groups < 1 or c % groups:
        raise ValueError(f"groups={groups} does not divide C={c}")
    _check("scale", scale, (c,), torch.float32, x.device)
    _check("bias", bias, (c,), torch.float32, x.device)
    _gn_channel_check("groupnorm_silu_split", parts)
    if x.device.type == "cpu":
        return groupnorm_silu_split_ref(parts, scale, bias, groups, eps)
    outs = _gn_launch("groupnorm_silu_split", parts, scale, bias, groups, eps)
    if x.numel():
        groupnorm_silu_split.launches += 1
    return outs


groupnorm_silu_split.launches = 0


# ---------------------------------------------------------------- blend_eps
def blend_eps_ref(eps_stack: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`blend_eps`: the TPU kernel body's order and
    rounding sites (float32 accumulation over the experts in order, one
    division by the float32 weight sum, one rounding to the stack's
    dtype)."""
    acc = torch.zeros(eps_stack.shape[1:], dtype=torch.float32,
                      device=eps_stack.device)
    wsum = torch.zeros((), dtype=torch.float32, device=eps_stack.device)
    for i in range(eps_stack.shape[0]):
        acc = acc + weights[i] * eps_stack[i].float()
        wsum = wsum + weights[i]
    return (acc / wsum).to(eps_stack.dtype)


# threads a block of csrc/blend_eps.cu, one item of the output a thread
_BLEND_THREADS = 256


class BlendRoute(NamedTuple):
    """blend_eps's launch: ``width`` the elements of an item (one 16-byte
    vector, or 1 where the plane's length is not a multiple of it) and
    ``grid`` the blocks, enough to cover the plane's items."""
    width: int
    grid: int


def blend_route(n: int, dtype: torch.dtype) -> BlendRoute:
    """The launch for planes of ``n`` elements of ``dtype``: 16-byte items
    where ``n`` is a multiple of the vector width, single elements
    elsewhere, and the fewest 256-thread blocks that cover them."""
    vec = 16 // dtype.itemsize
    width = vec if n % vec == 0 else 1
    return BlendRoute(width, -(-(n // width) // _BLEND_THREADS))


@functools.cache
def _blend_fn():
    fn = library("blend_eps").blend_eps_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blend_eps(eps_stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_i w_i eps_i / sum_i w_i over the leading expert axis of a
    (K, B, ...) stack: the kernel form of ``compose.weighted``, in the
    stack's dtype. The weights stay on the device; nothing is read back.

    Kernel limits: float32 or bfloat16 stack, contiguous, K >= 1 (any K;
    K <= 4 have their own kernels); the launch is :func:`blend_route`'s;
    ``weights`` a (K,) float32 tensor on the stack's device. The per-sample
    (K, B) weights that ``compose.weighted`` also takes are not the
    kernel's and raise: call ``compose.weighted`` with them."""
    no_autodiff("blend_eps", eps_stack,
                *((weights,) if isinstance(weights, torch.Tensor) else ()))
    if eps_stack.dim() < 2 or eps_stack.shape[0] < 1:
        raise ValueError(f"eps_stack: expected (K, B, ...) with K >= 1, got "
                         f"{tuple(eps_stack.shape)}")
    if eps_stack.dtype not in _DTYPE_CODE:
        raise ValueError(f"eps_stack: dtype {eps_stack.dtype} not supported "
                         f"(float32 or bfloat16)")
    if eps_stack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"eps_stack: device {eps_stack.device} not supported")
    if not eps_stack.is_contiguous():
        raise ValueError("eps_stack must be contiguous")
    k = eps_stack.shape[0]
    if not isinstance(weights, torch.Tensor):
        raise ValueError("weights: expected a (K,) float32 tensor on the "
                         "stack's device")
    if weights.dim() != 1:
        raise ValueError(
            f"weights: shape {tuple(weights.shape)}, expected ({k},); "
            f"per-sample (K, B) weights go through compose.weighted")
    _check("weights", weights, (k,), torch.float32, eps_stack.device)
    if eps_stack.device.type == "cpu":
        return blend_eps_ref(eps_stack, weights)
    out = torch.empty(eps_stack.shape[1:], dtype=eps_stack.dtype,
                      device=eps_stack.device)
    if out.numel() == 0:
        return out
    route = blend_route(out.numel(), eps_stack.dtype)
    rc = _blend_fn()(_DTYPE_CODE[eps_stack.dtype], _ptr(eps_stack),
                     weights.data_ptr(), _ptr(out), out.numel(), k,
                     route.width, route.grid, _stream_ptr(eps_stack))
    if rc:
        raise RuntimeError(f"blend_eps kernel launch failed: CUDA error {rc}")
    blend_eps.launches += 1
    return out


blend_eps.launches = 0


# ------------------------------------------------------------------- matmul
def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`matmul`: float32 product and sum, one
    rounding to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


# matmul's routes and their limits (csrc/matmul.cu)
_MM_ROUTES = {"rows": 0, "small_k": 1, "wgmma": 2, "tiles": 3}
_MM_ROWS_MAX_N = 8     # ROWS_MAXN
_MM_SMALL_K = 8        # SMALL_K_MAX
_MM_WGMMA_MIN_K = 64   # one 64-deep k-tile of bf16


def _major(rows: int, cols: int, rs: int, cs: int):
    """0 when a (rows, cols) operand's rows are contiguous and start on 16
    bytes of bf16 (row stride a multiple of 8), 1 when its columns are,
    None when neither; an extent of 1 takes any stride (as in the kernel's
    ``major_of``)."""
    if (cs == 1 or cols == 1) and (rs % 8 == 0 or rows == 1):
        return 0
    if (rs == 1 or rows == 1) and (cs % 8 == 0 or cols == 1):
        return 1
    return None


def matmul_route(dtype: torch.dtype, m: int, k: int, n: int, a_strides,
                 b_strides, aligned: bool = True) -> str:
    """The kernel route for a (M, K) @ (K, N) product whose operands have
    the given (row, column) element strides; ``aligned``: both data
    pointers on 16 bytes. "rows" for N <= 8 output columns with a's rows
    contiguous (the codec's encode); "small_k" for K <= 8 (the decode);
    "wgmma" for bf16 with K >= 64 and each operand's rows or columns
    contiguous and 16-byte aligned (tensor cores, either major read in
    place); "tiles" for the rest (float32 FMAs on the CUDA cores)."""
    if n <= _MM_ROWS_MAX_N and a_strides[1] == 1:
        return "rows"
    if k <= _MM_SMALL_K:
        return "small_k"
    if (dtype == torch.bfloat16 and k >= _MM_WGMMA_MIN_K and aligned
            and _major(m, k, *a_strides) is not None
            and _major(k, n, *b_strides) is not None):
        return "wgmma"
    return "tiles"


@functools.cache
def _matmul_fn():
    fn = library("matmul").matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (M, K) and b (K, N): float32 accumulation, the result
    (M, N) contiguous in a's dtype. The PCA codec's encode and decode
    product.

    Kernel limits: float32 or bfloat16, both operands alike and on one
    device; any M, N, K and any strides (a transposed view is read in
    place, a contiguous one is read faster). The TPU function's ``tile_m``
    and ``tile_n`` are not kept: :func:`matmul_route` picks the kernel
    route from the dtype, shape and strides."""
    no_autodiff("matmul", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} are not (M, K) and (K, N)")
    if a.dtype not in _DTYPE_CODE:
        raise ValueError(f"a: dtype {a.dtype} not supported (float32 or "
                         f"bfloat16)")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a: device {a.device} not supported")
    if b.dtype != a.dtype or b.device != a.device:
        raise ValueError(f"b: {b.dtype} on {b.device}, expected {a.dtype} on "
                         f"{a.device}")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m * n == 0:
        return out
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul: a dimension of {(m, k, n)} exceeds int32")
    route = matmul_route(a.dtype, m, k, n, a.stride(), b.stride(),
                         (a.data_ptr() | b.data_ptr()) % 16 == 0)
    rc = _matmul_fn()(_DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), m, n, k, a.stride(0), a.stride(1),
                      b.stride(0), b.stride(1), _MM_ROUTES[route],
                      _stream_ptr(a))
    if rc:
        raise RuntimeError(f"matmul kernel launch failed ({route} route): "
                           f"CUDA error {rc}")
    matmul.launches += 1
    return out


matmul.launches = 0
