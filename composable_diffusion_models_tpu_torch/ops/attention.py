"""Blockwise (flash) attention: the kernel's wrapper and its plain version.

Port of ``composable_diffusion_models_tpu.ops.attention.flash_attention``.
The kernel (``csrc/flash_attention.cu``) is hand-written CUDA C++ for
Hopper, built at first use and called through ctypes. On CPU tensors the
wrapper returns the plain version; on CUDA tensors it launches the kernel
on the current stream, raises if the launch fails, and adds one to its
``launches`` count. A CUDA tensor never takes the plain version, and no
input may require grad or carry a tangent (``kernels.no_autodiff``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import library
from .kernels import _DTYPE_CODE, _ptr, _stream_ptr, no_autodiff

_HEAD_DIMS = (16, 32, 64, 128, 256)
_FA_WGMMA_MAX_D = 128  # widest head of the wgmma route
# flash_attention's routes and the limits that pick them (measured on the
# card: chip_smoke.py times every route over Nk at path B's widest site and
# at a long-query shape)
_FA_ROUTES = {"short": 0, "tiles": 1, "wgmma": 2}
_FA_SHORT_NK = 4         # most keys the short route is picked for
_FA_SHORT_ROW = 64       # longest query row (bytes) it is picked for
_FA_WGMMA_MIN_KD = 2048  # Nk * D from which the tensor cores win
_FA_THREADS = 128        # the short route's block: H <= 128 threads


def flash_attention_ref(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention`, at the TPU kernel's
    rounding sites: q, k, v widened to float32, q scaled before the score
    product, float32 softmax, probabilities not rounded, one rounding of
    the output to q's dtype."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                        v.float()).to(q.dtype)


def flash_route(dtype: torch.dtype, n_heads: int, nk: int, d: int,
                strides) -> str:
    """The kernel route for ``n_heads`` heads of width ``d``, ``nk`` keys
    and the 12 (batch, head, row) element strides of q, k, v and out
    (every pointer is 16-byte aligned: the wrapper checks). "short" for
    nk <= 4 where a query row is at most 64 bytes and the heads fit one
    block of 128 threads (the UNet's label context: a block spans the heads
    of a run of tokens, so the 2-4 rows that share a 128-byte line are read
    by one warp; a longer row fills its own lines, and there the tiles
    route's one (batch, head) a block is faster); "wgmma" for bfloat16 from
    nk * d >= 2048 on, where q, k and v strides are multiples of 8 (16-byte
    rows, and d <= 128: both products on the tensor cores, fp32 operands
    split into two bf16 terms); "tiles" for the rest (float32 FMAs on the
    CUDA cores, K and V through shared memory; the only route at d = 256)."""
    row = d * dtype.itemsize
    if (nk <= _FA_SHORT_NK and row <= _FA_SHORT_ROW
            and n_heads <= _FA_THREADS):
        return "short"
    if (dtype == torch.bfloat16 and nk * d >= _FA_WGMMA_MIN_KD
            and d <= _FA_WGMMA_MAX_D
            and all(s % 8 == 0 for s in strides[:9])):
        return "wgmma"
    return "tiles"


@functools.cache
def _flash_fn():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _row_strides(name: str, t: torch.Tensor) -> tuple:
    """(batch, head, row) element strides of a (B, H, N, D) tensor whose
    last axis is dense; the kernel moves 4 elements at a time."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last axis must have stride 1, got "
                         f"strides {t.stride()}; make the copy explicit "
                         f"with .contiguous()")
    for dim in range(3):
        if t.shape[dim] > 1 and t.stride(dim) % 4:
            raise ValueError(f"{name}: stride {t.stride(dim)} of axis {dim} "
                             f"is not a multiple of 4 elements")
    return tuple(t.stride(dim) for dim in range(3))


def flash_head_dim(d: int) -> int:
    """The head width the kernel runs a head of width ``d`` at: the next of
    (16, 32, 64, 128, 256), the wrapper padding q, k and v with zero
    columns up to it (zero columns add nothing to q k^T, and the output's
    extra columns are dropped). Raises for D > 256, which the kernel does
    not take (the TPU kernel pads any D to a multiple of 128)."""
    for width in _HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"flash_attention: head width D={d} > {_HEAD_DIMS[-1]} "
                     f"is not supported by the kernel")


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over q (B, H, Nq, D) and k, v (B, H, Nk, D),
    any Nq and Nk >= 1; ``scale`` defaults to 1 / sqrt(D). float32 scores,
    softmax and accumulator; the result has q's shape and dtype, and on
    the card q's memory layout when q is dense (a (B, N, H, D) tensor
    transposed to (B, H, N, D) gives an output that transposes back
    without a copy).

    Kernel limits: float32 or bfloat16, D <= 256 (checked on every device;
    a D other than 16, 32, 64, 128 or 256 runs padded with zero columns to
    the next of them, :func:`flash_head_dim`, the scale still 1 / sqrt(D),
    and its result comes back in a new tensor with q's layout); strided views
    are read through their strides (last axis dense, the other strides
    multiples of 4 elements, 16-byte aligned), never as if contiguous.
    :func:`flash_route` picks the kernel route from the dtype, H, Nk, the
    padded D and the strides."""
    no_autodiff("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected (B, H, N, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported (float32 or "
                         f"bfloat16)")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {q.device} not supported")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if tuple(k.shape) != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if nk < 1:
        raise ValueError("flash_attention needs at least one key")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    width = flash_head_dim(d)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale)
    if width != d:
        out = flash_attention(*(F.pad(t, (0, width - d)) for t in (q, k, v)),
                              scale=scale)
        return torch.empty_like(q).copy_(out[..., :d])
    out = torch.empty_like(q)  # q's strides when q is dense
    if q.numel() == 0:
        return out
    strides = sum((_row_strides(name, t) for name, t in
                   (("q", q), ("k", k), ("v", v), ("out", out))), ())
    route = flash_route(q.dtype, h, nk, d, strides)
    rc = _flash_fn()(_DTYPE_CODE[q.dtype], _ptr(q), _ptr(k), _ptr(v),
                     _ptr(out), b, h, nq, nk, d,
                     (ctypes.c_longlong * 12)(*strides), float(scale),
                     _FA_ROUTES[route], _stream_ptr(q))
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed ({route} "
                           f"route): CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
