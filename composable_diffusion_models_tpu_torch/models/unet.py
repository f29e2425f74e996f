"""Score UNet: eps_hat(x_t, t [, labels...]) over NHWC images.

Port of ``composable_diffusion_models_tpu.models.unet``. Same parameter
tree as the flax ``UNet`` after ``convert.from_flax`` and
``convert.unet_torch_layout`` (conv kernels HWIO -> OIHW once at load,
stored under ``weight``). Public shapes are NHWC as in the JAX package;
every activation is a contiguous (B, H, W, C) tensor, which is what the
``groupnorm_silu`` kernel reads, and the convolutions see it as a
channels-last NCHW view without a copy.

Compute-dtype rules follow flax: parameters are cast to ``dtype`` at use
(``None``: the input's dtype), GroupNorm + SiLU and LayerNorm take their
statistics in float32 and return ``dtype``, the output head accumulates
and returns float32.

The JAX flag ``use_pallas`` is ``fused_gn`` here: ``True`` runs GroupNorm +
SiLU through the ``groupnorm_silu`` kernel, and the up blocks' two-part
``concat([x, skip])`` form through the same kernel by way of
``groupnorm_silu_split`` (their plain versions on CPU tensors); ``False``
runs both through the PyTorch-op composition
(``groupnorm_silu_split_ref``), the counterpart of the JAX package's XLA
branch, and launches no GroupNorm kernel. ``flash_attn`` keeps its name: ``True`` routes the
cross-attention through the ``flash_attention`` kernel, ``False`` through
two einsums.

Tensor parallelism: :meth:`UNet.apply` takes the layout of a
tensor-parallel call as ``tp`` (``parallel.tp.make_tp_apply`` passes it)
and runs every parameterised layer through it, so that a layer whose
weight is this rank's slice of the output channels computes that slice
and the layout gathers the rest; with ``tp=None`` (every other caller)
each layer computes all of its channels.

Training: :meth:`UNet.apply` is differentiable with ``fused_gn=False`` (no
kernel has a backward; the GroupNorm wrappers refuse inputs that require
grad). ``train=True`` applies the module's dropout (rate ``dropout``, 0.1)
after each residual block's second GroupNorm + SiLU, as flax's
``nn.Dropout``: keep with probability 1 - rate, kept values divided by it,
the masks drawn from the caller's ``torch.Generator``. No caller in the JAX
package trains with it; every UNet there trains with dropout off.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.kernels import (groupnorm_silu, groupnorm_silu_split,
                           groupnorm_silu_split_ref)
from .embeddings import time_embedding


@functools.lru_cache(maxsize=None)
def _interp_matrix(n: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """(2n, n) bilinear 2x interpolation matrix with half-pixel centres
    (``align_corners=False``), rows renormalised at the edges: what
    ``jax.image.resize(eye(n), (2n, n), "linear")`` returns. Built once per
    size, device and dtype (no host-to-device copy inside the sampler
    loop)."""
    pos = (np.arange(2 * n, dtype=np.float64) + 0.5) / 2.0 - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(pos[:, None] - np.arange(n)[None, :]))
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    # a normal tensor even when first built by a forward in inference mode:
    # a later training forward saves it for its backward
    with torch.inference_mode(False):
        return torch.from_numpy(w).to(device, dtype)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, NHWC, as two small matmuls in x's dtype (the
    intermediate is rounded to x's dtype after the first, as in the JAX
    package)."""
    b, h, w, c = x.shape
    mh = _interp_matrix(h, x.device, x.dtype)
    mw = _interp_matrix(w, x.device, x.dtype)
    y = torch.matmul(mh, x.reshape(b, h, w * c))            # (B, 2H, W*C)
    y = torch.matmul(mw, y.reshape(b * 2 * h, w, c))        # (B*2H, 2W, C)
    return y.reshape(b, 2 * h, 2 * w, c)


def _maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, NHWC; an odd trailing row or column is
    dropped (VALID padding)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _gn_groups(channels: int, preferred: int = 8) -> int:
    """Largest group count <= preferred that divides the channel count."""
    for g in (preferred, 4, 2, 1):
        if channels % g == 0:
            return g
    return 1


def _layer(tp, weight: torch.Tensor, fn, *xs) -> torch.Tensor:
    """``fn(*xs)``: the layer whose output channels ``weight`` holds, run
    through the tensor-parallel layout ``tp`` where there is one."""
    return fn(*xs) if tp is None else tp.layer(weight, fn, *xs)


def _whole(tp, leaf: torch.Tensor) -> torch.Tensor:
    """A norm's per-channel parameter with all of its channels."""
    return leaf if tp is None else tp.whole(leaf)


def _dense(v, p, dtype, tp=None):
    bias = p["bias"].to(dtype) if "bias" in p else None
    w = p["kernel"]
    return _layer(tp, w, lambda v: F.linear(v.to(dtype), w.to(dtype).t(),
                                            bias), v)


def _conv(x: torch.Tensor, weight: torch.Tensor, bias, dtype,
          tp=None) -> torch.Tensor:
    """'SAME' stride-1 convolution of an NHWC tensor with an OIHW weight;
    returns a contiguous NHWC tensor."""
    def conv(x):
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
                     None if bias is None else bias.to(dtype),
                     padding=weight.shape[-1] // 2)
        return y.permute(0, 2, 3, 1).contiguous()
    return _layer(tp, weight, conv, x)


def _split_conv(parts, p, dtype, tp=None) -> torch.Tensor:
    """Convolution over a tuple of inputs treated as one channel-
    concatenated tensor: the kernel is split along its input-channel axis
    and the partial outputs are summed."""
    def conv(*parts):
        out, off = None, 0
        for i, part in enumerate(parts):
            cc = part.shape[-1]
            y = _conv(part, p["weight"][:, off:off + cc],
                      p["bias"] if i == len(parts) - 1 else None, dtype)
            out = y if out is None else out + y
            off += cc
        return out
    return _layer(tp, p["weight"], conv, *parts)


def gn_silu(p, x, dtype, fused_gn: bool, tp=None):
    """GroupNorm + SiLU with parameters ``p`` ({scale, bias}); a tuple input
    is normalised as if concatenated on channels (never materialised) and
    returned as a tuple."""
    scale = _whole(tp, p["scale"]).float()
    bias = _whole(tp, p["bias"]).float()
    if isinstance(x, (tuple, list)):
        groups = _gn_groups(sum(part.shape[-1] for part in x))
        split = groupnorm_silu_split if fused_gn else groupnorm_silu_split_ref
        outs = split(x, scale, bias, groups=groups)
        return tuple(o.to(dtype) for o in outs)
    groups = _gn_groups(x.shape[-1])
    if fused_gn:
        return groupnorm_silu(x, scale, bias, groups=groups).to(dtype)
    return groupnorm_silu_split_ref((x,), scale, bias,
                                    groups=groups)[0].to(dtype)


def dropout(h: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: each element kept with probability
    1 - rate (a uniform draw below it) and divided by it, else 0."""
    if rate <= 0.0:
        return h
    keep_prob = 1.0 - rate
    keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype,
                                                        device=h.device))


def res_block(p, x, t_emb, dtype, fused_gn: bool, skip=None,
              drop=None, tp=None) -> torch.Tensor:
    """GN+SiLU+3x3 conv -> + time projection -> GN+SiLU (-> ``drop``, the
    training dropout) -> 3x3 conv -> + residual (1x1 conv where the width
    changes). ``skip`` is treated as concat([x, skip], -1) without
    materialising the concat."""
    parts = (x,) if skip is None else (x, skip)
    hn = gn_silu(p["gn1"], parts if skip is not None else x, dtype, fused_gn,
                 tp)
    if skip is None:
        h = _conv(hn, p["Conv_0"]["weight"], p["Conv_0"]["bias"], dtype, tp)
    else:
        h = _split_conv(hn, p["Conv_0"], dtype, tp)
    temb = _dense(F.silu(t_emb), p["Dense_0"], dtype, tp)
    h = h + temb[:, None, None, :]
    h = gn_silu(p["gn2"], h, dtype, fused_gn, tp)
    if drop is not None:
        h = drop(h)
    h = _conv(h, p["Conv_1"]["weight"], p["Conv_1"]["bias"], dtype, tp)
    if "Conv_2" not in p:  # the width does not change
        if skip is not None:
            raise ValueError("skip input requires a channel-changing block")
        return h + x
    if skip is None:
        return h + _conv(x, p["Conv_2"]["weight"], p["Conv_2"]["bias"], dtype,
                         tp)
    return h + _split_conv(parts, p["Conv_2"], dtype, tp)


def _layer_norm(p, x, dtype, tp=None) -> torch.Tensor:
    """flax LayerNorm: float32 one-pass statistics clamped at 0, eps 1e-6,
    affine in float32, one rounding to ``dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + 1e-6) * _whole(tp, p["scale"]).float()
    return ((xf - mean) * mul + _whole(tp, p["bias"]).float()).to(dtype)


def cross_attention(p, x, context, num_heads: int, dtype,
                    use_flash: bool, tp=None) -> torch.Tensor:
    """Residual multi-head cross-attention from the HW image tokens of ``x``
    (B, H, W, C) to ``context`` (B, S, E). ``use_flash=True`` runs the
    ``flash_attention`` kernel (float32 probabilities); ``False`` the two
    einsums, whose probabilities are rounded to v's dtype."""
    b, h, w, c = x.shape
    head_dim = c // num_heads
    tokens_n = _layer_norm(p["LayerNorm_0"], x.reshape(b, h * w, c), dtype,
                           tp)
    q = _dense(tokens_n, p["Dense_0"], dtype, tp)
    k = _dense(context, p["Dense_1"], dtype, tp)
    v = _dense(context, p["Dense_2"], dtype, tp)
    q, k, v = (z.reshape(b, z.shape[1], num_heads, head_dim)
               for z in (q, k, v))
    if use_flash:
        # (B, N, heads, hd) seen as (B, heads, N, hd): strided views, which
        # the kernel reads through their strides
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
        out = out.transpose(1, 2).reshape(b, h * w, c)
    else:
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k).float()
                  / math.sqrt(head_dim))
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, h * w, c)
    return x + _dense(out, p["Dense_3"], dtype, tp).reshape(b, h, w, c)


@dataclasses.dataclass(frozen=True)
class UNet:
    """Configuration of the score UNet (the flax module's fields, with
    ``use_pallas`` named ``fused_gn``) and its forward, :meth:`apply`."""

    in_channels: int = 1
    base_dim: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    time_emb_dim: int = 256
    num_classes: Tuple[int, ...] = ()
    null_token: bool = False
    dropout: float = 0.1
    cross_attn: bool = False
    flash_attn: bool = False
    attn_heads: int = 4
    out_channels: Optional[int] = None
    dtype: Optional[torch.dtype] = None
    fused_gn: bool = False
    pad_to: Optional[int] = None

    def apply(self, params: Any, x: torch.Tensor, t, *labels,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              tp=None) -> torch.Tensor:
        """eps_hat for NHWC ``x`` (B, H, W, C), ``t`` a scalar or (B,), one
        integer (B,) label per slot of ``num_classes``; float32 output.
        ``train=True`` applies the dropout, its masks drawn from
        ``generator`` (a ``torch.Generator`` on x's device). ``tp``: the
        layout of a tensor-parallel call, with ``params`` this rank's shard
        (``parallel.tp.make_tp_apply``)."""
        p = params["params"]
        if x.dim() != 4:
            raise ValueError(f"expected NHWC input, got {tuple(x.shape)}")
        drop = None
        if train and self.dropout > 0.0:
            if generator is None:
                raise ValueError("train=True draws dropout masks: pass a "
                                 "torch.Generator")
            drop = functools.partial(dropout, rate=self.dropout,
                                     generator=generator)
        dtype = self.dtype or x.dtype
        orig_hw = tuple(x.shape[1:3])
        padded = bool(self.pad_to) and orig_hw != (self.pad_to, self.pad_to)
        if padded:
            ph, pw = self.pad_to - orig_hw[0], self.pad_to - orig_hw[1]
            if ph < 0 or pw < 0:
                raise ValueError("pad_to smaller than the input")
            # centre the content on the canvas
            x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        t = torch.as_tensor(t, device=x.device)
        if t.dim() == 0:
            # batch-constant t: the time tower runs at batch 1 and the
            # (1, C) + (B, H, W, C) broadcast does the rest
            t = t[None]
        t_emb = time_embedding(p["TimeEmbedding_0"], t, self.base_dim, dtype,
                               tp)

        context = None
        if self.num_classes:
            if len(labels) != len(self.num_classes):
                raise ValueError(f"model takes {len(self.num_classes)} label "
                                 f"slots, got {len(labels)}")
            tables = [p[f"label_emb_{i}"]["embedding"]
                      for i in range(len(labels))]
            embs = [_layer(tp, tab, lambda i, tab=tab: F.embedding(
                        i, tab.to(dtype)),
                        torch.as_tensor(lab, device=x.device).long())
                    for tab, lab in zip(tables, labels)]
            if self.cross_attn:
                context = torch.stack(embs, dim=1)  # (B, n_slots, emb)
            else:
                t_emb = t_emb + sum(embs)

        def block(name, h, skip=None):
            return res_block(p[name], h, t_emb, dtype, self.fused_gn, skip,
                             drop, tp)

        def attend(name, h):
            if context is None:
                return h
            return cross_attention(p[name], h, context, self.attn_heads,
                                   dtype, self.flash_attn, tp)

        n_levels = len(self.channel_mults) - 1
        h = _conv(x, p["init_conv"]["weight"], p["init_conv"]["bias"], dtype,
                  tp)
        skips = []
        for i in range(n_levels):
            h = attend(f"down_attn_{i}", block(f"down_{i}", h))
            skips.append(h)
            h = _maxpool2x(h)
        h = attend("bot_attn", block("bottleneck", h))
        for i in reversed(range(n_levels)):
            h = block(f"up_{i}", _upsample2x(h), skip=skips[i])
            h = attend(f"up_attn_{i}", h)

        # output head: 1x1 conv as a matmul of the compute-dtype operands
        # with a float32 result that is never rounded to the compute dtype
        w_head = p["out_conv"]["weight"]
        w_out = w_head[:, :, 0, 0].to(dtype).float()
        out = _layer(tp, w_head, lambda h: h.float() @ w_out.t()
                     + p["out_conv"]["bias"].float(), h)
        if padded:
            out = out[:, ph // 2:ph // 2 + orig_hw[0],
                      pw // 2:pw // 2 + orig_hw[1], :]
        return out
