"""Diffusion Transformer (DiT), folded serving path.

Port of ``composable_diffusion_models_tpu.models.dit.make_folded_apply``
(``fold_ln=False``). In every sampler step the time input, and in
composition every label, is batch-constant, so each block's six adaLN
vectors (shift, scale, gate) x (attention, MLP) are per-step constants and
fold into the adjacent GEMMs:

  (LN(x) * (1+scale) + shift) @ W + b  ==  LN(x) @ (W * (1+scale)[:,None])
                                           + (b + shift @ W)
  x + gate * (h @ Wp + bp)             ==  x + h @ (Wp * gate[None,:])
                                           + bp * gate

The folded block then runs as one ``fused_dit_block`` kernel, or, with
``fused_block=False``, as LayerNorm + GEMMs around the
``short_seq_attention`` kernel. Same parameter tree as the flax ``DiT``
(both the fused-QKV and the stock multi-head attention layouts), converted
with ``convert.from_flax``. Images are NHWC; ``apply(params, x, t,
*labels)`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels import fused_dit_block, ln_f32, short_seq_attention
from .embeddings import sinusoidal_embedding


@dataclasses.dataclass(frozen=True)
class DiT:
    """Configuration of a DiT (the flax module's fields).

    ``qkv_fused`` selects the attention parameter layout that
    ``convert.init_params`` builds (both layouts are served);
    ``img_size`` fixes the number of tokens (the learned positional
    embedding ties a checkpoint to one image size). ``dtype`` is the compute
    dtype; None computes in the input's dtype."""

    patch: int = 4
    dim: int = 256
    depth: int = 6
    n_heads: int = 8
    in_channels: int = 1
    num_classes: Tuple[int, ...] = ()
    null_token: bool = False
    qkv_fused: bool = False
    img_size: int = 28
    dtype: Optional[torch.dtype] = None

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2


def _attn_kernels(bp, dim: int):
    """(Wqkv, bqkv, Wproj, bproj) from either attention parameter layout:
    the fused-QKV tree stores them directly; the stock multi-head tree keeps
    per-head (D, H, hd) kernels, concatenated here in [q | k | v] order."""
    if "FusedQKVAttention_0" in bp:
        a = bp["FusedQKVAttention_0"]
        return (a["qkv"]["kernel"], a["qkv"]["bias"],
                a["proj"]["kernel"], a["proj"]["bias"])
    a = bp["MultiHeadDotProductAttention_0"]
    w_qkv = torch.cat(
        [a[k]["kernel"].reshape(dim, -1) for k in ("query", "key", "value")],
        dim=1)
    b_qkv = torch.cat(
        [a[k]["bias"].reshape(-1) for k in ("query", "key", "value")])
    return w_qkv, b_qkv, a["out"]["kernel"].reshape(-1, dim), a["out"]["bias"]


def _batch1(name: str, arr) -> torch.Tensor:
    arr = torch.as_tensor(arr)
    if arr.dim() == 0:
        arr = arr[None]
    if arr.shape[0] != 1:
        raise ValueError(
            f"folded DiT requires batch-constant conditioning: {name} has "
            f"leading dim {arr.shape[0]}, expected 1 (per-sample modulation "
            f"vectors cannot fold into shared GEMM weights)")
    return arr


def make_folded_apply(model: DiT, fused_block: bool = True):
    """``apply(params, x, t, *labels)`` computing the DiT forward with the
    per-step adaLN fold; t and every label must be batch-size 1.

    ``fused_block=True`` runs each whole block as the ``fused_dit_block``
    kernel; ``False`` runs LayerNorm and the GEMMs in PyTorch around the
    ``short_seq_attention`` kernel. On CPU tensors both kernels take their
    plain versions."""

    def apply(params: Any, x: torch.Tensor, t, *labels) -> torch.Tensor:
        p = params["params"]
        d, patch, cin = model.dim, model.patch, model.in_channels
        b, hh, ww, _ = x.shape
        if hh % patch or ww % patch:
            raise ValueError(f"img {hh}x{ww} not divisible by patch {patch}")
        gh, gw = hh // patch, ww // patch
        n_tok = gh * gw
        cdt = model.dtype or x.dtype

        def dense(v, dp, dt=cdt):
            return v.to(dt) @ dp["kernel"].to(dt) + dp["bias"].to(dt)

        # conditioning vector (1, D): time + summed batch-constant labels
        t1 = _batch1("t", t).to(x.device)
        te = p["TimeEmbedding_0"]
        c = dense(F.silu(dense(sinusoidal_embedding(t1, d), te["Dense_0"])),
                  te["Dense_1"])
        if model.num_classes and len(labels) != len(model.num_classes):
            raise ValueError(f"model takes {len(model.num_classes)} label "
                             f"slots, got {len(labels)}")
        for i in range(len(model.num_classes)):
            lab = _batch1(f"label {i}", labels[i]).to(x.device).long()
            c = c + p[f"label_emb_{i}"]["embedding"].to(cdt)[lab]
        sc = F.silu(c)

        # patchify as GEMM: (B, N, p*p*C) x (p*p*C, D); the HWIO kernel
        # flattens in (ph, pw, C) order
        w_pat = p["patchify"]["kernel"].reshape(patch * patch * cin, d)
        xp = x.to(cdt).reshape(b, gh, patch, gw, patch, cin)
        xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(b, n_tok,
                                                  patch * patch * cin)
        tok = (xp @ w_pat.to(cdt) + p["patchify"]["bias"].to(cdt)
               + p["pos_emb"].to(cdt))

        for i in range(model.depth):
            bp = p[f"block_{i}"]
            mod = dense(sc, bp["Dense_0"])[0]  # (6D,) per-step constants
            (sa_shift, sa_scale, sa_gate,
             m_shift, m_scale, m_gate) = mod.chunk(6)
            # the bias correction uses the unfolded weight, in cdt
            w_qkv, b_qkv, w_pr, b_pr = (
                v.to(cdt) for v in _attn_kernels(bp, d))
            w1, b1 = bp["Dense_1"]["kernel"].to(cdt), bp["Dense_1"]["bias"].to(cdt)
            w2, b2 = bp["Dense_2"]["kernel"].to(cdt), bp["Dense_2"]["bias"].to(cdt)
            w_qkv_f = w_qkv * (1.0 + sa_scale)[:, None]
            b_qkv_f = b_qkv + sa_shift @ w_qkv
            w_pr_f, b_pr_f = w_pr * sa_gate[None, :], b_pr * sa_gate
            w1_f = w1 * (1.0 + m_scale)[:, None]
            b1_f = b1 + m_shift @ w1
            w2_f, b2_f = w2 * m_gate[None, :], b2 * m_gate

            if fused_block:
                tok = fused_dit_block(tok, w_qkv_f, b_qkv_f, w_pr_f, b_pr_f,
                                      w1_f, b1_f, w2_f, b2_f, model.n_heads)
                continue
            qkv = ln_f32(tok) @ w_qkv_f + b_qkv_f
            o = short_seq_attention(qkv, model.n_heads)
            tok = tok + (o @ w_pr_f + b_pr_f)
            h = F.gelu(ln_f32(tok) @ w1_f + b1_f, approximate="tanh")
            tok = tok + (h @ w2_f + b2_f)

        # final adaLN folded into the fp32 unpatchify head
        fmod = dense(sc, p["final_mod"])[0].float()
        f_shift, f_scale = fmod.chunk(2)
        w_u = p["unpatchify"]["kernel"].float()
        out = (ln_f32(tok).float() @ (w_u * (1.0 + f_scale)[:, None])
               + (p["unpatchify"]["bias"].float() + f_shift @ w_u))
        out = out.reshape(b, gh, gw, patch, patch, cin)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, cin)

    return apply
