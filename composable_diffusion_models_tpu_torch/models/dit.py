"""Diffusion Transformer (DiT): the training forward and the folded serving
path.

Port of ``composable_diffusion_models_tpu.models.dit``, over the flax
``DiT``'s parameter tree (converted with ``convert.from_flax``; both the
fused-QKV and the stock multi-head attention layouts). Images are NHWC;
``apply(params, x, t, *labels)`` as in the JAX package.

* :meth:`DiT.apply` is the flax module's forward (``DiT.__call__``):
  differentiable, the one the trainer runs. It computes in the
  configuration's ``dtype`` at flax's cast sites: every Dense casts its
  input, kernel and bias to the dtype (parameters stay float32), the
  LayerNorms are float32 without affine (eps 1e-6) cast back, the GELU is
  the tanh form, the unpatchify head is float32. ``pallas_attn=True`` runs
  the fused-QKV attention core through the ``short_seq_attention`` kernel,
  which has no backward: inference only, and it raises under autograd.
* :func:`make_folded_apply` is the serving path. In every sampler step the
  time input, and in composition every label, is batch-constant, so each
  block's six adaLN vectors (shift, scale, gate) x (attention, MLP) are
  per-step constants and fold into the adjacent GEMMs:

    (LN(x) * (1+scale) + shift) @ W + b  ==  LN(x) @ (W * (1+scale)[:,None])
                                             + (b + shift @ W)
    x + gate * (h @ Wp + bp)             ==  x + h @ (Wp * gate[None,:])
                                             + bp * gate

  The folded block then runs as one ``fused_dit_block`` kernel, or, with
  ``fused_block=False``, as LayerNorm + GEMMs around the
  ``short_seq_attention`` kernel (or, with ``pallas_attn=False``, around
  the attention's einsum chain); ``fold_ln=True`` also folds the
  LayerNorm's normalisation into the GEMMs' epilogue.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels import fused_dit_block, ln_f32, short_seq_attention
from ..utils.profiling import annotate
from .embeddings import sinusoidal_embedding


@dataclasses.dataclass(frozen=True)
class DiT:
    """Configuration of a DiT (the flax module's fields).

    ``qkv_fused`` selects the attention parameter layout (the trainer's
    forward runs the one it names; the folded path serves both);
    ``img_size`` fixes the number of tokens (the learned positional
    embedding ties a checkpoint to one image size). ``dtype`` is the compute
    dtype; None computes in float32 in :meth:`apply` (flax promotes to the
    float32 parameters) and in the input's dtype in the folded path.
    ``pallas_attn`` routes :meth:`apply`'s fused-QKV attention through the
    ``short_seq_attention`` kernel (inference only)."""

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
    pallas_attn: bool = False

    @property
    def n_tokens(self) -> int:
        return (self.img_size // self.patch) ** 2

    def apply(self, params: Any, x: torch.Tensor, t, *labels) -> torch.Tensor:
        """The flax ``DiT.__call__``: patchify (as a GEMM over HWIO-ordered
        patches), learned positions, ``depth`` adaLN-Zero blocks, the final
        adaLN and the float32 unpatchify head. ``t`` is a scalar or (B,);
        each label (B,) or batch-1 integer ids. Differentiable."""
        p = params["params"]
        b, hh, ww, cin = x.shape
        patch, d = self.patch, self.dim
        if hh % patch or ww % patch:
            raise ValueError(f"img {hh}x{ww} not divisible by patch {patch}")
        gh, gw = hh // patch, ww // patch
        n_tok = gh * gw
        dt = self.dtype

        t = torch.as_tensor(t, device=x.device)
        if t.dim() == 0:
            t = t[None]  # a batch-constant scalar t, as the samplers pass
        te = p["TimeEmbedding_0"]
        c = _dense(F.silu(_dense(sinusoidal_embedding(t, d), te["Dense_0"],
                                 dt)), te["Dense_1"], dt)
        if len(labels) != len(self.num_classes):
            raise ValueError(f"model takes {len(self.num_classes)} label "
                             f"slots, got {len(labels)}")
        for i, lab in enumerate(labels):
            emb = p[f"label_emb_{i}"]["embedding"]
            lab = torch.as_tensor(lab, device=x.device).long()
            c = c + emb.to(dt or emb.dtype)[lab]

        cdt = dt or torch.promote_types(x.dtype, p["patchify"]["kernel"].dtype)
        xp = x.to(cdt).reshape(b, gh, patch, gw, patch, cin)
        xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(b, n_tok,
                                                  patch * patch * cin)
        w_pat = p["patchify"]["kernel"].reshape(patch * patch * cin, d)
        tok = xp @ w_pat.to(cdt) + p["patchify"]["bias"].to(cdt)
        tok = tok + p["pos_emb"].to(tok.dtype)

        for i in range(self.depth):
            tok = self._block(p[f"block_{i}"], tok, c)

        shift, scale = _dense(F.silu(c), p["final_mod"], dt).chunk(2, dim=-1)
        tok = _modulate(ln_f32(tok), shift, scale)
        out = _dense(tok.float(), p["unpatchify"], torch.float32)
        out = out.reshape(b, gh, gw, patch, patch, cin)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, cin)

    def _block(self, bp, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """Pre-LN block with adaLN-Zero modulation (flax ``DiTBlock``)."""
        dt = self.dtype
        (sa_shift, sa_scale, sa_gate, m_shift, m_scale,
         m_gate) = _dense(F.silu(c), bp["Dense_0"], dt).chunk(6, dim=-1)
        h = _modulate(ln_f32(x), sa_shift, sa_scale)
        h = self._attention(bp, h)
        x = x + sa_gate[:, None, :] * h
        h = _modulate(ln_f32(x), m_shift, m_scale)
        h = F.gelu(_dense(h, bp["Dense_1"], dt), approximate="tanh")
        h = _dense(h, bp["Dense_2"], dt)
        return x + m_gate[:, None, :] * h

    def _attention(self, bp, h: torch.Tensor) -> torch.Tensor:
        """Self-attention over (B, T, D): the fused-QKV module (fp32 softmax
        statistics, probabilities rounded to h's dtype) or flax's stock
        multi-head attention (q scaled before the product, softmax in the
        compute dtype)."""
        dt = self.dtype
        b, n, d = h.shape
        nh = self.n_heads
        hd = d // nh
        if "FusedQKVAttention_0" in bp:
            a = bp["FusedQKVAttention_0"]
            qkv = _dense(h, a["qkv"], dt)
            if self.pallas_attn:
                if torch.is_grad_enabled() and qkv.requires_grad:
                    raise RuntimeError(
                        "pallas_attn=True is inference-only: the "
                        "short_seq_attention kernel has no backward; train "
                        "with pallas_attn=False")
                out = short_seq_attention(qkv, nh)
            else:
                out = einsum_attention(qkv, nh, h.dtype)
            return _dense(out, a["proj"], dt)
        if self.pallas_attn:
            raise ValueError("pallas_attn needs the fused-QKV layout "
                             "(qkv_fused=True)")
        a = bp["MultiHeadDotProductAttention_0"]
        q, k, v = (_dense(h, {"kernel": a[name]["kernel"].reshape(d, d),
                              "bias": a[name]["bias"].reshape(d)}, dt)
                   .reshape(b, n, nh, hd) for name in ("query", "key", "value"))
        q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, d)
        return _dense(out, {"kernel": a["out"]["kernel"].reshape(d, d),
                            "bias": a["out"]["bias"]}, dt)


def einsum_attention(qkv: torch.Tensor, n_heads: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The fused-QKV attention core in PyTorch ops, from a packed (B, T, 3D)
    qkv to (B, T, D): the flax ``FusedQKVAttention``'s einsum chain and the
    JAX ``short_seq_attention``'s non-Pallas branch. The scores in qkv's
    dtype, divided by sqrt(hd) in ``dtype``; the softmax in float32; the
    probabilities rounded to ``dtype`` before the value product."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // n_heads
    q, k, v = qkv.reshape(b, n, 3, n_heads, hd).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(float(hd), dtype=dtype))
    w = torch.softmax(s.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, d)


def _dense(v: torch.Tensor, dp, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense``: input, kernel and bias cast to ``dtype`` (None:
    their promoted type), the bias added to the rounded product."""
    dt = dtype or torch.promote_types(v.dtype, dp["kernel"].dtype)
    return v.to(dt) @ dp["kernel"].to(dt) + dp["bias"].to(dt)


def _modulate(x: torch.Tensor, shift: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


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


def make_folded_apply(model: DiT, fused_block: bool = True,
                      fold_ln: bool = False, pallas_attn: bool = True):
    """``apply(params, x, t, *labels)`` computing the DiT forward with the
    per-step adaLN fold; t and every label must be batch-size 1.

    ``fused_block=True`` runs each whole block as the ``fused_dit_block``
    kernel; ``False`` runs LayerNorm and the GEMMs in PyTorch around the
    attention core: the ``short_seq_attention`` kernel, or with
    ``pallas_attn=False`` :func:`einsum_attention` (PyTorch ops, as the
    JAX package's non-Pallas route computes it; a bypass the caller asks
    for, never a fallback). ``fold_ln=True`` (which takes the second route
    whatever ``fused_block`` says, as in the JAX package) also folds the
    LayerNorm's normalisation into the GEMM epilogue: with per-row float32
    statistics (mu, sigma) and the column sums s = 1^T W',
    LN(x) @ W' + b' == (x @ W' - mu * s) / sigma + b', the product taken on
    the raw residual stream with float32 accumulation. On CPU tensors both
    kernels take their plain versions."""

    def apply(params: Any, x: torch.Tensor, t, *labels) -> torch.Tensor:
        p = params["params"]
        d, patch, cin = model.dim, model.patch, model.in_channels
        b, hh, ww, _ = x.shape
        if hh % patch or ww % patch:
            raise ValueError(f"img {hh}x{ww} not divisible by patch {patch}")
        gh, gw = hh // patch, ww // patch
        n_tok = gh * gw
        cdt = model.dtype or x.dtype

        with annotate("cdm.dit.embed"):
            # conditioning vector (1, D): time + summed batch-constant labels
            t1 = _batch1("t", t).to(x.device)
            te = p["TimeEmbedding_0"]
            c = _dense(F.silu(_dense(sinusoidal_embedding(t1, d),
                                     te["Dense_0"], cdt)), te["Dense_1"], cdt)
            if model.num_classes and len(labels) != len(model.num_classes):
                raise ValueError(f"model takes {len(model.num_classes)} "
                                 f"label slots, got {len(labels)}")
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

        def ln_gemm(h, w_f, b_f):
            """LN(h) @ w_f + b_f, the normalisation materialised or folded
            into the epilogue (fold_ln)."""
            if not fold_ln:
                return ln_f32(h) @ w_f + b_f
            hf = h.float()
            mu = hf.mean(dim=-1, keepdim=True)
            var = torch.clamp((hf * hf).mean(dim=-1, keepdim=True) - mu * mu,
                              min=0.0)
            g = hf @ w_f.float()  # products exact in float32, fp32 sums
            y = (g - mu * w_f.float().sum(dim=0)) * torch.rsqrt(var + 1e-6)
            return y.to(h.dtype) + b_f

        def fold(bp):
            """One block's per-step folded weights and biases."""
            mod = _dense(sc, bp["Dense_0"], cdt)[0]  # (6D,) per-step consts
            (sa_shift, sa_scale, sa_gate,
             m_shift, m_scale, m_gate) = mod.chunk(6)
            # the bias correction uses the unfolded weight, in cdt
            w_qkv, b_qkv, w_pr, b_pr = (
                v.to(cdt) for v in _attn_kernels(bp, d))
            w1, b1 = bp["Dense_1"]["kernel"].to(cdt), bp["Dense_1"]["bias"].to(cdt)
            w2, b2 = bp["Dense_2"]["kernel"].to(cdt), bp["Dense_2"]["bias"].to(cdt)
            return (w_qkv * (1.0 + sa_scale)[:, None],
                    b_qkv + sa_shift @ w_qkv,
                    w_pr * sa_gate[None, :], b_pr * sa_gate,
                    w1 * (1.0 + m_scale)[:, None], b1 + m_shift @ w1,
                    w2 * m_gate[None, :], b2 * m_gate)

        def block(tok, w_qkv_f, b_qkv_f, w_pr_f, b_pr_f, w1_f, b1_f, w2_f,
                  b2_f):
            if fused_block and not fold_ln:
                return fused_dit_block(tok, w_qkv_f, b_qkv_f, w_pr_f, b_pr_f,
                                       w1_f, b1_f, w2_f, b2_f, model.n_heads)
            qkv = ln_gemm(tok, w_qkv_f, b_qkv_f)
            o = (short_seq_attention(qkv, model.n_heads) if pallas_attn
                 else einsum_attention(qkv, model.n_heads, qkv.dtype))
            tok = tok + (o @ w_pr_f + b_pr_f)
            h = F.gelu(ln_gemm(tok, w1_f, b1_f), approximate="tanh")
            return tok + (h @ w2_f + b2_f)

        for i in range(model.depth):
            with annotate("cdm.dit.fold"):
                folded = fold(p[f"block_{i}"])
            with annotate("cdm.dit.block"):
                tok = block(tok, *folded)

        with annotate("cdm.dit.head"):
            # final adaLN folded into the fp32 unpatchify head
            fmod = _dense(sc, p["final_mod"], cdt)[0].float()
            f_shift, f_scale = fmod.chunk(2)
            w_u = p["unpatchify"]["kernel"].float()
            out = (ln_f32(tok).float() @ (w_u * (1.0 + f_scale)[:, None])
                   + (p["unpatchify"]["bias"].float() + f_shift @ w_u))
            out = out.reshape(b, gh, gw, patch, patch, cin)
            return out.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, cin)

    return apply
