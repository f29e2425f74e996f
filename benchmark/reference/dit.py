"""Plain reference of composed-DiT sampling: the unfolded DiT, the blend
over the experts and the deterministic DDIM update, in float32.

It reads the flax parameter tree that ``weights.make_experts`` makes (any
dtype; every leaf is taken to float32) and imports nothing of the program
under test. Where the program folds each step's adaLN modulation into its
GEMM weights, this computes the block as the DiT paper writes it
(arXiv:2212.09748, adaLN-Zero): LayerNorm without affine (eps 1e-6), then
``x * (1 + scale) + shift``, attention or the MLP, then the gated residual.
The time embedding is the model's own: [sin | cos] of t times
exp(-log(10000) i / (half - 1)), then Dense, SiLU, Dense; each label slot
adds a row of its embedding table.

``fp8=True`` is the control: every large GEMM (patchify, the attention
projections, the MLP, the head) takes its operands rounded to float8 e4m3,
the activations scaled per row and the weight per tensor to e4m3's range
of 448, and accumulates in float32; everything else stays float32.

The sampler is fixed here as the port's ``entry.sample`` fixes it, and no
file of a cell sets it: unit blend weights; DDIM with eta 0 over t evenly
spaced from ``T_MAX`` to ``T_MIN``, x0 clamped to ``CLIP`` once alpha >=
``CLIP_MIN_ALPHA``; the variance-preserving schedule with linear beta from
``BETA_0`` to ``BETA_1``. Only the number of steps comes from the cell.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0
T_MAX, T_MIN = 1.0, 1e-3
CLIP, CLIP_MIN_ALPHA = (-1.0, 1.0), 0.3
BETA_0, BETA_1 = 0.1, 20.0


def _e4m3(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude (per row along ``dim``, or over the tensor) to 448."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True)).clamp(min=1e-30)
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _dense(x: torch.Tensor, kernel, bias, fp8: bool = False) -> torch.Tensor:
    w = kernel.float().reshape(x.shape[-1], -1)
    if fp8:
        x, w = _e4m3(x, dim=-1), _e4m3(w)
    return x @ w + bias.float().reshape(-1)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


def _time_embedding(t: float, dim: int, device) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / (half - 1))
    args = torch.tensor([t], dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _attention(a: dict, h: torch.Tensor, n_heads: int,
               fp8: bool) -> torch.Tensor:
    b, n, d = h.shape
    hd = d // n_heads
    if "qkv" in a:  # the fused layout: one (D, 3D) kernel, [q | k | v]
        qkv = _dense(h, a["qkv"]["kernel"], a["qkv"]["bias"], fp8)
        q, k, v = qkv.reshape(b, n, 3, n_heads, hd).unbind(2)
        proj = a["proj"]
    else:           # flax's multi-head layout: (D, H, hd) kernels
        q, k, v = (_dense(h, a[name]["kernel"], a[name]["bias"], fp8)
                   .reshape(b, n, n_heads, hd)
                   for name in ("query", "key", "value"))
        proj = a["out"]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return _dense(o.reshape(b, n, d), proj["kernel"], proj["bias"], fp8)


def dit_eps(params: dict, x: torch.Tensor, t: float, labels: Sequence[int],
            model: dict, fp8: bool = False) -> torch.Tensor:
    """One expert's noise prediction for a float32 (B, H, W, C) batch at
    time ``t`` with batch-constant ``labels`` (one id a label slot)."""
    p = params["params"]
    d, patch = model["dim"], model["patch"]
    b, hh, ww, cin = x.shape
    gh, gw = hh // patch, ww // patch
    te = p["TimeEmbedding_0"]
    c = _dense(F.silu(_dense(_time_embedding(t, d, x.device),
                             te["Dense_0"]["kernel"], te["Dense_0"]["bias"])),
               te["Dense_1"]["kernel"], te["Dense_1"]["bias"])
    for i, lab in enumerate(labels):
        c = c + p[f"label_emb_{i}"]["embedding"].float()[lab]
    sc = F.silu(c)

    xp = x.reshape(b, gh, patch, gw, patch, cin).permute(0, 1, 3, 2, 4, 5)
    xp = xp.reshape(b, gh * gw, patch * patch * cin)
    tok = _dense(xp, p["patchify"]["kernel"], p["patchify"]["bias"], fp8)
    tok = tok + p["pos_emb"].float()

    for i in range(model["depth"]):
        bp = p[f"block_{i}"]
        mod = _dense(sc, bp["Dense_0"]["kernel"], bp["Dense_0"]["bias"])
        sa_shift, sa_scale, sa_gate, m_shift, m_scale, m_gate = (
            m[:, None, :] for m in mod.chunk(6, dim=-1))
        attn = (bp["FusedQKVAttention_0"] if "FusedQKVAttention_0" in bp
                else bp["MultiHeadDotProductAttention_0"])
        h = _modulate(_layer_norm(tok), sa_shift, sa_scale)
        tok = tok + sa_gate * _attention(attn, h, model["n_heads"], fp8)
        h = _modulate(_layer_norm(tok), m_shift, m_scale)
        h = F.gelu(_dense(h, bp["Dense_1"]["kernel"], bp["Dense_1"]["bias"],
                          fp8), approximate="tanh")
        tok = tok + m_gate * _dense(h, bp["Dense_2"]["kernel"],
                                    bp["Dense_2"]["bias"], fp8)

    shift, scale = _dense(sc, p["final_mod"]["kernel"],
                          p["final_mod"]["bias"]).chunk(2, dim=-1)
    h = _modulate(_layer_norm(tok), shift[:, None, :], scale[:, None, :])
    out = _dense(h, p["unpatchify"]["kernel"], p["unpatchify"]["bias"], fp8)
    out = out.reshape(b, gh, gw, patch, patch, cin).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hh, ww, cin)


def vp_alpha_sigma(t: float):
    """alpha(t), sigma(t) of the variance-preserving schedule with linear
    beta: log alpha = -t b0 / 2 - t^2 (b1 - b0) / 4, sigma^2 = 1 - alpha^2."""
    alpha = math.exp(-0.5 * t * BETA_0 - 0.25 * t * t * (BETA_1 - BETA_0))
    return alpha, math.sqrt(1.0 - alpha * alpha)


def sample(experts: Sequence[dict], x_init: torch.Tensor,
           expert_labels: Sequence[Sequence[int]], model: dict,
           n_steps: int, fp8: bool = False) -> torch.Tensor:
    """Deterministic DDIM from float32 ``x_init`` over ``n_steps`` steps:
    at each step the mean eps of the experts (expert i with its labels
    ``expert_labels[i]``), x0 = (x - sigma eps) / alpha, clamped once
    alpha is large enough, then x = alpha' x0 + sigma' eps."""
    ts = [T_MAX + (T_MIN - T_MAX) * i / n_steps for i in range(n_steps + 1)]
    x = x_init.float()
    with torch.no_grad():
        for i in range(n_steps):
            eps = sum(dit_eps(p, x, ts[i], labs, model, fp8)
                      for p, labs in zip(experts, expert_labels))
            eps = eps / len(experts)
            a0, s0 = vp_alpha_sigma(ts[i])
            a1, s1 = vp_alpha_sigma(ts[i + 1])
            x0 = (x - s0 * eps) / a0
            if a0 >= CLIP_MIN_ALPHA:
                x0 = x0.clamp(*CLIP)
            x = a1 * x0 + s1 * eps
    return x
