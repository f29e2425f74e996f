"""Time embedding shared by the score models."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(B,) times -> (B, dim) float32 features [sin | cos] with
    freqs = exp(-log(10000) * arange(half) / (half - 1))."""
    if dim % 2 or dim < 4:
        # odd dims would silently return 2*(dim//2) features; dim<=2 makes
        # the (half - 1) divisor 0 and the whole embedding NaN
        raise ValueError(f"sinusoidal_embedding dim must be even and >= 4, "
                         f"got {dim}")
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def time_embedding(p, t: torch.Tensor, base_dim: int,
                   dtype: torch.dtype, tp=None) -> torch.Tensor:
    """sinusoid(base_dim) -> Dense -> SiLU -> Dense over (B,) times, in
    ``dtype`` (the flax ``TimeEmbedding``; ``p`` holds ``Dense_0`` and
    ``Dense_1``). A batch-1 ``t`` gives a (1, emb_dim) row that broadcasts.
    ``tp``: the UNet's tensor-parallel layout, if any (``models.unet``)."""
    def dense(v, dp):
        def linear(v):
            return F.linear(v.to(dtype), dp["kernel"].to(dtype).t(),
                            dp["bias"].to(dtype))
        return linear(v) if tp is None else tp.layer(dp["kernel"], linear, v)
    return dense(F.silu(dense(sinusoidal_embedding(t, base_dim),
                              p["Dense_0"])), p["Dense_1"])
