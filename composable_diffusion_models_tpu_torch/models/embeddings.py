"""Time embedding shared by the score models."""

from __future__ import annotations

import math

import torch


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
