"""Composition operators over a stacked (K, B, ...) expert prediction.

Port of ``composable_diffusion_models_tpu.compose``: ``weighted`` and ``cfg``.
"""

from __future__ import annotations

import torch


def _kexp(w, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast per-expert (K,) or (K, B) weights against a (K, B, ...)
    stack."""
    w = torch.as_tensor(w, dtype=ref.dtype, device=ref.device)
    return w.reshape(tuple(w.shape) + (1,) * (ref.dim() - w.dim()))


def weighted(eps_stack: torch.Tensor, weights) -> torch.Tensor:
    """eps = sum_i w_i eps_i / sum_i w_i over the leading expert axis."""
    w = _kexp(weights, eps_stack)
    return (w * eps_stack).sum(dim=0) / w.sum(dim=0)


def cfg(eps_uncond: torch.Tensor, eps_cond_stack: torch.Tensor,
        weights) -> torch.Tensor:
    """Classifier-free-guidance composition:

      eps = eps_uncond + sum_i w_i (eps_cond_i - eps_uncond)

    ``eps_cond_stack``: (K, B, ...) conditional predictions; ``weights``:
    (K,)."""
    w = _kexp(weights, eps_cond_stack)
    return eps_uncond + (w * (eps_cond_stack - eps_uncond[None])).sum(dim=0)
