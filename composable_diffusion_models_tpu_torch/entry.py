"""The serving path end to end: 3 composed experts, 50-step DDIM, MNIST.

Counterpart of the JAX package's bench program (``bench.py``
``measure_dit_throughput``) and of ``__graft_entry__``: three
``dit_p14_d256_l4`` experts (patch 14, so 4 tokens per 28 x 28 image; dim
256; 8 heads; depth 4) served in bf16 through the folded DiT, blended by
``compose.weighted`` with unit weights, inside an fp32 deterministic DDIM
loop on ``VPSchedule()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from . import resolve_device
from .compose import weighted
from .experts import ExpertStack
from .models.dit import DiT, make_folded_apply
from .samplers import ddim
from .schedules import VPSchedule

FLAGSHIP = DiT(patch=14, dim=256, depth=4, n_heads=8, in_channels=1,
               qkv_fused=True, img_size=28)
N_EXPERTS = 3


def gflop_per_image(n_steps: int = 50) -> float:
    """Analytic GFLOP per sampled image of the flagship composer (matmul
    MACs x 2): per block qkv + out 4ND^2, attention 2N^2D, MLP 8ND^2,
    modulation 6D^2, plus the patchify and unpatchify GEMMs; 4.377 at 50
    steps."""
    cfg = FLAGSHIP
    n_tok, dim = cfg.n_tokens, cfg.dim
    per_block = (12 * n_tok * dim * dim + 2 * n_tok * n_tok * dim
                 + 6 * dim * dim)
    patchify = 2 * n_tok * dim * cfg.patch * cfg.patch * cfg.in_channels
    return 2.0 * (cfg.depth * per_block + patchify) * N_EXPERTS * n_steps / 1e9


def _cast(tree: Any, device: torch.device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def load_experts(trees: Sequence[Any], device=None,
                 dtype: torch.dtype = torch.bfloat16) -> list:
    """The experts' parameter trees (``convert.from_flax``) in ``dtype`` on
    the device (``None``: the CUDA card). A server does this once; the
    trees it returns pass through :func:`sample` without a copy."""
    dev = resolve_device(device)
    return [_cast(t, dev, dtype) for t in trees]


@torch.inference_mode()
def sample(params_list: Sequence[Any], x_init, n_steps: int = 50,
           fused_block: bool = True, device=None,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Samples from the 3 composed experts: an fp32 (B, 28, 28, 1) batch.

    ``params_list``: the experts' parameter trees as torch tensors
    (``convert.from_flax``), cast here to ``dtype`` on the device unless
    :func:`load_experts` already put them there.
    ``x_init``: (B, 28, 28, 1) initial noise. ``device=None`` is the CUDA
    card (raises without one). ``dtype`` is the experts' compute type:
    bf16 serves; fp32 holds the port to the JAX reference in tests."""
    dev = resolve_device(device)
    model = dataclasses.replace(FLAGSHIP, dtype=dtype)
    stack = ExpertStack(make_folded_apply(model, fused_block),
                        load_experts(params_list, dev, dtype))
    w = torch.ones((stack.k,), dtype=torch.float32, device=dev)

    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # bf16 experts inside the fp32 sampler, blended in fp32
        return weighted(stack(x.to(dtype), t.to(dtype)).float(), w)

    x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
    return ddim(eps_fn, VPSchedule(), x, n_steps)
