"""PyTorch + CUDA port of composable_diffusion_models_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing of it (nor JAX). Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` explicitly; a missing card raises instead of falling
back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when there is none.

    An explicit device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    returned as a ``torch.device`` unchanged, so tests can ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this port runs on the GPU by default; pass "
                "device='cpu' explicitly to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
