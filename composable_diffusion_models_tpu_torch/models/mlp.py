"""MLP score networks for low-dimensional (PCA latent) diffusion.

Port of ``composable_diffusion_models_tpu.models.mlp``: ``ScoreMLP`` and
``LatentDiffusionMLP`` as frozen configurations with
``apply(params, t, x, *labels)``. The call order is ``(t, x)``, as in the JAX
package. ``params`` is the flax tree as torch tensors (``convert.from_flax``):
``Dense_0..Dense_depth`` with ``kernel`` (in, out) and ``bias``, and one
``label_emb_i/embedding`` table per label slot. The Dense layers are plain
GEMMs (``F.linear``), as they are plain XLA dots in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from .embeddings import sinusoidal_embedding


def _mlp(p: Any, h: torch.Tensor, depth: int) -> torch.Tensor:
    """``depth`` x (Dense + swish), then the output Dense."""
    for i in range(depth + 1):
        dp = p[f"Dense_{i}"]
        h = F.linear(h, dp["kernel"].t(), dp["bias"])
        if i < depth:
            h = F.silu(h)
    return h


@dataclasses.dataclass(frozen=True)
class ScoreMLP:
    """Dense(hidden) + swish x depth -> Dense(out_dim) over concat(t, x);
    ``t`` a scalar, (B,) or (B, 1)."""

    hidden: int = 512
    out_dim: int = 2
    depth: int = 4

    def apply(self, params: Any, t, x: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        if t.dim() == 0:
            t = t.expand(x.shape[0], 1)
        elif t.dim() == 1:
            t = t[:, None]
        return _mlp(params["params"], torch.cat([t, x], dim=-1), self.depth)


@dataclasses.dataclass(frozen=True)
class LatentDiffusionMLP:
    """Latent eps predictor over concat(z, sinusoidal t embedding, one label
    embedding per slot). ``num_classes`` holds the slots' vocabulary sizes;
    ``null_token`` reserves one more row per table (its index is the
    vocabulary size) for classifier-free guidance."""

    latent_dim: int = 10
    hidden: int = 256
    depth: int = 3
    time_emb_dim: int = 64
    num_classes: Tuple[int, ...] = ()
    null_token: bool = False

    def apply(self, params: Any, t, z: torch.Tensor, *labels) -> torch.Tensor:
        p = params["params"]
        t = torch.as_tensor(t, dtype=torch.float32, device=z.device)
        t = t.expand(z.shape[0]) if t.dim() == 0 else t.reshape(z.shape[0])
        parts = [z, sinusoidal_embedding(t, self.time_emb_dim)]
        for i in range(len(self.num_classes)):
            parts.append(F.embedding(
                torch.as_tensor(labels[i], device=z.device),
                p[f"label_emb_{i}"]["embedding"]))
        return _mlp(p, torch.cat(parts, dim=-1), self.depth)
