"""The digit probe: a small convnet with one classification head per factor.

Port of ``composable_diffusion_models_tpu.eval.ProbeClassifier`` over the
flax module's parameter tree (``conv_0..2`` HWIO, ``Dense_0``,
``head_i``). Three stride-2 3x3 convolutions with SiLU, a global average
pool, a Dense(128) with SiLU, then float32 heads. flax pads a stride-2 "SAME"
convolution by what the output size needs, split low side first: 0 before
and 1 after at 28 and 14 wide, 1 and 1 at 7 (not ``padding=1`` on both
sides). Images are NHWC.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F


def _same_pads(size: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """(before, after) padding of a "SAME" convolution along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@dataclasses.dataclass(frozen=True)
class ProbeClassifier:
    """``num_classes``: one head per factor; ``dtype``: the trunk's compute
    type (None: the input's), the heads are float32. ``in_channels`` is the
    images' (flax infers it from the input at init; ``convert.flax_init``
    and ``convert.param_shapes`` read it here)."""

    num_classes: Tuple[int, ...] = (3, 3)
    base_dim: int = 32
    dtype: Optional[torch.dtype] = None
    in_channels: int = 1

    def __post_init__(self):
        object.__setattr__(self, "num_classes", tuple(self.num_classes))

    def apply(self, params: Any, x: torch.Tensor,
              return_features: bool = False):
        """Logits per head, a tuple of (B, n_i) float32 tensors; with
        ``return_features`` also the (B, 128) float32 penultimate features.
        Differentiable."""
        p = params["params"]
        h = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        for i in range(3):
            cp = p[f"conv_{i}"]
            dt = self.dtype or torch.promote_types(h.dtype,
                                                   cp["kernel"].dtype)
            (t, b), (l, r) = _same_pads(h.shape[2]), _same_pads(h.shape[3])
            h = F.conv2d(F.pad(h.to(dt), (l, r, t, b)),
                         cp["kernel"].to(dt).permute(3, 2, 0, 1), stride=2)
            h = F.silu(h + cp["bias"].to(dt)[:, None, None])
        # global average pool, summed in float32 as jnp.mean does
        h = h.float().mean(dim=(2, 3)).to(h.dtype)
        dp = p["Dense_0"]
        dt = self.dtype or torch.promote_types(h.dtype, dp["kernel"].dtype)
        h = F.silu(h.to(dt) @ dp["kernel"].to(dt) + dp["bias"].to(dt))
        hf = h.float()
        heads = tuple(hf @ p[f"head_{i}"]["kernel"].float()
                      + p[f"head_{i}"]["bias"].float()
                      for i in range(len(self.num_classes)))
        if return_features:
            return heads, hf
        return heads
