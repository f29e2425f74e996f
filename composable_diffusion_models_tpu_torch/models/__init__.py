"""Score models of the port."""

from .dit import DiT, make_folded_apply
from .mlp import LatentDiffusionMLP, ScoreMLP
from .unet import UNet

__all__ = ["DiT", "LatentDiffusionMLP", "ScoreMLP", "UNet",
           "make_folded_apply"]
