"""Config -> (schedule, model, dataset, initial parameters): what every
config-driven entry point builds first.

The port's copy of ``scripts/_common.py``'s builders (``build_schedule``,
``build_model``, ``build_dataset``, ``init_params``) over a
``utils.config.Config``. Differences, each the port's idiom:

* ``build_model`` maps ``ModelConfig.dtype`` ("float32" | "bfloat16") to
  the model's compute dtype (None | ``torch.bfloat16``: "float32" computes
  in the input's dtype, as in the JAX package), and takes the kernel
  switches ``fused_gn`` / ``flash_attn`` of the UNet as arguments
  (``_common.build_model`` leaves the JAX UNet's ``use_pallas`` at its
  default, False): the serving callers pass True, training passes False
  (no kernel has a backward).
* ``build_dataset`` and ``init_params`` build on ``device``, from an int
  key or an ``rng.Draws``; ``init_params`` draws through ``convert.
  flax_init`` (flax's distributions, not its bits) and returns a UNet's
  tree in the layout ``UNet.apply`` reads (``convert.unet_torch_layout``).

The runtime flags (``add_runtime_flags``, ``apply_runtime_flags``,
``require_accelerator``) are in ``scripts/_common.py`` of this package,
with the command lines that take them.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from . import data as data_lib
from .convert import flax_init, unet_torch_layout
from .models import DiT, LatentDiffusionMLP, ScoreMLP, UNet
from .schedules import DDPMSchedule, VPSchedule
from .utils.config import Config


def build_schedule(cfg: Config) -> Union[DDPMSchedule, VPSchedule]:
    if cfg.schedule.family == "ddpm":
        return DDPMSchedule(num_timesteps=cfg.schedule.num_timesteps,
                            beta_schedule=cfg.schedule.beta_schedule)
    return VPSchedule(kind=cfg.schedule.kind)


def build_model(cfg: Config, fused_gn: bool = False,
                flash_attn: bool = False):
    """The model configuration of ``cfg.model``. ``fused_gn`` and
    ``flash_attn`` route a UNet's GroupNorm + SiLU and cross-attention
    through their kernels (inference only)."""
    m = cfg.model
    dtype = torch.bfloat16 if m.dtype == "bfloat16" else None
    if m.kind == "unet":
        return UNet(in_channels=m.in_channels, base_dim=m.base_dim,
                    channel_mults=tuple(m.channel_mults),
                    time_emb_dim=m.time_emb_dim,
                    num_classes=tuple(m.num_classes),
                    null_token=m.null_token, cross_attn=m.cross_attn,
                    dtype=dtype, pad_to=m.pad_to or None,
                    fused_gn=fused_gn, flash_attn=flash_attn)
    if m.kind == "dit":
        return DiT(patch=m.patch, dim=m.hidden, depth=m.depth,
                   n_heads=m.n_heads, in_channels=m.in_channels,
                   num_classes=tuple(m.num_classes),
                   null_token=m.null_token, img_size=cfg.data.img_size,
                   dtype=dtype)
    if m.kind == "mlp":
        return ScoreMLP(hidden=m.hidden, depth=m.depth, out_dim=m.latent_dim)
    if m.kind == "latent_mlp":
        return LatentDiffusionMLP(latent_dim=m.latent_dim, hidden=m.hidden,
                                  depth=m.depth,
                                  num_classes=tuple(m.num_classes),
                                  null_token=m.null_token)
    raise ValueError(f"unknown model kind {m.kind!r}")


def dataset_kwargs(cfg: Config) -> dict:
    """The keyword arguments of ``data.get_dataset`` for ``cfg.data``, as
    :func:`build_dataset` passes them (``scripts/eval_nll.py`` builds its
    scored set so)."""
    d = cfg.data
    kw = {
        "mnist": dict(classes=d.classes, data_dir=d.data_dir),
        "colored_mnist": dict(classes=d.classes, color_rule=d.color_rule,
                              data_dir=d.data_dir,
                              holdout=list(d.holdout) or None),
        "shapes": dict(img_size=d.img_size,
                       grayscale=d.gray_mode if d.grayscale else False,
                       holdout=list(d.holdout) or None,
                       background=d.background),
        # data.gray_mode is honoured as for "shapes": a luma_norm config
        # must not train on white-on-black masks
        "shapes_grayscale": dict(img_size=d.img_size, grayscale=d.gray_mode,
                                 holdout=list(d.holdout) or None,
                                 background=d.background),
        "shapes_bbox": dict(img_size=d.img_size,
                            holdout=list(d.holdout) or None),
        "toy2d": dict(up=True),
        "cifar10": dict(classes=d.classes, data_dir=d.data_dir),
    }.get(d.dataset)
    if kw is None:
        raise ValueError(f"unknown dataset {d.dataset!r}")
    return kw


def build_dataset(cfg: Config, key, device="cpu"
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Config-driven wrapper over the data registry (data.get_dataset) on
    ``device``: returns (images, labels_tuple)."""
    d = cfg.data
    out = data_lib.get_dataset(d.dataset, key, d.n, device=device,
                               **dataset_kwargs(cfg))
    return out[0], tuple(out[1:]) if d.dataset != "toy2d" else ()


def init_params(model, key, device="cpu") -> Any:
    """A float32 initial tree of ``model`` (:func:`build_model`'s) on
    ``device``, distributed as the flax module's init (``convert.flax_init``
    with ``key``); a UNet's in ``UNet.apply``'s layout. (The JAX function
    also takes the config, for the shapes of its dummy input; the port's
    shapes come from the model's configuration.)"""
    tree = flax_init(model, key, device)
    return unet_torch_layout(tree) if isinstance(model, UNet) else tree
