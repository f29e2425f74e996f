"""Typed config tree + named presets, as the JAX package's scripts read them.

The port's copy of ``composable_diffusion_models_tpu.utils.config``, whole:
the five dataclasses and ``Config.apply_sanity``, the seven presets and
``PRESETS``, ``get_config`` with its dotted ``--key=value`` overrides
(``_coerce`` / ``_set_dotted``, including the trailing-comma tuple
spellings), ``to_dict`` and ``save_yaml``. Pure Python: nothing here
imports torch. ``ModelConfig.dtype`` stays a string ("float32" |
"bfloat16"); ``builders.build_model`` maps it to a torch dtype.

``save_yaml`` writes YAML where the ``yaml`` module is installed and JSON
(a valid YAML subset) where it is not, as the JAX function does.
"""

from __future__ import annotations

import dataclasses
import json
import re
import os
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class ModelConfig:
    kind: str = "unet"                 # unet | dit | mlp | latent_mlp | vae
    in_channels: int = 1
    base_dim: int = 64
    channel_mults: Tuple[int, ...] = (1, 2, 4)
    time_emb_dim: int = 256
    num_classes: Tuple[int, ...] = ()
    null_token: bool = False
    cross_attn: bool = False
    hidden: int = 512                  # mlp family
    depth: int = 4
    latent_dim: int = 2
    dtype: str = "float32"             # compute dtype: float32 | bfloat16
    pad_to: int = 0                    # 0 = off; e.g. 32: compute on an
                                       # 8-aligned zero-padded canvas (TPU
                                       # conv-emitter tiling; models/unet.py)
    patch: int = 4                     # dit family: patch edge
    n_heads: int = 8                   # dit family: attention heads


@dataclasses.dataclass
class DataConfig:
    dataset: str = "mnist"             # mnist | colored_mnist | shapes | toy2d
    n: int = 8192
    img_size: int = 28
    classes: Optional[Tuple[int, ...]] = None
    grayscale: bool = False
    gray_mode: str = "white"           # white | luma | luma_norm (the
                                       # 1-channel protocol when grayscale;
                                       # see data.make_shapes_dataset)
    color_rule: str = "per_digit"
    holdout: Tuple[Tuple[int, int], ...] = ()
    background: str = "black"
    data_dir: Optional[str] = None


@dataclasses.dataclass
class ScheduleConfig:
    family: str = "vp"                 # vp | ddpm
    kind: str = "stable"               # stable | jax_faithful | cosine (vp)
    num_timesteps: int = 1000          # ddpm only
    beta_schedule: str = "linear"      # linear | cosine (ddpm only)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 4000
    batch_size: int = 128
    lr: float = 2e-4
    uncond_prob: float = 0.0
    ema_decay: float = 0.0             # 0 = off; 0.999 typical (sample with EMA)
    predict: str = "eps"               # eps | x0 | v (x0: the reference's
                                       # cross-attn model, §7.5; v: Salimans
                                       # & Ho 2022, stable schedule only)
    snr_gamma: float = 0.0             # 0 = off; 5.0 = min-SNR weighting
                                       # (Hang et al. 2023)
    seed: int = 42
    sanity: bool = False               # the reference's fast-path flag


@dataclasses.dataclass
class SampleConfig:
    sampler: str = "ddim"              # ddim | em | ode | ancestral | superdiff
    n_steps: int = 50
    batch_size: int = 64
    xi: float = 1.0
    operation: str = "OR"
    temp: float = 1.0
    bias: float = 0.0
    weights: Tuple[float, ...] = (1.0, 1.0)
    guidance: Tuple[float, ...] = (1.0, 1.0)


@dataclasses.dataclass
class Config:
    name: str = "default"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sample: SampleConfig = dataclasses.field(default_factory=SampleConfig)
    out_dir: str = "outputs"

    def apply_sanity(self) -> "Config":
        """The reference's --sanity contract (SURVEY.md §4.1): tiny steps,
        tiny batch, tiny dataset — 'does the pipeline run end-to-end'."""
        if not self.train.sanity:
            return self
        self.train.steps = min(self.train.steps, 20)
        self.train.batch_size = min(self.train.batch_size, 8)
        self.data.n = min(self.data.n, 64)
        self.sample.n_steps = min(self.sample.n_steps, 10)
        self.sample.batch_size = min(self.sample.batch_size, 4)
        return self


# --- preset registry --------------------------------------------------------
def _preset_mnist_image() -> Config:
    return Config(name="mnist_image",
                  data=DataConfig(dataset="mnist", classes=None))


def _preset_mnist_latent2d() -> Config:
    c = Config(name="mnist_latent2d")
    c.model = ModelConfig(kind="mlp", hidden=256, depth=3, latent_dim=2)
    c.data = DataConfig(dataset="mnist")
    c.train.batch_size = 512
    c.sample.sampler = "em"
    c.sample.n_steps = 1000
    return c


def _preset_shapes_ddim() -> Config:
    c = Config(name="shapes_ddim")
    c.model = ModelConfig(in_channels=3, num_classes=(3,))
    c.data = DataConfig(dataset="shapes", img_size=64, n=5000)
    c.sample.n_steps = 200
    return c


def _preset_shapes_latent() -> Config:
    """Per-shape-class PCA-latent MLP experts composed in the 2D latent
    (ref shapes/train_latent_expert.py + visualize_composition_latent_*)."""
    c = Config(name="shapes_latent")
    c.model = ModelConfig(kind="mlp", hidden=256, depth=3, latent_dim=2)
    c.data = DataConfig(dataset="shapes_grayscale", img_size=64, n=10000,
                        grayscale=True)
    c.train = TrainConfig(steps=4000, batch_size=512, lr=1e-3)
    c.sample.sampler = "ode"
    c.sample.n_steps = 1000
    return c


def _preset_shapes_bbox() -> Config:
    """3-factor (shape, color, bbox) workload: three single-factor experts
    composed K=3 (ref src/composing_conditional_diffusion_on_shape_and_
    color_4.py — white bg, bbox outline third factor, T=500 DDPM)."""
    c = Config(name="shapes_bbox")
    c.model = ModelConfig(in_channels=3, num_classes=(3,))
    c.data = DataConfig(dataset="shapes_bbox", img_size=64, n=5000,
                        holdout=((2, 2),), background="white")
    c.schedule = ScheduleConfig(family="ddpm", num_timesteps=500)
    c.sample.sampler = "ancestral"
    c.sample.n_steps = 500
    c.sample.weights = (1.0, 1.0, 1.0)
    return c


def _preset_colored_mnist_guided() -> Config:
    c = Config(name="colored_mnist_guided")
    c.model = ModelConfig(in_channels=3, num_classes=(10, 10),
                          null_token=True)
    c.data = DataConfig(dataset="colored_mnist")
    c.schedule = ScheduleConfig(family="ddpm", num_timesteps=1000)
    c.train.uncond_prob = 0.1
    return c


def _preset_ito_cross_attention() -> Config:
    c = Config(name="ito_cross_attention")
    c.model = ModelConfig(in_channels=3, num_classes=(10, 3),
                          null_token=True, cross_attn=True)
    c.data = DataConfig(dataset="colored_mnist", color_rule="random")
    c.sample.sampler = "ode"
    c.sample.n_steps = 1000
    return c


PRESETS = {
    "mnist_image": _preset_mnist_image,
    "mnist_latent2d": _preset_mnist_latent2d,
    "shapes_ddim": _preset_shapes_ddim,
    "shapes_latent": _preset_shapes_latent,
    "shapes_bbox": _preset_shapes_bbox,
    "colored_mnist_guided": _preset_colored_mnist_guided,
    "ito_cross_attention": _preset_ito_cross_attention,
}


def get_config(preset: str = "mnist_image", overrides: Sequence[str] = ()) -> Config:
    cfg = PRESETS[preset]()
    for ov in overrides:
        if not ov.startswith("--"):
            continue
        keyval = ov[2:].split("=", 1)
        if len(keyval) != 2:
            continue
        _set_dotted(cfg, keyval[0], keyval[1])
    return cfg


def _coerce(old: Any, val: str) -> Any:
    if isinstance(old, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(val)
    if isinstance(old, float):
        return float(val)
    if isinstance(old, tuple) or val.startswith(("(", "[")):
        s = val.replace("(", "[").replace(")", "]")
        try:
            parsed = json.loads(s)
        except json.JSONDecodeError:
            # Python tuple spellings carry trailing commas ("((2,2),)");
            # strip them before giving up, and name the offending value
            try:
                parsed = json.loads(re.sub(r",\s*([\]\}])", r"\1", s))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"could not parse override value {val!r} as a "
                    f"list/tuple: {e}") from None
        return tuple(tuple(p) if isinstance(p, list) else p for p in parsed)
    if old is None and val.lower() in ("none", "null"):
        return None
    return val


def _set_dotted(cfg: Any, dotted: str, val: str) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    old = getattr(obj, parts[-1])
    setattr(obj, parts[-1], _coerce(old, val))


def to_dict(cfg: Any) -> Dict:
    return dataclasses.asdict(cfg)


def save_yaml(cfg: Config, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import yaml
        with open(path, "w") as f:
            yaml.safe_dump(to_dict(cfg), f, default_flow_style=False)
    except ImportError:  # yaml not guaranteed in-image; JSON is a valid YAML subset
        with open(path, "w") as f:
            json.dump(to_dict(cfg), f, indent=2, default=str)
    return path
