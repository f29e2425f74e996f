"""The program of a configuration with ``"program": "dit_sample"``:
composed-DiT sampling through the port's ``entry.sample``.

``entry.sample`` fixes everything of a call but the experts, their labels,
the served dtype and the number of steps: deterministic DDIM on the
variance-preserving schedule with linear beta, unit blend weights, a
float32 state. So a configuration of this program sets only those
(``CONFIG_KEYS``) and a traffic mix only the steps (``TRAFFIC_KEYS``), and
the plain reference (``reference/dit.py``) fixes the same sampler.

Every program module has ``CONFIG_KEYS``, ``TRAFFIC_KEYS``, ``load``,
``image_shape``, ``reference`` and ``model_flops``; ``spec.load_cell``
finds it by the name its configuration gives.
"""

from __future__ import annotations

import correct
import counts
from reference import dit as ref_dit
from reference import weights

CONFIG_KEYS = {"model", "experts", "expert_labels", "serve_dtype"}
TRAFFIC_KEYS = {"n_steps"}


def load(cell, seed: int, device):
    """(entry.sample bound to the cell, its experts' weights, a count of
    every kernel launch the port's wrappers made)."""
    import torch
    from composable_diffusion_models_tpu_torch import entry
    from composable_diffusion_models_tpu_torch.models.dit import DiT
    from composable_diffusion_models_tpu_torch.ops import attention, kernels

    cfg, m = cell.config, dict(cell.config["model"])
    if m.pop("mlp_ratio") != 4:
        raise ValueError("the port's DiT has an MLP of width 4 D")
    model = DiT(**{**m, "num_classes": tuple(m["num_classes"])})
    dtype = getattr(torch, cfg["serve_dtype"])
    experts = weights.make_experts(cfg["model"], cfg["experts"],
                                   correct.sub_seed(seed, "weights"), device,
                                   dtype)
    params = entry.load_experts(experts, device, dtype)
    labels = tuple(
        torch.tensor([[labs[s]] for labs in cfg["expert_labels"]],
                     device=device)
        for s in range(len(m["num_classes"])))
    n_steps = cell.traffic["n_steps"]

    def call(x):
        return entry.sample(params, x, n_steps=n_steps, device=device,
                            dtype=dtype, labels=labels, model=model)

    wrappers = {id(f): f for mod in (kernels, attention)
                for f in vars(mod).values() if hasattr(f, "launches")}

    def launches() -> int:
        return sum(f.launches for f in wrappers.values())
    return call, experts, launches


def image_shape(cell):
    """(H, W, C) of one sample."""
    m = cell.config["model"]
    return m["img_size"], m["img_size"], m["in_channels"]


def reference(cell, experts, x, fp8: bool = False):
    """The plain reference's samples from float32 noise ``x``."""
    cfg = cell.config
    return ref_dit.sample(experts, x, cfg["expert_labels"], cfg["model"],
                          cell.traffic["n_steps"], fp8=fp8)


def model_flops(cell) -> float:
    """Model FLOPs of one call (``counts.sample_flops``)."""
    cfg, traffic = cell.config, cell.traffic
    return counts.sample_flops(cfg["model"], cfg["experts"], traffic["batch"],
                               traffic["n_steps"])
