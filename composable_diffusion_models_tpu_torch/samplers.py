"""Deterministic DDIM sampler, and the CFG prediction closure.

Port of ``composable_diffusion_models_tpu.samplers.ddim`` for the serving
path: eta = 0, eps prediction, linear spacing, the x0 clamp gated by alpha.
The JAX ``lax.scan`` over the precomputed table becomes a Python loop; the
table stays on the host, so the per-step coefficients and the clamp gate
are plain floats and the loop never waits for the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import compose
from .schedules import VPSchedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim(eps_fn: EpsFn, schedule: VPSchedule, x_init: torch.Tensor,
         n_steps: int, clip: Optional[Tuple[float, float]] = (-1.0, 1.0),
         clip_min_alpha: float = 0.3, t_max: float = 1.0,
         t_min: float = 1e-3, eta: float = 0.0, predict: str = "eps",
         spacing: str = "linear", corrector_steps: int = 0) -> torch.Tensor:
    """DDIM update over ``schedule.ddim_grid(n_steps, t_max, t_min)``:

      x0 = (x - sigma_now * eps) / alpha_now, clamped to ``clip`` once
           alpha_now >= clip_min_alpha
      x  = alpha_next * x0 + sigma_next * eps

    ``eps_fn(x, t)`` receives a 0-d float32 ``t`` on x's device. The
    stochastic (eta > 0), x0/v-prediction, Karras-spacing and corrector
    variants of the JAX sampler are not ported yet and raise."""
    if predict not in ("eps", "x0", "v"):
        raise ValueError(f"predict must be 'eps', 'x0' or 'v', "
                         f"got {predict!r}")
    if predict != "eps" or eta > 0.0 or corrector_steps > 0:
        raise NotImplementedError(
            "only deterministic eps-prediction DDIM (eta=0, no corrector) "
            "is ported")
    table = schedule.ddim_table(n_steps, t_max, t_min, spacing).tolist()
    ts = schedule.ddim_grid(n_steps, t_max, t_min, spacing)[:-1].to(
        x_init.device)
    # the gate compares float32 values, as the JAX sampler does
    gate = torch.tensor(clip_min_alpha, dtype=torch.float32).item()
    x = x_init
    for i, (a_now, s_now, a_next, s_next) in enumerate(table):
        out = eps_fn(x, ts[i])
        x0 = (x - s_now * out) / a_now
        if clip is not None and a_now >= gate:
            x0 = x0.clamp(clip[0], clip[1])
        x = a_next * x0 + s_next * out
    return x


def make_cfg_eps_fn(apply_fn: Callable[..., torch.Tensor],
                    cond_labels: Sequence[Tuple],
                    null_labels: Tuple, weights) -> EpsFn:
    """eps_fn(x, t) = the CFG-composed prediction of ONE model: the uncond
    slot and the K conditions run as a single forward with the fan-out
    folded into the batch axis (the model sees (K + 1) * B rows).

    ``cond_labels``: K label tuples, one label per slot, each a scalar or
    (B,); ``null_labels``: the uncond tuple; ``weights``: (K,) guidance.
    Port of the JAX package's ``samplers.make_cfg_eps_fn``."""
    k = len(cond_labels)

    @functools.lru_cache(maxsize=1)
    def fanned_labels(b: int, device: torch.device):
        # the same at every sampler step: built (and copied to the device)
        # once per batch size
        labels = []
        for slot in range(len(null_labels)):
            slot_vals = [null_labels[slot]] + [c[slot] for c in cond_labels]
            labels.append(torch.cat(
                [torch.as_tensor(v, device=device).expand(b)
                 for v in slot_vals], dim=0))
        return labels

    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x_rep = torch.cat([x] * (k + 1), dim=0)
        t_rep = torch.as_tensor(t, device=x.device).expand(b).repeat(k + 1)
        out = apply_fn(x_rep, t_rep, *fanned_labels(b, x.device))
        out = out.reshape(k + 1, b, *out.shape[1:])
        return compose.cfg(out[0], out[1:], weights)

    return eps_fn
