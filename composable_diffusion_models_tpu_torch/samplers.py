"""Deterministic DDIM sampler.

Port of ``composable_diffusion_models_tpu.samplers.ddim`` for the serving
path: eta = 0, eps prediction, linear spacing, the x0 clamp gated by alpha.
The JAX ``lax.scan`` over the precomputed table becomes a Python loop; the
table stays on the host, so the per-step coefficients and the clamp gate
are plain floats and the loop never waits for the card.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

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
