"""Divergence estimators for the Ito-kappa composition operator.

Port of ``composable_diffusion_models_tpu.ops.divergence``: forward-mode
``torch.func.jvp`` in place of ``jax.jvp``, one extra forward per probe.
Forward-mode AD does not run on inference tensors: call these under
``torch.no_grad()`` (which leaves forward-mode AD on), not under
``torch.inference_mode()``.

Probe kinds: ``rademacher`` (+-1 with equal odds) and ``gaussian``, drawn
from an explicit ``torch.Generator`` on x's device, or handed in through
``probes=``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

PROBE_KINDS = ("rademacher", "gaussian")


def draw_probe(generator: torch.Generator, shape, dtype, device,
               kind: str) -> torch.Tensor:
    if kind == "rademacher":
        return torch.randint(0, 2, tuple(shape), generator=generator,
                             device=device).to(dtype) * 2.0 - 1.0
    if kind == "gaussian":
        return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                           device=device)
    raise ValueError(f"unknown probe kind: {kind!r}")


def value_and_div(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  probe: str = "rademacher", n_probes: int = 1,
                  probes: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fn(x)`` and the Hutchinson estimate of div fn at x: the mean over
    the probes v of <v, J v>, each by one forward-mode jvp.

    ``fn`` maps (B, ...) -> (B, ...). Returns (fn(x), div of shape (B,)).
    ``probes`` of shape x.shape (one probe) or (n_probes, *x.shape) takes
    the place of the draws; otherwise ``generator`` is needed."""
    if probe not in PROBE_KINDS:
        raise ValueError(f"unknown probe kind: {probe!r}")
    if probes is None:
        if generator is None:
            raise ValueError("value_and_div needs a generator or probes=")
        probes = torch.stack([
            draw_probe(generator, x.shape, x.dtype, x.device, probe)
            for _ in range(n_probes)])
    elif probes.shape == x.shape:
        probes = probes[None]
    axes = tuple(range(1, x.dim()))
    val, divs = None, []
    for v in probes:
        out, jvp_val = torch.func.jvp(fn, (x,), (v,))
        val = out if val is None else val
        divs.append((jvp_val * v).sum(dim=axes))
    return val, divs[0] if len(divs) == 1 else torch.stack(divs).mean(dim=0)


def exact_div(fn: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact divergence by the trace of the per-example Jacobian, one jvp
    per dimension: for tests and tiny dims. ``fn``: (B, D) -> (B, D)."""
    if x.dim() != 2:
        raise ValueError("exact_div expects flat (B, D) inputs")
    trace = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(x.shape[1]):
        e = torch.zeros_like(x)
        e[:, i] = 1.0
        _, jvp_val = torch.func.jvp(fn, (x,), (e,))
        trace = trace + jvp_val[:, i]
    return fn(x), trace
