"""Composition operators over a stacked (K, B, ...) expert prediction.

Port of ``composable_diffusion_models_tpu.compose``, whole: ``weighted``,
``kappa_ito`` / ``combine_kappa``, ``or_softmax``, ``and_heuristic``,
``and_solve`` / ``and_solve_k``, ``cfg``, ``resolve_occlusion`` /
``masked``, ``fixed`` and ``projected``. Plain functions on tensors, meant
to sit inside a sampler's step: none of them waits on the card. Host
numbers enter as Python scalars or through :func:`constant`, which copies a
small host vector to the device once per process.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.profiling import annotate


@functools.lru_cache(maxsize=256)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.tensor(values, dtype=dtype).to(device)


def constant(values: Sequence[float], dtype: torch.dtype,
             device) -> torch.Tensor:
    """``values`` (a flat sequence of host numbers) as a 1-D tensor of
    ``dtype`` on ``device``, made once per (values, dtype, device) and
    shared by every later call: a copy from the host at every sampler step
    would make the host wait for the card each time. Read-only."""
    return _constant(tuple(float(v) for v in values), dtype,
                     torch.device(device))


def _on_device(values, ref: torch.Tensor) -> torch.Tensor:
    """``values`` (host numbers, or a tensor) as a tensor of ``ref``'s dtype
    on ``ref``'s device; host numbers through :func:`constant`."""
    if isinstance(values, torch.Tensor):
        return values.to(device=ref.device, dtype=ref.dtype)
    return constant(np.ravel(values).tolist(), ref.dtype,
                    ref.device).reshape(np.shape(values))


def _kexp(w, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast per-expert (K,) or (K, B) weights against a (K, B, ...)
    stack."""
    w = _on_device(w, ref)
    return w.reshape(tuple(w.shape) + (1,) * (ref.dim() - w.dim()))


def weighted(eps_stack: torch.Tensor, weights) -> torch.Tensor:
    """eps = sum_i w_i eps_i / sum_i w_i over the leading expert axis."""
    with annotate("cdm.blend"):
        w = _kexp(weights, eps_stack)
        return (w * eps_stack).sum(dim=0) / w.sum(dim=0)


def kappa_ito(sigma_t, divs: Tuple[torch.Tensor, torch.Tensor],
              scores: Tuple[torch.Tensor, torch.Tensor],
              clip: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Equal-density-path kappa for two experts (pointwise AND):

      kappa = [sigma_t (div s1 - div s2) + <s1, s1 - s2>] / ||s1 - s2||^2

    ``scores`` are sigma-scaled scores (the nets' -eps_hat), ``divs`` their
    divergence estimates of shape (B,) or (B, 1). Returns kappa (B,); see
    :func:`combine_kappa`."""
    s1, s2 = scores
    div1, div2 = divs
    d = s1 - s2
    axes = tuple(range(1, s1.dim()))
    num = sigma_t * (div1 - div2).reshape(s1.shape[0]) + (s1 * d).sum(dim=axes)
    den = (d * d).sum(dim=axes) + 1e-12
    kappa = num / den
    if clip is not None:
        kappa = kappa.clamp(clip[0], clip[1])
    return kappa


def combine_kappa(kappa: torch.Tensor, s1: torch.Tensor,
                  s2: torch.Tensor) -> torch.Tensor:
    """s = s2 + kappa (s1 - s2), kappa of shape (B,)."""
    k = kappa.reshape(kappa.shape[0], *([1] * (s1.dim() - 1)))
    return s2 + k * (s1 - s2)


def or_softmax(log_q: torch.Tensor, temp: float = 1.0,
               bias=0.0) -> torch.Tensor:
    """SUPERDIFF OR: kappa = softmax(temp * log_q + bias) over the expert
    axis 0. ``log_q``: (K, B) running log-densities; returns (K, B).

    ``bias`` tilts the blend only when it is per-expert, shape (K,) or
    (K, 1): softmax is shift-invariant, so a scalar bias changes nothing,
    and a non-zero one raises instead of being silently accepted. A Python
    or numpy scalar is checked on the host, before any tensor is made (a
    0-d tensor is read, which waits for the card where it lies there); a
    per-expert bias of host numbers is copied to the device once
    (:func:`constant`)."""
    if isinstance(bias, torch.Tensor) and bias.dim() == 0:
        bias = float(bias)
    if np.ndim(bias) == 0:
        if float(bias) != 0.0:
            raise ValueError(
                "or_softmax: a scalar bias is inert (softmax is "
                "shift-invariant); pass a per-expert bias of shape (K,) "
                "to tilt the blend, or 0.0")
        return torch.softmax(temp * log_q, dim=0)
    b = _on_device(bias, log_q)
    if b.dim() == 1:
        b = b[:, None]                    # (K,) -> (K, 1), broadcast over B
    return torch.softmax(temp * log_q + b, dim=0)


def and_heuristic(log_q: torch.Tensor) -> torch.Tensor:
    """Heuristic AND: softmax(-log_q), toward the equal-density state."""
    return torch.softmax(-log_q, dim=0)


def _row_bias(bias, k: int, ref: torch.Tensor):
    """Bias of the K - 1 equal-density rows of the AND linear system: a
    scalar tilts every row; a per-expert (K,) bias enters as consecutive
    differences bias[r + 1] - bias[r]. A host scalar stays a Python number
    (added in ``ref``'s dtype, as a 0-d tensor of it was)."""
    if not isinstance(bias, torch.Tensor) and np.ndim(bias) == 0:
        return float(bias)
    b = _on_device(bias, ref)
    if b.dim() == 0:
        return b
    if tuple(b.shape) == (k,):
        return b[1:] - b[:-1]
    raise ValueError(f"bias must be a scalar or shape ({k},); got "
                     f"{tuple(b.shape)}")


def and_solve(a: torch.Tensor, b: torch.Tensor, bias=0.0) -> torch.Tensor:
    """Rigorous SUPERDIFF AND for K = 2, vectorised over the batch.

      a: (B, 2, 2), a[r, c] = d_tau * <reverse_drift_c, score_r>
      b: (B, 2) density-change terms

    Solves [[a00 - a10, a01 - a11], [1, 1]] kappa = [b1 - b0 + bias, 1] in
    closed form, clamps kappa to [0, 1] and renormalises; a singular system
    gives (0.5, 0.5). Returns kappa (B, 2)."""
    p, q = a[:, 0, 0] - a[:, 1, 0], a[:, 0, 1] - a[:, 1, 1]
    r = b[:, 1] - b[:, 0] + _row_bias(bias, 2, b)
    det = p - q
    safe = det.abs() > 1e-12
    k0 = torch.where(safe, (r - q) / torch.where(safe, det, 1.0), 0.5)
    kappa = torch.stack([k0, 1.0 - k0], dim=1).clamp(0.0, 1.0)
    total = kappa.sum(dim=1, keepdim=True)
    return torch.where(total > 0, kappa / total.clamp(min=1e-12), 0.5)


def and_solve_k(a: torch.Tensor, b: torch.Tensor, bias=0.0) -> torch.Tensor:
    """K-expert form of :func:`and_solve`: K - 1 rows
    ``sum_c (a[r, c] - a[r + 1, c]) kappa_c = b[r + 1] - b[r] + bias`` and
    the simplex row ``sum kappa = 1``, solved as a batched K x K system. A
    singular or non-finite solution gives uniform 1 / K; then kappa is
    clamped to [0, 1] and renormalised.

    a: (B, K, K), b: (B, K). Returns (B, K)."""
    bsz, k = b.shape
    mat = torch.cat([a[:, :-1, :] - a[:, 1:, :],
                     torch.ones((bsz, 1, k), dtype=a.dtype, device=a.device)],
                    dim=1)
    rhs = torch.cat([b[:, 1:] - b[:, :-1] + _row_bias(bias, k, b),
                     torch.ones((bsz, 1), dtype=b.dtype, device=b.device)],
                    dim=1)
    # guard the solve itself: a singular matrix must not poison the batch.
    # solve_ex without its error check: the guarded matrices need none, and
    # the check reads the factorisation's status back from the card
    safe = torch.linalg.det(mat).abs() > 1e-12
    eye = torch.eye(k, dtype=a.dtype, device=a.device).expand_as(mat)
    kappa = torch.linalg.solve_ex(torch.where(safe[:, None, None], mat, eye),
                                  rhs[..., None],
                                  check_errors=False)[0].squeeze(-1)
    ok = safe & torch.isfinite(kappa).all(dim=1)
    kappa = torch.where(ok[:, None], kappa, 1.0 / k).clamp(0.0, 1.0)
    total = kappa.sum(dim=1, keepdim=True)
    return torch.where(total > 0, kappa / total.clamp(min=1e-12), 1.0 / k)


def cfg(eps_uncond: torch.Tensor, eps_cond_stack: torch.Tensor,
        weights) -> torch.Tensor:
    """Classifier-free-guidance composition:

      eps = eps_uncond + sum_i w_i (eps_cond_i - eps_uncond)

    ``eps_cond_stack``: (K, B, ...) conditional predictions; ``weights``:
    (K,)."""
    w = _kexp(weights, eps_cond_stack)
    return eps_uncond + (w * (eps_cond_stack - eps_uncond[None])).sum(dim=0)


def resolve_occlusion(masks: torch.Tensor) -> torch.Tensor:
    """Possibly overlapping (K, H, W) masks -> disjoint ones. The last mask
    is on top: from the top down, each keeps only what is not yet
    claimed."""
    occ = torch.zeros_like(masks[0])
    uniques = [None] * masks.shape[0]
    for idx in reversed(range(masks.shape[0])):
        uniques[idx] = (masks[idx] - occ).clamp(0.0, 1.0)
        occ = occ + uniques[idx]
    return torch.stack(uniques)


def masked(eps_stack: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Spatially masked sum: eps = sum_i eps_i * mask_i, with disjoint
    (K, H, W) ``masks`` (:func:`resolve_occlusion`) broadcast over the batch
    and channel dims of the (K, B, H, W, C) stack."""
    return (eps_stack * masks[:, None, :, :, None]).sum(dim=0)


def fixed(eps_stack: torch.Tensor, kappa) -> torch.Tensor:
    """Fixed-kappa blend: eps = sum_i kappa_i eps_i (no normalisation)."""
    return (_kexp(kappa, eps_stack) * eps_stack).sum(dim=0)


LUMA_W = (0.299, 0.587, 0.114)  # ITU-R 601


def projected(eps_full: torch.Tensor, eps_sub: torch.Tensor, weight=1.0,
              proj=LUMA_W) -> torch.Tensor:
    """Orthogonal projection-substitution composition:

      eps = eps_full + weight * P^T (eps_sub - P eps_full)

    with P = proj / ||proj|| a unit-norm channel projection (the luma
    weights by default). A subspace expert that only ever saw P x estimates
    P eps; substituting along P's row space keeps the result a consistent
    full-noise estimate, and the orthogonal complement stays with the
    full-space expert. weight = 1 replaces the projected component,
    weight > 1 over-steers as guidance."""
    w = _on_device(proj, eps_full)
    w = w / torch.sqrt((w * w).sum())
    p_full = (eps_full * w).sum(dim=-1, keepdim=True)
    return eps_full + weight * (eps_sub - p_full) * w
