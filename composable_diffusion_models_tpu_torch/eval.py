"""Quantitative evaluation of generated samples with a probe classifier.

Port of ``composable_diffusion_models_tpu.eval``: train a small probe
(:class:`ProbeClassifier`, in ``models/probe.py``) on real data, then score
samples by its predictions (``classify``, ``probe_accuracy``,
``compositional_scores``, ``joint_hits``) and by distributional statistics
of its penultimate features (``probe_features``, ``frechet_probe_distance``,
``within_class_diversity``).

``train_probe`` is the JAX package's loop (Adam, batches drawn with
replacement, optional noise augmentation) with its key structure: step i
draws with ``fold_in(key, i)`` split into (batch indices, augmentation); a
``rng.Replay`` replays recorded draws through the same loop.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .convert import flax_init
from .models.probe import ProbeClassifier
from .rng import as_draws
from .schedules import VPSchedule
from .train import Adam, value_and_grad

Params = Any

__all__ = ["ProbeClassifier", "train_probe", "classify", "probe_accuracy",
           "compositional_scores", "probe_features",
           "frechet_probe_distance", "within_class_diversity", "joint_hits"]


def train_probe(key, images: torch.Tensor, labels: Sequence[torch.Tensor], *,
                num_classes: Optional[Sequence[int]] = None,
                steps: int = 1500, batch_size: int = 256, lr: float = 2e-3,
                base_dim: int = 32, noise_aug: float = 0.0,
                vp_schedule: Optional[VPSchedule] = None,
                dtype: Optional[torch.dtype] = torch.bfloat16,
                params: Optional[Params] = None
                ) -> Tuple[ProbeClassifier, Params]:
    """Train a probe on (images, per-factor labels) on their device. Returns
    (model, params). The loss is the sum over heads of the mean softmax
    cross-entropy. ``noise_aug`` adds N(0, noise_aug^2) to the training
    inputs; ``vp_schedule`` instead noises them by the VP forward process at
    t ~ U(0.02, 0.9). ``params`` starts from a given tree; by default the
    flax init's distribution is drawn with the key (``convert.flax_init``)."""
    if num_classes is None:
        num_classes = [int(lab.max()) + 1 for lab in labels]
    model = ProbeClassifier(tuple(num_classes), base_dim, dtype,
                            in_channels=images.shape[-1])
    key = as_draws(key, images.device)
    if params is None:
        params = flax_init(model, key.key, images.device)
    tx = Adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p, x, ys):
        return sum(F.cross_entropy(lg, y)
                   for lg, y in zip(model.apply(p, x), ys))

    n = images.shape[0]
    for i in range(steps):
        ki, kn = key.fold_in(i).split(2)
        idx = ki.randint((batch_size,), n)
        x = images[idx]
        if vp_schedule is not None:
            kt, ke = kn.split(2)
            t = kt.uniform((batch_size,), 0.02, 0.9)
            x, _ = vp_schedule.q_t(x, t, eps=ke.normal(x.shape, x.dtype))
        elif noise_aug > 0.0:
            x = x + noise_aug * kn.normal(x.shape, x.dtype)
        _, grads = value_and_grad(loss_fn, params, x,
                                  tuple(lab[idx] for lab in labels))
        params, opt_state = tx.update(grads, opt_state, params)
    return model, params


@torch.no_grad()
def classify(model: ProbeClassifier, params: Params,
             images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Argmax predictions per factor head."""
    return tuple(lg.argmax(dim=-1) for lg in model.apply(params, images))


def probe_accuracy(model: ProbeClassifier, params: Params,
                   images: torch.Tensor,
                   labels: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Held-in sanity: per-factor accuracy of the probe itself."""
    return {f"factor_{i}_acc": float((p == y).float().mean())
            for i, (p, y) in enumerate(zip(classify(model, params, images),
                                           labels))}


@torch.no_grad()
def compositional_scores(model: ProbeClassifier, params: Params,
                         samples: torch.Tensor,
                         target_labels: Sequence[int]) -> Dict[str, float]:
    """Per-factor and joint accuracy of samples against one intended
    (factor_0, factor_1, ...) combination, and the probe's mean softmax
    probability of the targets (``factor_i_target_prob``, and
    ``joint_target_prob`` as the mean per-sample product)."""
    out: Dict[str, float] = {}
    b = samples.shape[0]
    joint = torch.ones(b, dtype=torch.bool, device=samples.device)
    joint_p = torch.ones(b, device=samples.device)
    for i, (lg, tgt) in enumerate(zip(model.apply(params, samples),
                                      target_labels)):
        hit = lg.argmax(dim=-1) == tgt
        p_tgt = torch.softmax(lg, dim=-1)[:, tgt]
        out[f"factor_{i}_acc"] = float(hit.float().mean())
        out[f"factor_{i}_target_prob"] = float(p_tgt.mean())
        joint = joint & hit
        joint_p = joint_p * p_tgt
    out["joint_acc"] = float(joint.float().mean())
    out["joint_target_prob"] = float(joint_p.mean())
    return out


@torch.no_grad()
def probe_features(model: ProbeClassifier, params: Params,
                   images: torch.Tensor) -> torch.Tensor:
    """Penultimate-layer features (N, 128), float32."""
    return model.apply(params, images, return_features=True)[1]


def frechet_probe_distance(feats_a: torch.Tensor, feats_b: torch.Tensor,
                           eps: float = 1e-6) -> float:
    """Fréchet distance between Gaussian fits of two feature sets,
    ||mu_a - mu_b||^2 + tr(Ca + Cb - 2 (Ca Cb)^1/2), the square root's
    trace as the sum of sqrt(eigvals) of A^1/2 Cb A^1/2 with A^1/2 from the
    symmetric eigendecomposition of Ca (negative eigenvalues clamped),
    clamped at 0. In float64, as the JAX package computes it when 64-bit
    types are on: the distance is a small difference of traces, and two
    float32 eigen-solvers disagree on it by up to ~1e-3 of itself."""
    a = torch.as_tensor(feats_a).to(torch.float64)
    b = torch.as_tensor(feats_b).to(device=a.device, dtype=torch.float64)
    eye = torch.eye(a.shape[1], device=a.device, dtype=torch.float64)
    ca = torch.cov(a.T) + eps * eye
    cb = torch.cov(b.T) + eps * eye
    wa, va = torch.linalg.eigh(ca)
    a_half = (va * torch.sqrt(torch.clamp(wa, min=0.0))) @ va.T
    wm = torch.linalg.eigvalsh(a_half @ cb @ a_half)
    tr_sqrt = torch.sqrt(torch.clamp(wm, min=0.0)).sum()
    d2 = (((a.mean(0) - b.mean(0)) ** 2).sum() + torch.trace(ca)
          + torch.trace(cb) - 2.0 * tr_sqrt)
    return float(torch.clamp(d2, min=0.0))


@torch.no_grad()
def within_class_diversity(model: ProbeClassifier, params: Params,
                           samples: torch.Tensor,
                           head: int = 0) -> Dict[str, Any]:
    """Mean and least, over the predicted classes with at least two
    members, of the mean pairwise Euclidean distance of their probe
    features: a sampler that emits one image per class scores ~0."""
    logits, feats = model.apply(params, samples, return_features=True)
    preds = logits[head].argmax(dim=-1)
    per_class = []
    for c in torch.unique(preds).tolist():
        f = feats[preds == c].double()
        if f.shape[0] < 2:
            continue
        d = torch.sqrt(torch.clamp(
            ((f[:, None, :] - f[None, :, :]) ** 2).sum(-1), min=0.0))
        iu = torch.triu_indices(f.shape[0], f.shape[0], offset=1,
                                device=f.device)
        per_class.append(float(d[iu[0], iu[1]].mean()))
    if not per_class:
        return {"diversity_mean": 0.0, "diversity_min": 0.0, "n_classes": 0}
    return {"diversity_mean": sum(per_class) / len(per_class),
            "diversity_min": min(per_class), "n_classes": len(per_class)}


@torch.no_grad()
def joint_hits(model: ProbeClassifier, params: Params, samples: torch.Tensor,
               target_labels: Sequence[int]) -> torch.Tensor:
    """(B,) bool: the probe assigns every target factor label."""
    joint = torch.ones(samples.shape[0], dtype=torch.bool,
                       device=samples.device)
    for p, tgt in zip(classify(model, params, samples), target_labels):
        joint = joint & (p == tgt)
    return joint
