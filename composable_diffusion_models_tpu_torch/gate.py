"""The quality gates: their criteria, their judge and their verdicts.

The port's own copy of ``bench.gate_verdict`` (which reads the committed
``artifacts/quality_gate*/quality_<flagship>*.json`` reports) and of
``GATE_CRITERIA``, ``judge`` and ``probe_stats`` from
``scripts/quality_gate_flagship.py``. The protocol that produces a report
(three experts trained on digit subsets, a digit probe, solo and composed
sampling through the served program) is ``entry.quality_gate``.

A report is the script's JSON: ``solo`` (one row of probe statistics per
expert), ``composed`` (the 3-expert composition's row), and, once judged,
``verdict`` and ``criteria``. PASS needs, against a baseline report: the
composed in-union fraction, the least solo in-subset fraction and the
composed class entropy within ``tol`` of the baseline's; the composed
within-class diversity at least ``div_frac`` of the baseline's; and the
composed FID-lite at most ``fid_slack`` times the baseline's.

``entry.quality_gate_flagship`` runs the same protocol for any named
configuration (``build_model``: ``unet<W>`` or ``dit_p<P>_d<D>_l<L>[_h<H>]``)
and judges each against a report or against one of the configurations of
the same run.

The shapes gate (``entry.quality_gate_shapes``, the protocol of
``scripts/quality_gate_shapes.py``) judges its reports by the same
``judge`` under ``SHAPES_CRITERIA``: the 9 (shape, color) cells' mean and
least joint accuracy, their mean diversity and the FID-lite of all cells.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from . import eval as ceval
from .models.dit import DiT, make_folded_apply
from .models.unet import UNet

ROOT = Path(__file__).resolve().parent.parent
SUBSETS = ((0, 1, 2), (3, 4, 5), (6, 7, 8))
# the committed 48k-steps-per-expert report of dit_p14_d256_l4 (a PASS)
BASELINE = ROOT / "artifacts" / "quality_gate_r5" / \
    "quality_dit_p14_d256_l4_s48000.json"

def build_model(name: str, dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[Any, Callable]:
    """(model, serve_fn) of a flagship gate configuration, named as
    ``scripts/quality_gate_flagship.py`` names them, both computing in
    ``dtype`` (the script's bf16; float32 holds the port to the JAX package
    in tests) on 28 x 28 x 1 digits: ``unet<W>`` a UNet of base W, widths (W, 2W,
    4W) (64 is the reference's M1, 32 its M5), trained with GroupNorm in
    PyTorch ops and served with it through the ``groupnorm_silu`` kernel;
    ``dit_p<P>_d<D>_l<L>[_h<H>]`` a DiT of patch P, width D, depth L and H
    heads (8 by default), trained through the unfolded forward and served
    through the folded one (``make_folded_apply``: the ``fused_dit_block``
    kernel). ``model.apply`` is the training forward; ``serve_fn(params, x,
    t)`` the program the gate samples, on trees cast to ``dtype`` (a
    UNet's in the layout its ``apply`` reads)."""
    if name.startswith("unet"):
        m = UNet(in_channels=1, base_dim=int(name[4:]),
                 channel_mults=(1, 2, 4), dtype=dtype)
        return m, dataclasses.replace(m, fused_gn=True).apply
    if name.startswith("dit"):
        parts = {p[0]: int(p[1:]) for p in name.split("_")[1:]}
        m = DiT(patch=parts["p"], dim=parts["d"], depth=parts["l"],
                n_heads=parts.get("h", 8), in_channels=1, dtype=dtype)
        return m, make_folded_apply(m)
    raise ValueError(f"unknown config {name}")


GATE_CRITERIA = (
    # (name, candidate_extractor, direction, kind)
    ("composed_in_union", lambda r: r["composed"]["in_set_frac"], ">=", "tol"),
    ("solo_min_in_set",
     lambda r: min(s["in_set_frac"] for s in r["solo"].values()), ">=", "tol"),
    ("composed_entropy", lambda r: r["composed"]["class_entropy"], ">=",
     "tol"),
    ("composed_diversity", lambda r: r["composed"]["diversity_mean"], ">=",
     "frac"),
    ("composed_fid", lambda r: r["composed"]["fid_probe"], "<=", "slack"),
)


# the shapes gate's criteria (scripts/quality_gate_shapes.py): the mean and
# the least of the 9 cells' joint accuracies within tol of the baseline's,
# the mean per-cell diversity at least div_frac of it, FID-lite at most
# fid_slack times it
SHAPES_CRITERIA = (
    ("cell_joint_mean", lambda r: r["composed"]["joint_mean"], ">=", "tol"),
    ("cell_joint_min", lambda r: r["composed"]["joint_min"], ">=", "tol"),
    ("cell_diversity", lambda r: r["composed"]["diversity_mean"], ">=",
     "frac"),
    ("composed_fid", lambda r: r["composed"]["fid_probe"], "<=", "slack"),
)


def gate_verdict(flagship: str, root: Optional[str] = None
                 ) -> Tuple[Optional[str], Optional[str]]:
    """(verdict, path) of the committed gate report that decides
    ``flagship``, from ``root``/artifacts/quality_gate*/
    quality_<flagship>*.json (``root``: the repository). A PASS at any
    training budget wins over FAILs at others; among several PASSes (or
    only FAILs) the highest budget wins, then the lexicographically last
    path. (None, None) when no report carries a verdict."""
    root = str(ROOT if root is None else root)
    paths = glob.glob(os.path.join(root, "artifacts", "quality_gate*",
                                   f"quality_{flagship}*.json"))
    candidates = []
    for p in sorted(paths):
        try:
            with open(p) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            continue
        v = rep.get("verdict")
        if v:
            candidates.append((v == "PASS", int(rep.get("train_steps", 0)),
                               p, v))
    if not candidates:
        return None, None
    _, _, p, v = max(candidates)
    return v, p


def judge(report: dict, baseline: dict, tol: float, div_frac: float,
          fid_slack: float, criteria=GATE_CRITERIA,
          n_samples: Optional[int] = None) -> dict:
    """PASS iff every criterion holds against the baseline report. Returns
    {"verdict", "criteria": {...}}. With ``n_samples`` each criterion also
    carries its threshold, a sampling-noise scale (2 / sqrt(n), times
    |baseline| for the non-fraction criteria) and ``near_boundary``; the
    caller escalates (more samples, a second seed) when any row is near."""
    crit = {}
    ok_all = True
    near_any = False
    for name, get, direction, kind in criteria:
        cand, base = get(report), get(baseline)
        if kind == "tol":
            thr = base - tol
            ok = cand >= thr
        elif kind == "frac":
            thr = div_frac * base
            ok = cand >= thr
        else:  # slack (lower is better)
            thr = fid_slack * base + 1e-6
            ok = cand <= thr
        row = {"candidate": round(cand, 4), "baseline": round(base, 4),
               "direction": direction, "ok": bool(ok)}
        if n_samples:
            noise = (2.0 / n_samples ** 0.5 if kind == "tol"
                     else 2.0 / n_samples ** 0.5 * abs(base))
            near = abs(cand - thr) < noise
            row.update({"threshold": round(thr, 4),
                        "noise": round(noise, 4),
                        "near_boundary": bool(near)})
            near_any = near_any or near
        crit[name] = row
        ok_all = ok_all and ok
    out = {"verdict": "PASS" if ok_all else "FAIL", "criteria": crit}
    if n_samples:
        out["near_boundary"] = bool(near_any)
    return out


@torch.no_grad()
def probe_stats(probe: ceval.ProbeClassifier, probe_params: Any,
                samples: torch.Tensor, allowed: Sequence[int],
                real_feats: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Digit-probe statistics of [-1, 1] NHWC samples: the fraction in
    ``allowed``, the mean max-softmax confidence (overall and in-set), the
    10-class histogram and its entropy; with ``real_feats`` (features of
    real images) also the within-class diversity and FID-lite."""
    logits = probe.apply(probe_params, samples)[0]
    probs = torch.softmax(logits, dim=-1)
    maxp, preds = probs.max(dim=-1)
    hist = torch.bincount(preds, minlength=10).float() / preds.shape[0]
    in_set = torch.isin(preds, torch.tensor(list(allowed),
                                            device=preds.device)).float()
    ent = -torch.where(hist > 0, hist * torch.log(hist),
                       torch.zeros_like(hist)).sum()
    out = {
        "in_set_frac": float(in_set.mean()),
        "mean_max_prob": float(maxp.mean()),
        "mean_max_prob_in_set": float((maxp * in_set).sum()
                                      / torch.clamp(in_set.sum(), min=1)),
        "class_hist": [round(float(h), 4) for h in hist],
        "class_entropy": float(ent),
    }
    if real_feats is not None:
        out.update(ceval.within_class_diversity(probe, probe_params, samples))
        feats = ceval.probe_features(probe, probe_params, samples)
        out["fid_probe"] = round(
            ceval.frechet_probe_distance(feats, real_feats), 4)
    return out
