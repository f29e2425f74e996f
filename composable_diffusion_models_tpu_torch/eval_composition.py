"""Compositional-generalisation evaluation: the protocol of
``scripts/eval_composition.py``.

Two single-factor conditional experts (shape or digit | color) are trained
on the same holdout-filtered data, so that neither sees a held-out pair;
every (factor 0, factor 1) combination is composed under DDIM (or the
Ito-kappa ODE) and scored by a probe trained on the full data. A held-out
pair's ``joint_acc`` is the generalisation score. Datasets: ``shapes`` (3 x
3) and ``colored_mnist`` (10 x 3).

Routes through the kernels, chosen per operator:

* every expert forward outside a derivative runs the UNet's GroupNorm +
  SiLU through the ``groupnorm_silu`` kernel and its two-part form
  (``fused_gn=True``): ``avg``, ``cfg``, ``proj``, ``proj_cfg`` and the
  eps of ``cg`` / ``proj_cg``;
* ``avg`` and ``cg`` blend the two predictions through the ``blend_eps``
  kernel, as ``entry.sample_latent`` and ``entry.compose_scores`` do by
  default; ``cfg`` and the projections are ``compose`` ops;
* ``ito`` takes ``torch.func.jvp`` through both experts
  (``samplers.ito_kappa_ode``): its experts are built with
  ``fused_gn=False`` and launch no kernel;
* ``cg`` / ``proj_cg`` differentiate only the guidance probe
  (``samplers.make_classifier_guided_eps_fn``): x enters the experts
  without grad, so their forwards stay on the kernels, and the probe's
  gradient runs PyTorch ops alone.

The DiT backbone (``--model.kind=dit``) runs the unfolded ``DiT.apply``,
which has no kernel on this path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
from typing import Any, Callable, Optional, Sequence

import torch

from . import compose, data, resolve_device, samplers, train
from . import eval as ceval
from .builders import init_params
from .checkpoint import CheckpointManager
from .entry import _float_tree, _subkey
from .experts import gray_to_rgb, rgb_to_gray
from .models.dit import DiT
from .models.probe import ProbeClassifier
from .models.unet import UNet
from .ops.kernels import blend_eps
from .rng import Replay, as_draws
from .schedules import VPSchedule
from .utils.config import get_config
from .utils.viz import save_grid

KNOWN_OPS = ("avg", "ito", "cfg", "proj", "proj_cfg", "cg", "proj_cg")


def check_ops(op: str, uncond_prob: float, factor0_grayscale: bool,
              gray_norm: bool, hue_aug: float, weight_grid) -> list:
    """The script's argument checks, made before any training: the
    operators of the comma list ``op``, or ValueError."""
    ops = op.split(",")
    bad = [o for o in ops if o not in KNOWN_OPS]
    if bad:
        raise ValueError(f"unknown op {bad}; choose from {KNOWN_OPS}")
    if uncond_prob == 0.0 and {"cfg", "proj_cfg"} & set(ops):
        raise ValueError("op cfg/proj_cfg needs uncond_prob > 0 (null-token "
                         "training; otherwise the null embedding row is "
                         "random init)")
    if ({"proj", "proj_cfg", "proj_cg"} & set(ops)
            and not (factor0_grayscale and gray_norm)):
        raise ValueError("op proj (projection substitution) needs "
                         "factor0_grayscale and gray_norm so the factor-0 "
                         "expert estimates exactly P eps")
    if hue_aug and not factor0_grayscale:
        raise ValueError("hue_aug augments the factor-0 grayscale training "
                         "data; it needs factor0_grayscale")
    if "avg" in ops and any(sum(w) == 0 for w in weight_grid):
        raise ValueError("avg weights must not sum to 0 (the blend divides "
                         "by sum(w))")
    return ops


def cfg_hash(parts: dict) -> str:
    """The first 10 hex digits of the SHA-1 of ``parts`` as sorted JSON:
    the tag of a cached value, over every setting that shapes it."""
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


def atomic_write(path: str, write: Callable[[str], None]) -> None:
    """``write(tmp)`` to a temporary file renamed onto ``path``: a killed
    run leaves the old file or the new one, never half of one."""
    tmp = f"{path}.tmp.{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def write_json(path: str, obj, indent: Optional[int] = 2) -> None:
    """``obj`` as JSON at ``path``, written through :func:`atomic_write`."""
    def dump(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent)
    atomic_write(path, dump)


def resume(path: str, same_run: Callable[[dict], bool]) -> dict:
    """The partial report at ``path`` when it exists, reads and
    ``same_run`` accepts it (a run of the same settings); else {}."""
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            prev = json.load(f)
    except ValueError:
        return {}
    return prev if same_run(prev) else {}


def cached(path: str, build: Callable[[], Any], device) -> Any:
    """``build()``'s value, kept in ``path`` (``torch.save``): read back
    onto ``device`` when the file exists, else built and written through
    :func:`atomic_write`. A file that does not read (truncated, corrupt) is
    deleted and the value built again."""
    if os.path.exists(path):
        try:
            return torch.load(path, map_location=device, weights_only=True)
        except (EOFError, RuntimeError, pickle.UnpicklingError, ValueError,
                OSError):
            print(f"corrupt cache {path} — deleting and rebuilding")
            os.remove(path)
    val = build()
    atomic_write(path, lambda tmp: torch.save(val, tmp))
    return val


def canonical(op: str, wpair) -> tuple:
    """Settings that give identical samples share one key: ``ito`` ignores
    the weights, ``avg`` is invariant to their scale, ``proj`` and ``cg``
    read the first weight only."""
    if op == "ito":
        return (op,)
    if op == "avg":
        s = sum(wpair)
        return (op,) + tuple(round(w / s, 6) for w in wpair)
    if op in ("proj", "cg"):
        return (op, wpair[0])
    return (op,) + tuple(wpair)


def expert_model(cfg, in_ch: int, n_cls: int, size: int,
                 fused_gn: bool = False):
    """The script's expert: ``cfg.model``'s UNet (or DiT under
    ``model.kind=dit``) on ``in_ch`` channels with one ``n_cls`` label slot
    and the null token. ``fused_gn`` routes a UNet's GroupNorm + SiLU
    through the kernel (serving only)."""
    m = cfg.model
    if m.kind == "dit":
        return DiT(patch=m.patch, dim=m.hidden, depth=m.depth,
                   n_heads=m.n_heads, in_channels=in_ch, num_classes=(n_cls,),
                   null_token=True, img_size=size)
    return UNet(in_channels=in_ch, base_dim=m.base_dim,
                channel_mults=tuple(m.channel_mults), num_classes=(n_cls,),
                null_token=True, fused_gn=fused_gn)


def train_cell_experts(key, cfg, shape_model, color_model, schedule,
                       held, n_classes, init: Sequence[Any], *,
                       uncond_prob: float = 0.1,
                       factor0_grayscale: bool = False,
                       gray_norm: bool = False, gray_w=None,
                       hue_aug: float = 0.0, gprobe_steps: int = 0):
    """The two single-factor experts (and, with ``gprobe_steps``, the
    guidance probe) of one holdout setting, as the script's
    ``train_experts`` trains them. ``key``: the cell's key (the script's
    ``fold_in(key, 50 + cell)``): the factor-0 expert trains with
    ``fold_in(key, 2)``, the factor-1 expert with ``fold_in(key, 3)``, the
    hue gains draw from ``fold_in(key, 5)``, the guidance probe from
    ``fold_in(key, 7)``; a ``rng.Replay`` hands out recorded draws in the
    order they are made (gains, factor 0, factor 1, probe). ``held``:
    (images, factor-0 labels, factor-1 labels) on the device. ``init``:
    the two initial trees (the script initialises both from its root key).
    Returns (factor-0 tree, factor-1 tree, guidance-probe tree or None),
    on the images' device."""
    held_imgs, held_s, held_c = held
    dev = held_imgs.device
    kc = as_draws(key, dev)
    f0_src = held_imgs
    if hue_aug > 0.0:
        # random per-sample channel gains in [0, 1] pixel space: the black
        # background stays black, the shape's luma level varies
        gains = kc.fold_in(5).uniform((held_imgs.shape[0], 1, 1, 3),
                                      hue_aug, 1.0)
        f0_src = ((held_imgs + 1.0) * 0.5 * gains) * 2.0 - 1.0
    f0_imgs = (rgb_to_gray(f0_src, normalized=gray_norm, weights=gray_w)
               if factor0_grayscale else held_imgs)
    t = cfg.train
    trees = []
    for i, (model, imgs, labels, n_cls, name) in enumerate((
            (shape_model, f0_imgs, held_s, n_classes[0],
             f"factor-0 expert ({'gray' if factor0_grayscale else 'RGB'} "
             "| shape/digit)"),
            (color_model, held_imgs, held_c, n_classes[1],
             "factor-1 expert (RGB | color)"))):
        print(f"training {name} ...")
        p, losses = train.train_expert(
            kc.fold_in(2 + i), model.apply, _float_tree(init[i], model, dev),
            schedule, imgs, (labels,),
            steps=t.steps, batch_size=t.batch_size, lr=t.lr,
            uncond_prob=uncond_prob, null_labels=(n_cls,),
            ema_decay=t.ema_decay or None, snr_gamma=t.snr_gamma or None)
        print(f"  final loss {float(losses[-1]):.4f}")
        trees.append(p)
    gpp = None
    if gprobe_steps:
        # trained on the same holdout-filtered data as the experts and
        # VP-noised across t, so that log p(y | x_t) has a gradient along
        # the whole trajectory; its per-factor heads make the guidance
        # toward a held-out pair itself compositional
        print("training guidance probe (holdout-filtered, VP-noised) ...")
        _, gpp = ceval.train_probe(
            kc.fold_in(7), held_imgs, (held_s, held_c),
            num_classes=n_classes, steps=gprobe_steps, vp_schedule=schedule)
    return trees[0], trees[1], gpp


@dataclasses.dataclass(frozen=True)
class Composer:
    """One operator of the script's ``_sample`` over two experts: call it
    with the trees, (B,) labels, the two weights and a key. The operator's
    models come in as built (``fused_gn`` chosen by the caller; ``ito``
    needs False). ``gray_w``: the gray projection's channel weights (None:
    luma). ``avg`` and ``cg`` blend through the ``blend_eps`` kernel."""

    op: str
    shape_model: Any
    color_model: Any
    schedule: VPSchedule
    n_classes: tuple
    size: int
    n_steps: int
    f0_ch: int = 3
    gray_norm: bool = False
    gray_w: Optional[tuple] = None
    t_switch: Optional[float] = None
    corrector_steps: int = 0
    corrector_snr: float = 0.16
    corrector_t_max: float = 1.0
    gprobe_model: Optional[ProbeClassifier] = None

    def apply_f0(self, params, x, t, labels):
        """The factor-0 expert on the RGB state: through the gray
        projection and its lift (the adjoint under ``gray_norm``) for a
        1-channel expert."""
        if self.f0_ch == 1:
            return gray_to_rgb(self.shape_model.apply(
                params, rgb_to_gray(x, normalized=self.gray_norm,
                                    weights=self.gray_w), t, labels),
                normalized=self.gray_norm, weights=self.gray_w)
        return self.shape_model.apply(params, x, t, labels)

    def __call__(self, sp, cp, gpp, sl: torch.Tensor, cl: torch.Tensor,
                 weights: Sequence[float], key,
                 probes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, size, size, 3) float32 samples for the labels ``sl``,
        ``cl``. Draws: the initial noise from ``key``, ``ito``'s probes
        from a generator seeded from ``fold_in(key, 1)`` (``probes``:
        (n_steps, 2, B, ...) in their place), the corrector's from
        ``fold_in(key, 999)``. Runs under ``torch.no_grad()`` (``ito``'s
        jvps and the guidance gradient need it, not inference mode)."""
        with torch.no_grad():
            return self._sample(sp, cp, gpp, sl, cl, list(weights), key,
                                probes)

    def _sample(self, sp, cp, gpp, sl, cl, weights, key, probes):
        op, dev, bs = self.op, sl.device, sl.shape[0]
        draws = as_draws(key, dev)
        x_init = draws.normal((bs, self.size, self.size, 3))
        sm, cm = self.shape_model, self.color_model
        if op == "ito":
            # equal-density AND: kappa from jvp divergences of the
            # sigma-scaled scores -eps, probability-flow ODE
            def shape_score(x, t):
                return -self.apply_f0(sp, x, t, sl)

            def color_score(x, t):
                return -cm.apply(cp, x, t, cl)
            gen = (None if probes is not None or isinstance(draws, Replay)
                   else draws.fold_in(1).generator())
            return samplers.ito_kappa_ode(
                (shape_score, color_score), self.schedule, gen, x_init,
                self.n_steps, probes=probes)
        null_s = torch.full_like(sl, self.n_classes[0])
        null_c = torch.full_like(cl, self.n_classes[1])
        proj = self.gray_w or compose.LUMA_W
        w_dev = compose.constant(weights, torch.float32, dev)
        t_switch = self.t_switch

        def proj_strength(t):
            # t-scheduled projection: active in the high-noise
            # structure-forming phase (t >= t_switch) when scheduled
            return weights[0] if t_switch is None \
                else weights[0] * (t >= t_switch)

        def eps_fn(x, t):
            if op in ("proj", "proj_cg"):
                # projection substitution: the gray expert replaces the
                # noise's luma component, the chroma stays with the color
                # expert; weights[0] is the strength
                e_c = cm.apply(cp, x, t, cl)
                e_s = sm.apply(sp, rgb_to_gray(x, normalized=True,
                                               weights=self.gray_w), t, sl)
                return compose.projected(e_c, e_s, proj_strength(t),
                                         proj=proj)
            if op == "proj_cfg":
                # CFG inside each expert (strengths = weights), then the
                # projection substitution at weight 1
                xg = rgb_to_gray(x, normalized=True, weights=self.gray_w)
                e_s2 = sm.apply(sp, torch.cat([xg, xg]), t,
                                torch.cat([sl, null_s]))
                e_c2 = cm.apply(cp, torch.cat([x, x]), t,
                                torch.cat([cl, null_c]))
                e_s = e_s2[bs:] + weights[0] * (e_s2[:bs] - e_s2[bs:])
                e_c = e_c2[bs:] + weights[1] * (e_c2[:bs] - e_c2[bs:])
                return compose.projected(e_c, e_s, 1.0, proj=proj)
            if op == "cfg":
                x2 = torch.cat([x, x])
                e_s2 = self.apply_f0(sp, x2, t, torch.cat([sl, null_s]))
                e_c2 = cm.apply(cp, x2, t, torch.cat([cl, null_c]))
                eps_u = 0.5 * (e_s2[bs:] + e_c2[bs:])  # shared baseline
                return compose.cfg(eps_u, torch.stack([e_s2[:bs],
                                                       e_c2[:bs]]), weights)
            stack = torch.stack([self.apply_f0(sp, x, t, sl),
                                 cm.apply(cp, x, t, cl)])
            if op == "cg":
                # the equal-weight average, steered by the probe
                return blend_eps(stack, compose.constant((1.0, 1.0),
                                                     torch.float32, dev))
            return blend_eps(stack, w_dev)

        if op in ("cg", "proj_cg"):
            gm = self.gprobe_model

            def logp_fn(x, t):
                lg_s, lg_c = gm.apply(gpp, x)
                return (torch.log_softmax(lg_s, -1).gather(
                    1, sl[:, None])[:, 0] + torch.log_softmax(
                        lg_c, -1).gather(1, cl[:, None])[:, 0])

            if op == "proj_cg" and t_switch is not None:
                # proj early, guidance late: the probe's gradients are
                # informative on nearly clean structure
                def scale(t):
                    return weights[1] * (t < t_switch)
            else:
                scale = weights[0] if op == "cg" else weights[1]
            eps_fn = samplers.make_classifier_guided_eps_fn(
                eps_fn, self.schedule, logp_fn, scale=scale)
        return samplers.ddim(eps_fn, self.schedule, x_init, self.n_steps,
                             key=draws.fold_in(999),
                             corrector_steps=self.corrector_steps,
                             corrector_snr=self.corrector_snr,
                             corrector_t_max=self.corrector_t_max)


def build_composer(op: str, cfg, n_classes: tuple, size: int, n_steps: int,
                   f0_ch: int = 3, fused_gn: bool = True,
                   **fields) -> Composer:
    """The :class:`Composer` of operator ``op`` on ``cfg``'s experts (a
    ``f0_ch``-channel factor-0 expert) and schedule, with the guidance
    probe's model for ``cg`` / ``proj_cg``. The experts' GroupNorm + SiLU
    runs the kernel (``fused_gn``) except under ``ito``, whose jvps the
    kernels refuse. ``fields``: the Composer's other fields."""
    gn = fused_gn and op != "ito"  # kernels have no forward-mode rule
    sm, cm = (expert_model(cfg, ch, n, size, gn)
              for ch, n in ((f0_ch, n_classes[0]), (3, n_classes[1])))
    gprobe = (ProbeClassifier(n_classes, in_channels=3)
              if op in ("cg", "proj_cg") else None)
    return Composer(op, sm, cm, VPSchedule(kind=cfg.schedule.kind),
                    n_classes, size, n_steps, f0_ch=f0_ch,
                    gprobe_model=gprobe, **fields)


def combo_scores(probes: Sequence, samples: torch.Tensor, target,
                 holdout) -> dict:
    """The script's score row of one combination: the first probe's
    compositional scores, each further probe's joint accuracy and margin
    and its agreement with the first on joint hits, and ``held_out``."""
    probe, probe_params = probes[0]
    scores = ceval.compositional_scores(probe, probe_params, samples, target)
    hits0 = None
    for pi, (pm, pp) in enumerate(probes[1:], start=2):
        s2 = ceval.compositional_scores(pm, pp, samples, target)
        scores[f"probe{pi}_joint_acc"] = s2["joint_acc"]
        scores[f"probe{pi}_joint_target_prob"] = s2["joint_target_prob"]
        if hits0 is None:
            hits0 = ceval.joint_hits(probe, probe_params, samples, target)
        h2 = ceval.joint_hits(pm, pp, samples, target)
        scores[f"joint_acc_agree_p{pi}"] = float((hits0 & h2).float().mean())
    scores["held_out"] = tuple(target) in holdout
    return scores


def aggregate(cells: dict) -> dict:
    """Per operator tag over a sweep's cells: mean / min / max held-out
    joint accuracy, mean seen joint accuracy and the number of cells."""
    out = {}
    for wtag in next(iter(cells.values())):
        held = [c[wtag]["heldout_joint_acc"] for c in cells.values()
                if wtag in c]
        seen = [c[wtag]["seen_joint_acc"] for c in cells.values()
                if wtag in c]
        out[wtag] = {"heldout_joint_acc_mean": sum(held) / len(held),
                     "heldout_joint_acc_min": min(held),
                     "heldout_joint_acc_max": max(held),
                     "seen_joint_acc_mean": sum(seen) / len(seen),
                     "n_cells": len(held)}
    return out


def eval_composition(preset: str = "shapes_ddim", dataset: str = "shapes",
                     holdout=((2, 2),), holdout_sweep=None,
                     samples_per_combo: int = 32, probe_steps: int = 1200,
                     probe_noise: float = 0.1, probe_seeds: int = 1,
                     n_steps: int = 200, w_shape: float = 1.0,
                     w_color: float = 1.0, weight_grid=None, op: str = "avg",
                     t_switch: Optional[float] = None,
                     factor0_grayscale: bool = False, gray_norm: bool = False,
                     gray_proj: str = "luma", hue_aug: float = 0.0,
                     corrector_steps: int = 0, corrector_snr: float = 0.16,
                     corrector_t_max: float = 1.0, uncond_prob: float = 0.1,
                     sanity: bool = False, out: str = "outputs",
                     seed: int = 0, overrides: Sequence[str] = (),
                     device=None) -> dict:
    """The protocol of ``scripts/eval_composition.py``; the keyword
    arguments are its flags (``holdout``: pairs; ``holdout_sweep``: "all"
    or a list of pairs, one single-cell holdout each; ``weight_grid``: [w0,
    w1] pairs; ``op``: a comma list of ``KNOWN_OPS``) and ``overrides`` its
    dotted config overrides. ``sanity`` makes the script's cuts (the
    config's, 200 probe steps, 8 samples a combination, at most 20 steps).

    1. The data: ``shapes`` at the preset's size, or ``colored_mnist``
       (28 x 28, random colors, key ``fold_in(seed, 7)``); the probes see
       all of it, the experts the holdout-filtered part.
    2. ``probe_seeds`` evaluation probes (bf16, noise-augmented), probe i
       from ``fold_in(seed, 1 + 1000 i)``.
    3. Per holdout cell c: the two experts (``train_cell_experts``, key
       ``fold_in(seed, 50 + c)``, both initialised from ``seed``), and for
       ``cg`` / ``proj_cg`` the guidance probe.
    4. Per operator and weight pair (settings that give the same samples
       run once, ``canonical``), every combination (s, c) sampled from
       ``fold_in(seed, 10 + s n_1 + c)`` (:class:`Composer`) and scored
       (``combo_scores``); the 4 first samples of each go to a grid PNG.

    Probes and experts are cached under ``results/`` as
    ``cache_<tag>.pt`` (cell c's experts ``cache_experts_<dataset>_cell<c>_
    <hash>.pt``: (factor 0, factor 1, guidance probe or None)), the hash
    over every setting that shapes them (``cached``). A sweep resumes from
    its ``.partial.json``.

    Writes and returns the script's report: ``compositional_eval_<dataset>
    _<ops>.json`` (``holdout``, ``ops``: per setting tag the combos' scores
    with ``heldout_joint_acc`` and ``seen_joint_acc``) or, for a sweep,
    ``compositional_sweep_<dataset>_<ops>.json`` with ``cells`` and
    ``aggregate``. The routes per operator are in the module's docstring
    (:func:`build_composer`). ``device=None`` is the CUDA card."""
    weight_grid = ([list(w) for w in weight_grid] if weight_grid
                   else [[w_shape, w_color]])
    ops = check_ops(op, uncond_prob, factor0_grayscale, gray_norm, hue_aug,
                    weight_grid)
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    if sanity:
        cfg.train.sanity = True
        cfg.apply_sanity()
        probe_steps, samples_per_combo = 200, 8
        n_steps = min(n_steps, 20)
    size = cfg.data.img_size
    schedule = VPSchedule(kind=cfg.schedule.kind)
    mgr = CheckpointManager(out, "eval_composition")
    if dataset == "shapes":
        n_classes = (3, 3)

        def held_data(hold):
            return data.make_shapes_dataset(cfg.data.n, size, holdout=hold,
                                            device=dev)
    elif dataset == "colored_mnist":
        n_classes, size = (10, 3), 28

        def held_data(hold):
            return data.colored_mnist(_subkey(seed, 7), cfg.data.n,
                                      color_rule="random", holdout=hold,
                                      device=dev)
    else:
        raise ValueError(f"dataset must be 'shapes' or 'colored_mnist', got "
                         f"{dataset!r}")
    full_imgs, full_s, full_c = held_data(None)
    if holdout_sweep is None:
        cells = [[tuple(h) for h in holdout]]
    elif holdout_sweep == "all":
        cells = [[(s, c)] for s in range(n_classes[0])
                 for c in range(n_classes[1])]
    else:
        cells = [[tuple(p)] for p in holdout_sweep]

    def from_cache(tag: str, build):
        return cached(os.path.join(mgr.results_dir, f"cache_{tag}.pt"),
                      build, dev)

    probe_hash = cfg_hash({"probe_steps": probe_steps,
                           "probe_noise": probe_noise, "data_n": cfg.data.n,
                           "size": size, "seed": seed})
    probes = []
    for i in range(probe_seeds):
        print(f"training eval probe {i} ...")
        pm = ProbeClassifier(n_classes, 32, torch.bfloat16, in_channels=3)
        pp = from_cache(
            f"probe{i}_{dataset}_{probe_hash}",
            lambda i=i: ceval.train_probe(
                _subkey(seed, 1 + 1000 * i), full_imgs, (full_s, full_c),
                num_classes=n_classes, steps=probe_steps,
                noise_aug=probe_noise)[1])
        acc = ceval.probe_accuracy(pm, pp, full_imgs[:512],
                                   (full_s[:512], full_c[:512]))
        print(f"probe {i} held-in accuracy: {acc}")
        probes.append((pm, pp))

    f0_ch = 1 if factor0_grayscale else 3
    gray_w = (1.0, 1.0, 1.0) if gray_proj == "equal" else None
    need_gprobe = bool({"cg", "proj_cg"} & set(ops))
    train_models = [expert_model(cfg, ch, n, size)
                    for ch, n in ((f0_ch, n_classes[0]), (3, n_classes[1]))]
    bs = samples_per_combo

    composers = {o: build_composer(
        o, cfg, n_classes, size, n_steps, f0_ch=f0_ch, gray_norm=gray_norm,
        gray_w=gray_w, t_switch=t_switch, corrector_steps=corrector_steps,
        corrector_snr=corrector_snr, corrector_t_max=corrector_t_max)
        for o in ops}
    t = cfg.train

    def evaluate_cell(hold, cell_idx: int) -> dict:
        held = held_data(hold)
        expert_hash = cfg_hash({
            "holdout": sorted(list(h) for h in hold),
            "train": {"steps": t.steps, "batch_size": t.batch_size,
                      "lr": t.lr, "ema": t.ema_decay,
                      "snr_gamma": t.snr_gamma},
            "model": str(cfg.model), "uncond_prob": uncond_prob,
            "hue_aug": hue_aug, "f0_gray": factor0_grayscale,
            "gray_norm": gray_norm, "gray_proj": gray_proj,
            "gprobe": (probe_steps, probe_noise) if need_gprobe else None,
            "data_n": cfg.data.n, "size": size, "seed": seed})
        sp, cp, gpp = from_cache(
            f"experts_{dataset}_cell{cell_idx}_{expert_hash}",
            lambda: train_cell_experts(
                _subkey(seed, 50 + cell_idx), cfg, *train_models, schedule,
                held, n_classes,
                [init_params(m, seed, dev) for m in train_models],
                uncond_prob=uncond_prob, factor0_grayscale=factor0_grayscale,
                gray_norm=gray_norm, gray_w=gray_w, hue_aug=hue_aug,
                gprobe_steps=probe_steps if need_gprobe else 0))
        ops_report, seen_settings = {}, set()
        cell_tag = ("" if len(cells) == 1 else
                    "cell" + "_".join(f"{h[0]}-{h[1]}" for h in hold) + "_")
        for o in ops:
            for wpair in weight_grid:
                key_c = canonical(o, wpair)
                if key_c in seen_settings:
                    print(f"skip {o} w={wpair}: identical to an evaluated "
                          "setting (ito ignores weights; avg is "
                          "scale-invariant)")
                    continue
                seen_settings.add(key_c)
                wtag = (o if len(weight_grid) == 1
                        else f"{o}_w{wpair[0]:g}x{wpair[1]:g}")
                report = {"combos": {}, "weights": list(wpair)}
                grids = []
                print(f"--- operator: {wtag} ---")
                for s_lab in range(n_classes[0]):
                    for c_lab in range(n_classes[1]):
                        sl = torch.full((bs,), s_lab, dtype=torch.long,
                                        device=dev)
                        cl = torch.full((bs,), c_lab, dtype=torch.long,
                                        device=dev)
                        samples = composers[o](
                            sp, cp, gpp, sl, cl, wpair,
                            _subkey(seed, 10 + s_lab * n_classes[1] + c_lab))
                        grids.append(samples[:4])
                        scores = combo_scores(probes, samples,
                                              (s_lab, c_lab), hold)
                        report["combos"][f"{s_lab},{c_lab}"] = scores
                        tag = " (HELD OUT)" if scores["held_out"] else ""
                        print(f"shape={s_lab} color={c_lab}{tag}: "
                              f"joint_acc={scores['joint_acc']:.3f} "
                              f"shape_acc={scores['factor_0_acc']:.3f} "
                              f"color_acc={scores['factor_1_acc']:.3f} "
                              f"margin={scores['joint_target_prob']:.3f}")
                held_acc = [v["joint_acc"] for v in
                            report["combos"].values() if v["held_out"]]
                seen_acc = [v["joint_acc"] for v in
                            report["combos"].values() if not v["held_out"]]
                report["heldout_joint_acc"] = (sum(held_acc)
                                               / max(len(held_acc), 1))
                report["seen_joint_acc"] = (sum(seen_acc)
                                            / max(len(seen_acc), 1))
                grid_path = save_grid(
                    torch.cat(grids), os.path.join(
                        mgr.results_dir, f"eval_samples_grid_{dataset}_"
                        f"{op.replace(',', '-')}_{cell_tag}{wtag}.png"),
                    nrow=12)
                print(f"[{cell_tag}{wtag}] held-out joint acc "
                      f"{report['heldout_joint_acc']:.3f} | seen joint acc "
                      f"{report['seen_joint_acc']:.3f} | grid {grid_path}")
                ops_report[wtag] = report
        return ops_report

    optag = op.replace(",", "-")
    common = {"dataset": dataset, "weight_grid": weight_grid,
              "t_switch": t_switch, "hue_aug": hue_aug,
              "probe_seeds": probe_seeds}
    if len(cells) == 1:
        full_report = {"holdout": [list(h) for h in cells[0]], **common,
                       "ops": evaluate_cell(cells[0], 0)}
        path = os.path.join(mgr.results_dir,
                            f"compositional_eval_{dataset}_{optag}.json")
    else:
        full_report = {"sweep_cells": [[list(h) for h in c] for c in cells],
                       **common, "cells": {}, "aggregate": {}}
        # each finished cell goes to a .partial file: a killed sweep run
        # again skips the cells it already trained and scored
        partial_path = os.path.join(
            mgr.results_dir,
            f"compositional_sweep_{dataset}_{optag}.partial.json")
        prev = resume(partial_path, lambda p: (
            p.get("sweep_cells") == full_report["sweep_cells"]
            and p.get("weight_grid") == weight_grid))
        if prev:
            full_report["cells"] = prev.get("cells", {})
            print(f"resuming sweep: {len(full_report['cells'])} cell(s) "
                  f"loaded from {partial_path}")
        for i, hold in enumerate(cells):
            ctag = ",".join(f"{h[0]}-{h[1]}" for h in hold)
            if ctag in full_report["cells"]:
                print(f"===== holdout cell {ctag}: cached (resume) =====")
                continue
            print(f"===== holdout cell {ctag} ({i + 1}/{len(cells)}) =====")
            full_report["cells"][ctag] = evaluate_cell(hold, i)
            write_json(partial_path, full_report, indent=None)
        full_report["aggregate"] = aggregate(full_report["cells"])
        for wtag, a in full_report["aggregate"].items():
            print(f"[sweep {wtag}] held-out joint "
                  f"{a['heldout_joint_acc_mean']:.3f} "
                  f"(min {a['heldout_joint_acc_min']:.3f}, "
                  f"max {a['heldout_joint_acc_max']:.3f}, "
                  f"n={a['n_cells']})")
        path = os.path.join(mgr.results_dir,
                            f"compositional_sweep_{dataset}_{optag}.json")
    write_json(path, full_report)
    print(f"report saved to {path}")
    return full_report
