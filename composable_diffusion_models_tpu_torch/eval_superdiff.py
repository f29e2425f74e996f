"""SUPERDIFF OR / AND measured on image datasets: the two protocols of
``scripts/eval_superdiff.py``.

* ``mixture``: two unconditional colored-MNIST experts on the digit halves
  {0-4} and {5-9}, composed by OR (one job per softmax temperature), the
  heuristic AND and the rigorous AND; a 10-class probe trained on all the
  digits gives the composed samples' per-class histogram and the share
  from the first expert's half (the OR target is the 50/50 mixture).
* ``factored``: two single-factor conditional experts (shape or digit |
  color) trained on holdout-filtered data; every combination composed by
  the rigorous AND and by OR, scored by a two-factor probe as
  ``eval_composition`` scores it.

The experts train on ``DDPMSchedule(T)`` (``train.train_expert``, EMA)
and sample over the whole T-step trajectory. Every expert forward of the
samplers runs the UNet's GroupNorm + SiLU through the ``groupnorm_silu``
kernel and its two-part form (``fused_gn=True``): 8 + 2 launches a
forward, 2 forwards a step.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from . import data, resolve_device, samplers, train
from . import eval as ceval
from .builders import init_params
from .entry import _ddpm_stack_fn, _subkey
from .eval_composition import cached, resume, write_json
from .experts import ExpertStack
from .models.probe import ProbeClassifier
from .models.unet import UNet
from .rng import Replay, as_draws
from .schedules import DDPMSchedule
from .utils.viz import save_grid

PROTOCOLS = ("mixture", "factored")
MIXTURE_SUBSETS = ((0, 1, 2, 3, 4), (5, 6, 7, 8, 9))


def train_one(key, model: UNet, imgs: torch.Tensor, labels, schedule, *,
              steps: int, batch_size: int, lr: float, ema: float):
    """The script's ``train_one``: the model initialised from ``key``,
    trained with ``fold_in(key, 1)``; returns the EMA tree (``ema`` 0: the
    last one)."""
    p, losses = train.train_expert(
        _subkey(key, 1), model.apply, init_params(model, key, imgs.device),
        schedule, imgs, tuple(labels),
        steps=steps, batch_size=batch_size, lr=lr, ema_decay=ema or None)
    print(f"  final loss {float(losses[-1]):.4f}")
    return p


def start(key, shape, noise_shape, device):
    """(x_init, generator, noise) of one sampler call as the script keys
    it: the initial noise from ``fold_in(key, 1)``, the sampler's draws
    from a generator seeded from ``key``; a ``rng.Replay`` hands out the
    initial noise and then the (T, ...) noise tensor in their place."""
    draws = as_draws(key, device)
    x = draws.fold_in(1).normal(shape)
    if isinstance(draws, Replay):
        return x, None, draws.normal(noise_shape)
    return x, draws.generator(), None


def parse_temp(tok: str, d: int, T: int) -> float:
    """An OR temperature: a float, or the tokens ``1/d`` and ``1/dT``
    resolved against the image dimension d and T."""
    tok = tok.strip()
    if tok == "1/d":
        return 1.0 / d
    if tok == "1/dT":
        return 1.0 / (d * T)
    return float(tok)


def mixture_stack(params, base_dim: int, T: int, device,
                  fused_gn: bool = True):
    """The mixture experts' ``eps_stack_fn(x, ti)``: the unconditional
    UNets of ``params`` (base ``base_dim``, (1, 2, 4)) over the T-step
    schedule, their GroupNorm + SiLU through the kernel (``fused_gn``)."""
    model = UNet(in_channels=3, base_dim=base_dim, channel_mults=(1, 2, 4),
                 fused_gn=fused_gn)
    return _ddpm_stack_fn(ExpertStack(model.apply, params), T, [], device,
                          torch.float32)


def mixture_jobs(eps_stack_fn, schedule: DDPMSchedule, bs: int, temps,
                 device) -> list:
    """[(name, job)] of the mixture protocol: OR at each temperature (named
    ``OR`` alone, else ``OR_temp<t>``), ``AND_heuristic`` and
    ``AND_rigorous``; ``job(key)`` returns the (bs, 28, 28, 3) samples
    before the clip (the protocol clips them)."""
    shape, T = (bs, 28, 28, 3), schedule.num_timesteps

    def or_job(temp):
        def job(k):
            x, gen, noise = start(k, shape, (T,) + shape, device)
            return samplers.superdiff(eps_stack_fn, schedule, gen, x,
                                      operation="OR", temp=temp, clip=None,
                                      noise=noise)
        return job

    def and_heuristic(k):
        x, gen, noise = start(k, shape, (T,) + shape, device)
        return samplers.superdiff(eps_stack_fn, schedule, gen, x,
                                  operation="AND", clip=None, noise=noise)

    def and_rigorous(k):
        x, gen, noise = start(k, shape, (T, 2) + shape, device)
        return samplers.superdiff_and_solve(eps_stack_fn, schedule, gen, x,
                                            mode="AND", noise=noise)

    jobs = [(f"OR_temp{t:g}" if len(temps) > 1 else "OR", or_job(t))
            for t in temps]
    return jobs + [("AND_heuristic", and_heuristic),
                   ("AND_rigorous", and_rigorous)]


@torch.no_grad()
def mixture_row(probe: ProbeClassifier, probe_params,
                samples: torch.Tensor) -> dict:
    """The digit probe's verdict on composed samples: the per-class
    histogram (4 places), the share predicted in the first half (digits
    0-4), its distance from 0.5 and the mean top probability."""
    probs = torch.softmax(probe.apply(probe_params, samples)[0], dim=-1)
    preds = probs.argmax(dim=-1)
    hist = torch.bincount(preds, minlength=10) / samples.shape[0]
    frac_a = float((preds < 5).float().mean())
    return {"class_hist": [round(float(h), 4) for h in hist.cpu()],
            "frac_expert_a": frac_a,
            "mixture_balance_error": abs(0.5 - frac_a),
            "mean_max_prob": float(probs.max(dim=-1).values.mean())}


def run_mixture(key, *, T: int, train_steps: int, batch_size: int,
                lr: float, ema: float, base_dim: int, temp: float,
                temp_sweep: str, probe_steps: int, n_samples: int,
                data_n: int, seed: int, out_dir: str, device) -> dict:
    """The mixture protocol (the arguments are :func:`eval_superdiff`'s).
    Keys as the script's: the probe's data ``fold_in(key, 1)``, the probe
    ``fold_in(key, 2)``, expert i's data ``fold_in(key, 3 + i)`` and tree
    ``fold_in(key, 10 + i)``, every job ``fold_in(key, 50)``."""
    dev = device
    schedule = DDPMSchedule(num_timesteps=T)
    full_imgs, full_d, _ = data.colored_mnist(_subkey(key, 1), data_n,
                                              device=dev)

    def from_cache(tag, build):
        return cached(os.path.join(out_dir, f"cache_{tag}.pt"), build, dev)

    recipe = (f"s{train_steps}_b{batch_size}_w{base_dim}_n{data_n}"
              f"_seed{seed}")
    print("training 10-class digit probe on full colored data ...")
    probe = ProbeClassifier((10,), 32, torch.bfloat16, in_channels=3)
    probe_params = from_cache(
        f"mixture_probe_p{probe_steps}_n{data_n}_seed{seed}",
        lambda: ceval.train_probe(
            _subkey(key, 2), full_imgs, (full_d,), num_classes=(10,),
            steps=probe_steps, noise_aug=0.1)[1])
    print("probe held-in:", ceval.probe_accuracy(
        probe, probe_params, full_imgs[:512], (full_d[:512],)))
    model = UNet(in_channels=3, base_dim=base_dim, channel_mults=(1, 2, 4))
    params = []
    for i, sub in enumerate(MIXTURE_SUBSETS):
        print(f"training unconditional expert {i} (digits {sub}) ...")

        def build(i=i, sub=sub):
            imgs, _, _ = data.colored_mnist(_subkey(key, 3 + i), data_n,
                                            classes=list(sub), device=dev)
            return train_one(_subkey(key, 10 + i), model, imgs, (), schedule,
                             steps=train_steps, batch_size=batch_size, lr=lr,
                             ema=ema)
        params.append(from_cache(f"mixture_expert{i}_{recipe}", build))
    eps_stack_fn = mixture_stack(params, base_dim, T, dev)
    bs, d = n_samples, 28 * 28 * 3
    report = {"protocol": "mixture",
              "subsets": [list(s) for s in MIXTURE_SUBSETS], "T": T,
              "train_steps": train_steps, "dim": d, "ops": {}}
    # log_q sums <dx, s> over the T steps of a d-dim image, so its scale
    # grows with d and T: the sweep divides it by 1, 1/d, 1/(d T), ...
    temps = ([parse_temp(s, d, T) for s in temp_sweep.split(",")]
             if temp_sweep else [temp])
    partial_path = os.path.join(out_dir,
                                "superdiff_mixture_colored_mnist.partial.json")
    prev = resume(partial_path, lambda p: (p.get("train_steps") == train_steps
                                           and p.get("T") == T))
    if prev:
        report["ops"] = prev.get("ops", {})
        print(f"resuming mixture eval: {len(report['ops'])} job(s) loaded "
              f"from {partial_path}")
    for name, job in mixture_jobs(eps_stack_fn, schedule, bs, temps, dev):
        if name in report["ops"]:
            print(f"{name}: cached (resume)")
            continue
        with torch.no_grad():
            samples = job(_subkey(key, 50)).clamp(-1.0, 1.0)
        row = mixture_row(probe, probe_params, samples)
        report["ops"][name] = row
        save_grid(samples[:64], os.path.join(out_dir, f"mixture_{name}.png"),
                  nrow=8)
        print(f"{name}: frac_a={row['frac_expert_a']:.3f} "
              f"balance_err={row['mixture_balance_error']:.3f} "
              f"conf={row['mean_max_prob']:.3f}")
        write_json(partial_path, report, indent=None)
    path = os.path.join(out_dir, "superdiff_mixture_colored_mnist.json")
    write_json(path, report)
    print(f"report saved to {path}")
    return report


def run_factored(key, *, dataset: str, holdout, T: int, train_steps: int,
                 batch_size: int, lr: float, ema: float, base_dim: int,
                 temp: float, probe_steps: int, samples_per_combo: int,
                 data_n: int, out_dir: str, device) -> dict:
    """The factored protocol (the arguments are :func:`eval_superdiff`'s).
    Keys as the script's: the colored digits ``fold_in(key, 7)``, the probe
    ``fold_in(key, 1)``, the experts ``fold_in(key, 2)`` and
    ``fold_in(key, 3)``, combination (f0, f1) ``fold_in(key, 100 + f0 n_1 +
    f1)``."""
    dev = device
    schedule = DDPMSchedule(num_timesteps=T)
    holdout = [tuple(h) for h in holdout]
    if dataset == "shapes":
        n_classes, size = (3, 3), 64
        full = data.make_shapes_dataset(data_n, size, device=dev)
        held = data.make_shapes_dataset(data_n, size, holdout=holdout,
                                        device=dev)
    else:
        n_classes, size = (10, 3), 28
        full, held = (data.colored_mnist(_subkey(key, 7), data_n,
                                         color_rule="random", holdout=h,
                                         device=dev)
                      for h in (None, holdout))
    full_imgs, full_f0, full_f1 = full
    held_imgs, held_f0, held_f1 = held
    print("training eval probe on FULL data ...")
    probe = ProbeClassifier(n_classes, 32, torch.bfloat16, in_channels=3)
    probe_params = ceval.train_probe(
        _subkey(key, 1), full_imgs, (full_f0, full_f1),
        num_classes=n_classes, steps=probe_steps, noise_aug=0.1)[1]
    print("probe held-in:", ceval.probe_accuracy(
        probe, probe_params, full_imgs[:512],
        (full_f0[:512], full_f1[:512])))
    models = [UNet(in_channels=3, base_dim=base_dim, channel_mults=(1, 2, 4),
                   num_classes=(n,)) for n in n_classes]
    params = []
    for i, labels in enumerate((held_f0, held_f1)):
        print(f"training factor-{i} conditional expert ...")
        params.append(train_one(
            _subkey(key, 2 + i), models[i], held_imgs, (labels,), schedule,
            steps=train_steps, batch_size=batch_size, lr=lr, ema=ema))
    p0, p1 = params
    m0, m1 = (dataclasses.replace(m, fused_gn=True) for m in models)
    t_col = torch.arange(T, dtype=torch.float32, device=dev)
    bs, shape = samples_per_combo, (samples_per_combo, size, size, 3)

    def sample(l0, l1, k, mode):
        def eps_stack_fn(x, ti):
            t = t_col[ti]
            return torch.stack([m0.apply(p0, x, t, l0),
                                m1.apply(p1, x, t, l1)])
        if mode == "AND":
            x, gen, noise = start(k, shape, (T, 2) + shape, dev)
            return samplers.superdiff_and_solve(eps_stack_fn, schedule, gen,
                                                x, mode="AND", noise=noise)
        x, gen, noise = start(k, shape, (T,) + shape, dev)
        return samplers.superdiff(eps_stack_fn, schedule, gen, x,
                                  operation="OR", temp=temp, noise=noise)

    full_report = {"protocol": "factored", "dataset": dataset,
                   "holdout": [list(h) for h in holdout], "T": T,
                   "train_steps": train_steps, "ops": {}}
    for mode in ("AND", "OR"):
        report, grids = {"combos": {}}, []
        print(f"--- superdiff {mode} ---")
        for f0 in range(n_classes[0]):
            for f1 in range(n_classes[1]):
                with torch.no_grad():
                    samples = sample(
                        torch.full((bs,), f0, dtype=torch.long, device=dev),
                        torch.full((bs,), f1, dtype=torch.long, device=dev),
                        _subkey(key, 100 + f0 * n_classes[1] + f1),
                        mode).clamp(-1.0, 1.0)
                grids.append(samples[:4])
                scores = ceval.compositional_scores(probe, probe_params,
                                                    samples, (f0, f1))
                scores["held_out"] = (f0, f1) in holdout
                report["combos"][f"{f0},{f1}"] = scores
                tag = " (HELD OUT)" if scores["held_out"] else ""
                print(f"f0={f0} f1={f1}{tag}: "
                      f"joint={scores['joint_acc']:.3f}")
        held_accs = [v["joint_acc"] for v in report["combos"].values()
                     if v["held_out"]]
        seen_accs = [v["joint_acc"] for v in report["combos"].values()
                     if not v["held_out"]]
        report["heldout_joint_acc"] = sum(held_accs) / max(len(held_accs), 1)
        report["seen_joint_acc"] = sum(seen_accs) / max(len(seen_accs), 1)
        save_grid(torch.cat(grids), os.path.join(
            out_dir, f"factored_{dataset}_{mode}.png"), nrow=12)
        print(f"[{mode}] held-out joint {report['heldout_joint_acc']:.3f} "
              f"| seen joint {report['seen_joint_acc']:.3f}")
        full_report["ops"][mode] = report
    path = os.path.join(out_dir, f"superdiff_factored_{dataset}.json")
    write_json(path, full_report)
    print(f"report saved to {path}")
    return full_report


def eval_superdiff(protocol: str = "mixture", dataset: str = "shapes",
                   holdout=None, T: int = 1000, train_steps: int = 12000,
                   batch_size: int = 256, lr: float = 2e-4,
                   ema: float = 0.999, base_dim: int = 64, temp: float = 1.0,
                   temp_sweep: str = "", probe_steps: int = 2000,
                   n_samples: int = 256, samples_per_combo: int = 64,
                   data_n: int = 8192, sanity: bool = False,
                   out: str = "outputs/superdiff_eval", seed: int = 0,
                   key=None, device=None) -> dict:
    """The protocols of ``scripts/eval_superdiff.py``; the keyword
    arguments are its flags. ``holdout`` (factored): pairs, by default
    [[2, 2]] for shapes and [[7, 2]] for colored MNIST. ``sanity`` makes
    the script's cuts (40 training and probe steps, T 8, 8 mixture samples
    and 4 a combination, 256 images, base 8, batch 16).

    ``mixture`` (:func:`run_mixture`) caches its probe and experts under
    ``out`` as ``cache_<tag>.pt`` and resumes its jobs from a
    ``.partial.json``; both write the script's report
    (``superdiff_mixture_colored_mnist.json``,
    ``superdiff_factored_<dataset>.json``) and sample grids, and return
    it. ``key``: the root key (``seed`` by default; a ``rng.Replay``
    replays the draws in the order they are made). ``device=None`` is the
    CUDA card."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"protocol must be one of {PROTOCOLS}, got "
                         f"{protocol!r}")
    dev = resolve_device(device)
    if holdout is None:
        holdout = [[2, 2]] if dataset == "shapes" else [[7, 2]]
    if sanity:
        train_steps, probe_steps, T = 40, 40, 8
        n_samples, samples_per_combo = 8, 4
        data_n, base_dim, batch_size = 256, 8, 16
    os.makedirs(out, exist_ok=True)
    key = seed if key is None else key
    common = dict(T=T, train_steps=train_steps, batch_size=batch_size, lr=lr,
                  ema=ema, base_dim=base_dim, temp=temp,
                  probe_steps=probe_steps, data_n=data_n, out_dir=out,
                  device=dev)
    if protocol == "mixture":
        return run_mixture(key, temp_sweep=temp_sweep, n_samples=n_samples,
                           seed=seed, **common)
    return run_factored(key, dataset=dataset, holdout=holdout,
                        samples_per_combo=samples_per_combo, **common)
