"""Held-out compositional generalization of the composition operators:
``scripts/eval_composition.py`` over ``eval_composition.eval_composition``
(the port's module, imported by its absolute name). Two single-factor
experts trained on holdout-filtered data, composed by each operator of
``--op`` over every (factor 0, factor 1) combination and scored by
independent probes. On the card the UNets' GroupNorm + SiLU run through the
``groupnorm_silu`` kernel and ``avg``'s blend through ``blend_eps``; ``ito``
and the guided operators run forward-mode AD or gradients, through the
PyTorch ops. Writes ``compositional_eval_<dataset>_<ops>.json`` (a sweep:
``compositional_sweep_<dataset>_<ops>.json``) and the grids under
``<out>/eval_composition/run_0/results``. An inconsistent set of flags
raises the entry point's ValueError before any work.
"""

from __future__ import annotations

import argparse
import json
import sys

from composable_diffusion_models_tpu_torch import eval_composition
from composable_diffusion_models_tpu_torch.scripts._common import (
    add_runtime_flags, finite, profiled, start)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Score composition operators "
                                             "on held-out combinations.")
    ap.add_argument("--preset", default="shapes_ddim")
    ap.add_argument("--dataset", default="shapes",
                    choices=["shapes", "colored_mnist"],
                    help="factored dataset: shapes (shape x color, 3x3) or "
                         "colored_mnist (digit x color, 10x3)")
    ap.add_argument("--holdout", default="[[2,2]]",
                    help="JSON list of held-out (factor0, factor1) pairs")
    ap.add_argument("--holdout_sweep", default=None,
                    help="sweep the held-out cell: 'all' runs the protocol "
                         "once per single-cell holdout over every "
                         "combination; a JSON list (e.g. [[7,2],[3,0]]) "
                         "sweeps those cells. Overrides --holdout; reports "
                         "mean/min/max held-out joint accuracy per operator "
                         "across cells (single-cell rankings are "
                         "single-sample claims)")
    ap.add_argument("--samples_per_combo", type=int, default=32)
    ap.add_argument("--probe_steps", type=int, default=1200)
    ap.add_argument("--probe_noise", type=float, default=0.1,
                    help="Gaussian noise aug for probe robustness")
    ap.add_argument("--probe_seeds", type=int, default=1,
                    help=">1 trains extra independently-seeded eval probes: "
                         "reports per-probe joint accuracy and cross-probe "
                         "agreement (a single probe leaves the metric "
                         "gameable by samples only that probe credits)")
    ap.add_argument("--n_steps", type=int, default=200)
    ap.add_argument("--w_shape", type=float, default=1.0)
    ap.add_argument("--w_color", type=float, default=1.0)
    ap.add_argument("--weight_grid", default=None,
                    help="JSON list of [w_shape, w_color] pairs to sweep on "
                         "the SAME trained experts; overrides "
                         "--w_shape/--w_color")
    ap.add_argument("--op", default="avg",
                    help="comma list of composition operators to evaluate on "
                         "the same trained experts: avg (weighted score "
                         "average, reference op-1), ito (equal-density-path "
                         "AND via jvp-divergence kappa + prob-flow ODE, "
                         "reference op-2), cfg (CFG conjunction "
                         "eps_u + sum_i w_i (eps_i - eps_u) with eps_u = "
                         "mean of the experts' null-token outputs, "
                         "reference op-5, _5.py:313-325), proj/proj_cfg "
                         "(projection substitution, compose.projected — "
                         "needs --factor0_grayscale --gray_norm), "
                         "cg (equal-weight avg steered by a VP-noised "
                         "holdout-filtered guidance probe at scale w[0] — "
                         "beyond-reference classifier guidance), and/or "
                         "proj_cg (projection substitution at strength w[0] "
                         "PLUS probe guidance at scale w[1] — stacks the two "
                         "measured-best held-out levers)")
    ap.add_argument("--t_switch", type=float, default=None,
                    help="t-scheduled operators: projection substitution "
                         "active only at t >= t_switch (the high-noise "
                         "structure-forming phase), proj_cg's probe "
                         "guidance active only at t < t_switch (the "
                         "low-noise refinement phase where the probe's "
                         "gradients are informative). kappa and guidance "
                         "needs are t-dependent — this implements "
                         "'proj early / cfg late'")
    ap.add_argument("--factor0_grayscale", action="store_true",
                    help="train the factor-0 (shape/digit) expert on the "
                         "GRAYSCALE projection of the data — the reference's "
                         "own held-out-generalization recipe (a color-blind "
                         "shape expert cannot oppose unseen colors; "
                         "shapes/compose_images_{ddim,ito}.py). Composition "
                         "lifts its eps back to RGB by channel broadcast.")
    ap.add_argument("--gray_norm", action="store_true",
                    help="with --factor0_grayscale: use the unit-norm luma "
                         "projection sum(x*w)/||w|| for both training data "
                         "and the sampling-time adapter — the gray view of "
                         "the RGB diffusion state is then an EXACT diffusion "
                         "state (plain luma understates the noise level by "
                         "0.67x; see experts.rgb_to_gray)")
    ap.add_argument("--gray_proj", default="luma", choices=["luma", "equal"],
                    help="with --factor0_grayscale: channel weights of the "
                         "gray projection. 'luma' = ITU-601 (the reference's "
                         "torchvision Grayscale) gives the shape expert "
                         "authority w_c/||w|| over channel c — only 0.17 for "
                         "BLUE, which is why every blue column of the luma "
                         "runs is the weak one; 'equal' = (1,1,1)/sqrt(3) "
                         "gives each channel 0.577 so held-out colors are "
                         "equally steerable")
    ap.add_argument("--hue_aug", type=float, default=0.0,
                    help="with --factor0_grayscale: per-sample random RGB "
                         "channel gains in [hue_aug, 1] (in [0,1] pixel "
                         "space) applied BEFORE the luma projection of the "
                         "factor-0 training data. The gray shape expert "
                         "then sees every shape at many luma intensities, "
                         "so the luma a HELD-OUT color produces is "
                         "in-distribution instead of an unseen brightness "
                         "level. 0 disables; 0.25 is a reasonable strength")
    ap.add_argument("--corrector_steps", type=int, default=0,
                    help="Langevin (ULA) corrector steps per DDIM level — "
                         "predictor-corrector sampling re-equilibrates "
                         "toward the composed density at every noise level "
                         "(Du et al. 2023: composed score fields are not "
                         "exact gradients; MCMC samples the intended "
                         "product). Applies to every eps-closure operator "
                         "(not ito, which is its own ODE).")
    ap.add_argument("--corrector_snr", type=float, default=0.16,
                    help="signal-to-noise step-size ratio for the corrector")
    ap.add_argument("--corrector_t_max", type=float, default=1.0,
                    help="apply the corrector only at noise levels "
                         "t <= this (the full-range corrector collapsed "
                         "held-out transfer to 0.00 — "
                         "artifacts/cg_snr_corrector; the composed score is "
                         "least gradient-like at high noise)")
    ap.add_argument("--uncond_prob", type=float, default=0.1,
                    help="CFG label-dropout rate for expert training; 0 "
                         "trains plain conditional experts (the measured "
                         "best for the avg operator; cfg then has no null "
                         "row to use)")
    ap.add_argument("--sanity", action="store_true")
    ap.add_argument("--out", default="outputs")
    ap.add_argument("--seed", type=int, default=0)
    add_runtime_flags(ap)
    return ap


def main(argv=None) -> int:
    args, overrides = build_parser().parse_known_args(argv)
    device = start(args)
    sweep = args.holdout_sweep
    if sweep is not None and sweep.strip() != "all":
        sweep = json.loads(sweep)
    elif sweep is not None:
        sweep = "all"
    with profiled(args):
        report = eval_composition.eval_composition(
            args.preset, args.dataset,
            holdout=json.loads(args.holdout), holdout_sweep=sweep,
            samples_per_combo=args.samples_per_combo,
            probe_steps=args.probe_steps, probe_noise=args.probe_noise,
            probe_seeds=args.probe_seeds, n_steps=args.n_steps,
            w_shape=args.w_shape, w_color=args.w_color,
            weight_grid=(json.loads(args.weight_grid) if args.weight_grid
                         else None),
            op=args.op, t_switch=args.t_switch,
            factor0_grayscale=args.factor0_grayscale,
            gray_norm=args.gray_norm, gray_proj=args.gray_proj,
            hue_aug=args.hue_aug, corrector_steps=args.corrector_steps,
            corrector_snr=args.corrector_snr,
            corrector_t_max=args.corrector_t_max,
            uncond_prob=args.uncond_prob, sanity=args.sanity, out=args.out,
            seed=args.seed, overrides=overrides, device=device)
        finite(args, "report", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
