#!/usr/bin/env python3
"""Drives the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase catches its own):

 1. the card's name and power limit (nvidia-smi);
 2. builds the CUDA kernels from ``composable_diffusion_models_tpu_torch/
    csrc`` with nvcc (ptxas register/spill report printed);
 3. holds each of the six kernels against its plain PyTorch version on the
    card, in float32 and bfloat16, at the serving shapes and at ragged
    ones, and times kernel (by events and on the device from a trace),
    plain version and, where one PyTorch call (or two, for GroupNorm +
    SiLU) computes the same function, that call; ``matmul`` and
    ``flash_attention`` print the route their helper picks at every shape,
    are held at each route's edges (both operand majors) and are timed on
    every route over the depth or keys where the limits sit;
    ``groupnorm_silu`` at forced row-split counts beside the wrapper's
    choice, and its two-part form ``groupnorm_silu_split`` at the UNet
    paths' shapes and at ragged ones (groups that straddle the parts, one
    part only); ``flash_attention`` at head widths it pads (8, 24, 48, 80,
    100); the bfloat16 kernels' fast GELU and sigmoid where they saturate
    (|x| around 10 and 80); ``fused_dit_block`` also at the shapes gate's
    DiT cells, (64, 64, 256) bf16, one 64-token image a block;
    ``blend_eps`` also at the blends of phases 19 and 20, beside the device
    time of an empty kernel launch (the floor under its bound);
 4. the DiT path: 3 composed ``dit_p14_d256_l4`` experts (random weights
    from a seed), 50-step DDIM, batch 2048, bf16, through
    ``entry.sample``: finite output, exactly 600 ``fused_dit_block``
    launches, images/s, the same sampler on the plain versions, and the
    float32 kernel path against the float32 plain path;
 5. the device's busy share and device time per step over a few sampler
    steps (torch.profiler);
 6. the DiT's second path, ``fused_block=False``, through
    ``short_seq_attention``;
 7. the UNet shapes-composition path: 2 composed class-conditional
    ``unet64`` experts, 64 x 64 x 3, batch 128, 50 steps, bf16, through
    ``entry.sample_shapes``: exactly 800 ``groupnorm_silu`` and 200
    ``groupnorm_silu_split`` launches, images/s, ``fused_gn=False`` (no
    launch of either), kernel path against plain path, profile;
 8. the UNet cross-attention CFG path: one dual-conditioned ``unet64``,
    28 x 28 x 3, batch 64 (192 rows), float32 as the preset computes,
    through ``entry.sample_cfg``: exactly 250 ``flash_attention``, 400
    ``groupnorm_silu`` and 100 ``groupnorm_silu_split`` launches,
    ``flash_attn=True`` against ``False``, kernel path against plain path
    and, beside it, the plain path against itself with one more rounding
    per GroupNorm element (what that grows to over the steps), profile. The preset's 1000 sampler
    steps are cut to 50 here for time;
 9. the latent path at the full width of the ``shapes_latent`` preset:
    10000 seeded 64 x 64 x 1 images made on the card, ``fit_pca(2)``,
    ``encode`` (one ``matmul`` launch), two ``ScoreMLP(256, 3, 2)`` experts,
    512 latents through ``entry.sample_latent`` under each of its four
    operators at the preset's 1000 steps (``em`` at the ``mnist_latent2d``
    shape: 8192 seeded 28 x 28 images, batch 64): exactly ``n_steps``
    ``blend_eps`` launches for ``ddim`` and ``em`` and none for ``avg`` and
    ``ito``, one ``matmul`` launch per decode, the kernel path against the
    plain path, latents/s, profile;
10. the training path, the protocol of ``scripts/quality_gate_flagship.py``
    cut to the phase's time: the three full-width ``dit_p14_d256_l4``
    experts trained through ``entry.train_experts`` (batch 256, bf16
    compute, digit subsets of procedural MNIST made on the card) for a few
    hundred steps each: train steps/s and images/s, every expert's loss
    curve (its last 50 steps must average below half its first 10), finite
    EMA trees, a bitwise save / restore through the port's
    ``CheckpointManager``, device ms per step and busy share from a short
    profile; then the EMA experts composed through ``entry.sample`` (50
    steps, bf16, exactly 600 ``fused_dit_block`` launches); the unfolded
    ``DiT.apply`` with ``pallas_attn=True`` (one ``short_seq_attention``
    launch a block) against its einsum attention; and the gate's numbers
    against the committed 48k-step PASS, printed as those of an
    under-trained run (a PASS is not a condition);
11. SUPERDIFF (``entry.sample_superdiff``): two ``GUIDED_UNET`` experts (the
    ``colored_mnist_guided`` preset's model, random weights), 28 x 28 x 3,
    batch 64, float32, per-expert labels; OR, the rigorous AND, the AND
    heuristic, FIXED (0.7, 0.3), AVG and the rigorous OR at 100 of the
    preset's 1000 DDPM timesteps (OR and the rigorous AND run all 1000 on
    the trained experts of phase 18);
12. layout (``entry.sample_layout``): the same two experts, a circular
    mask, batch 64, 100 timesteps (a cut for time);
13. the bbox composition (``entry.sample_ancestral``): three
    ``SHAPES_UNET`` experts, 64 x 64 x 3, float32, weights (1, 1, 1), the
    ``shapes_bbox`` preset's 500 timesteps, batch 4 (the script's default)
    and one timed run at batch 64;
14. gray + color DDIM (``entry.sample_gray_color``): a 1-channel and a
    3-channel ``unet64``, 64 x 64, batch 128, float32, the ``shapes_ddim``
    preset's 200 steps, ``op="avg"`` (white) and ``op="proj"``
    (luma_norm);
15. the DDIM family on path A's two bf16 experts, batch 128, 20 steps
    each: eta = 1, x0 and v prediction, one corrector step below t = 0.5,
    ``dpm_solver_pp_2m`` (logsnr).
    Every path of 11-15: finite output, the exact ``groupnorm_silu`` and
    ``groupnorm_silu_split`` launches (8 and 2 per UNet forward), images/s,
    ``fused_gn=False`` launching neither, the kernel path against the plain
    path on the same replayed noise (OR and the rigorous AND also kappa at
    the last step, and beside it the plain path against itself with one
    more rounding per GroupNorm element), a short profile, and a warm call
    of a few steps under ``torch.cuda.set_sync_debug_mode("error")``;
    phase 3 holds ``groupnorm_silu`` and its two-part form at these paths'
    shapes;
16. the shapes gate (``entry.quality_gate_shapes``), the protocol of
    ``scripts/quality_gate_shapes.py`` cut to the phase's time at full
    width: 8192 shapes of 64 x 64 made on the card, the two-factor probe,
    the shape and color experts of ``unet64`` (batch 128, bf16 compute,
    GroupNorm in PyTorch ops) and ``dit_p8_d256_l8`` (float32) trained a few
    hundred steps each (train steps/s, images/s, loss at start and end,
    a short profile of one expert's steps and of each served cell),
    then the 9 (shape, color) cells at 64 samples and 50 steps through the
    served programs: exactly 800 ``groupnorm_silu`` + 200
    ``groupnorm_silu_split`` launches per ``unet64`` cell and 800
    ``fused_dit_block`` launches (64 tokens an image) per DiT cell,
    images/s, the verdict and its criteria (of an under-trained run: not a
    condition); a trained cell of each against its plain path (phase 3
    holds ``fused_dit_block`` at these cells' (64, 64, 256) bf16 against
    its plain version, timed, beside its bound);
17. NLL and the last samplers on the trained ``unet64`` shape expert:
    ``entry.eval_nll`` (64 images, 50 steps, 1 probe: finite bits/dim,
    seconds, images/s); ``parallel_prob_flow`` swept to its fixed point
    and held to the sequential ``prob_flow_ode``; a warm call of it and of
    a classifier-guided ``ddim`` (the gate's probe steering the color)
    under ``set_sync_debug_mode("error")``;
18. the ``colored_mnist_guided`` experts trained and served: two
    ``GUIDED_UNET`` experts at the preset's full width (batch 128, float32,
    ``DDPMSchedule(1000)``, label dropout 0.1) trained through
    ``entry.train_image`` on disjoint digit subsets for a few hundred steps
    (the preset's 4000 cut for time): train ms/step and images/s, each loss
    curve (its last 50 steps must average below half its first 10), no
    kernel launched; the trees saved and read back by name bit for bit;
    then SUPERDIFF OR and the rigorous AND over them at the preset's 1000
    timesteps, batch 64, per-expert labels, through
    ``entry.sample_superdiff``, each as a path of 11-15 (exactly 16000
    ``groupnorm_silu`` + 4000 ``groupnorm_silu_split`` launches, the plain
    path on replayed noise, kappa at the last step, the ``|x| >= 1`` share
    of trained outputs);
19. a preset through train, sample and compose: two ``mnist_image``
    experts trained the same way; ``entry.sample_image`` (ddim, 50 steps,
    batch 64: 400 + 100 K4 launches) and ``entry.compose_scores`` (em over
    both, 50 steps: 800 + 200 K4 and exactly 50 ``blend_eps`` launches;
    none of K3 with ``fused_blend=False``), each as a path of 11-15; the
    sample grid's PNG read back pixel for pixel; warm calls under
    ``set_sync_debug_mode("error")``;
20. the beta-VAE latent path: ``entry.train_vae`` on procedural MNIST at
    full size (28 x 28 x 1, latent 10, base 32), both trainings cut to a
    few hundred steps, the losses at start and end; then
    ``entry.compose_latent_vae`` over digits (3, 5), bs 16, 300 timesteps:
    ``weighted`` with exactly 300 ``blend_eps`` launches, ``cfg`` with none,
    each against its plain path, decoded images/s;
21. the trained latent and 2-D experts: ``entry.fit_pca`` on the
    ``shapes_latent`` preset (10000 shapes of 64 x 64 x 1), two
    ``ScoreMLP(256, 3, 2)`` experts through ``entry.train_latent_2d`` on
    shape subsets (exactly one ``matmul`` launch each, the encode; the loss
    curve), served by ``entry.sample_latent`` (``ddim`` and ``em``, 512
    latents, 1000 steps: exactly 1000 ``blend_eps`` and one ``matmul``
    launch each, the plain path, a warm call without host syncs); then
    ``entry.superposition_2d`` (two ``ScoreMLP(512, 4, 2)`` experts, the
    Ito-kappa sampler over 512 points; no kernel);
22. ``eval_composition.eval_composition`` on shapes with holdout (2, 2): a
    gray (unit-norm luma) and an RGB ``unet64`` expert and the probe
    trained once, then one call per operator (``avg``, ``cfg``, ``proj``,
    ``ito``; 32 samples a combination): exactly 8 + 2 K4 launches per
    expert forward (none under ``ito``) and one ``blend_eps`` a step under
    ``avg``; the reported joint accuracies; the held-out combination of
    ``avg``, ``cfg`` and ``proj`` as a path of 11-15 (the plain path, a
    warm call without host syncs), ``ito`` and the probe-guided ``cg``
    (whose gradient launches nothing) counted;
23. ``eval_superdiff.eval_superdiff``'s mixture protocol (two
    unconditional colored-MNIST ``unet64`` experts, a digit probe; OR, the
    AND heuristic and the rigorous AND at T 1000, 256 samples: exactly 8 +
    2 K4 launches per forward; the per-class histogram and half balance
    reported), its OR job on the trained experts (read from the
    protocol's cache) at batch 256 before the clip as a path of 11-15
    (phase 3 holds K4 at its shapes);
    ``entry.compose_images_ito`` on phase 22's experts (no kernel; the
    grid's PNG read back); ``utils.summarize.summarize_evals`` over the
    reports;
24. one ``kernels`` JSON line, then the result line.

Exits with code 2 and prints no result where there is no CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
              torch.float32: 67e12}     # fp32 outside the tensor cores
BATCH, N_STEPS, N_STEPS_SECOND = 2048, 50, 10
MAIN = (BATCH, 4, 256, 8)          # (B, T, D, heads) of every block launch
SHAPES = [MAIN, (37, 16, 64, 2), (5, 49, 64, 4)]
# UNet paths: (B, H, W, C) of the groupnorm_silu launches of one forward
# (A: 2 experts x batch 128 at 64 x 64; B: 192 rows at 28 x 28), then ragged
A_BATCH, B_BATCH, UNET_STEPS = 128, 64, 50
GN_MAIN = (A_BATCH, 64, 64, 64)
GN_SHAPES = [(GN_MAIN, 8), ((A_BATCH, 32, 32, 64), 8),
             ((A_BATCH, 32, 32, 128), 8), ((A_BATCH, 16, 16, 128), 8),
             ((A_BATCH, 16, 16, 256), 8), ((3 * B_BATCH, 28, 28, 64), 8),
             ((3 * B_BATCH, 14, 14, 128), 8), ((3 * B_BATCH, 7, 7, 256), 8),
             ((3, 7, 7, 24), 4), ((2, 5, 3, 8), 2), ((1, 9, 9, 1024), 8)]
GN_TIMED = GN_SHAPES[:8]
GN_SPLIT_COUNTS = (1, 2, 3, 4, 8, 16, 32)  # row splits a sample, forced
# groupnorm_silu_split: ((B, H, W), part channels, groups). Path A's two up
# blocks, path B's two, then ragged: groups that straddle the parts (4 of 6
# over 16 + 8; 2 of 16 over 8 + 24), one part only, one group over all
GN_SPLIT_SHAPES = [((A_BATCH, 32, 32), (256, 128), 8),
                   ((A_BATCH, 64, 64), (128, 64), 8),
                   ((3 * B_BATCH, 14, 14), (256, 128), 8),
                   ((3 * B_BATCH, 28, 28), (128, 64), 8),
                   ((3, 5, 7), (16, 8), 4), ((2, 3, 3), (8, 24), 2),
                   ((2, 9, 9), (40,), 5), ((4, 8, 8), (8, 8), 1)]
GN_SPLIT_TIMED = GN_SPLIT_SHAPES[:4]
# Biases that drive the GELU's and the sigmoid's argument to where the
# bfloat16 kernels' x / (1 + exp(-z)) saturates: exp overflows past 88,
# and the fast division returns 0 for a divisor past 2^126 (z below -87)
SATURATED = (-100.0, -88.0, -80.0, -12.0, -10.0, -4.0, 4.0, 10.0, 12.0, 80.0,
             88.0, 100.0)
# flash_attention: (B, H, Nq, Nk, D); path B's 5 sites per forward (3
# distinct shapes), then the shapes of the JAX package's own kernel tests
FA_MAIN = (3 * B_BATCH, 4, 784, 2, 16)
# shapes, then each route's edges: Nk at the short route's limit (4) and
# one past it, rows of 64 and 128 bytes, more heads than its block holds,
# Nk * D at the tensor cores' limit (2048) and one short of it, long
# contexts with q split (D = 32, 128) and exact (D = 16, 64) and Nq no
# multiple of 64, then the long contexts that are timed
FA_SHAPES = [FA_MAIN, (3 * B_BATCH, 4, 196, 2, 32), (3 * B_BATCH, 4, 49, 2, 64),
             (2, 2, 128, 128, 64), (2, 2, 256, 256, 32), (1, 2, 128, 2, 32),
             (1, 1, 128, 384, 32), (1, 2, 128, 200, 32), (3, 2, 77, 33, 128),
             (3, 4, 100, 4, 16), (3, 4, 100, 5, 16), (2, 2, 70, 4, 64),
             (2, 3, 130, 3, 32), (1, 128, 9, 2, 16), (1, 129, 9, 2, 16),
             (2, 2, 70, 31, 64),
             (2, 2, 70, 32, 64), (2, 3, 65, 127, 16), (2, 3, 65, 128, 16),
             (1, 2, 200, 300, 32), (1, 2, 200, 300, 128),
             (2, 2, 130, 1000, 64),
             (4, 8, 4096, 4096, 64), (4, 8, 4096, 4096, 128)]
FA_TIMED = FA_SHAPES[:3] + FA_SHAPES[-2:]
# keys timed on each route that can take them, at path B's widest site
# and at a long-query bf16 shape (B, H, Nq, D)
FA_ROUTE_NK = (2, 4, 8, 16, 32, 64, 128, 256)
FA_ROUTE_LONG_Q = (4, 8, 1024, 64)
# latent path: the shapes_latent preset (10000 images of 64 x 64 x 1, 512
# latents of 2 dims, 1000 steps) and the mnist_latent2d preset for em (8192
# images of 28 x 28 x 1, batch 64)
LATENT_N, LATENT_SIZE, LATENT_BATCH, LATENT_STEPS = 10000, 64, 512, 1000
EM_N, EM_SIZE, EM_BATCH = 8192, 28, 64
# blend_eps: (K, B, ...) stacks. The latent path's, the DiT path's and the
# shapes path's blends (all float32 there), compose_scores' (two mnist_image
# experts, batch 64) and compose_latent_vae's (two digits, 16 latents of
# 10), then ragged ones, K = 1 and 5
BLEND_MAIN = (2, LATENT_BATCH, 2)
BLEND_CONFIG = [(2, 64, 28, 28, 1), (2, 16, 10)]
BLEND_SHAPES = [BLEND_MAIN, (3, BATCH, 28, 28, 1), (2, A_BATCH, 64, 64, 3)] \
    + BLEND_CONFIG + [(3, 7, 5), (2, 1, 1), (1, 9, 33), (5, 1000, 3),
                      (5, 64, 8)]
BLEND_TIMED = BLEND_SHAPES[:5]
# matmul: (M, K, N). The codec's encode and decode at both presets, a wider
# codec (64 components of 64 x 64 x 3 images) and its decode, the shapes of
# the JAX package's own kernel test, odd ones, and one square
MM_MAIN = (LATENT_BATCH, 2, LATENT_SIZE ** 2)
MM_SHAPES = [(LATENT_N, LATENT_SIZE ** 2, 2), (EM_N, EM_SIZE ** 2, 2),
             MM_MAIN, (EM_BATCH, 2, EM_SIZE ** 2), (8192, 12288, 64),
             (LATENT_BATCH, 64, 12288), (2048, 2048, 2048), (64, 32, 48),
             (130, 784, 2), (1, 1, 1), (7, 129, 3), (33, 5, 65),
             (257, 1000, 130),
             # each route's edges: K at 1, 2, the small-K limit (8) and one
             # past it; M, N and K no tile multiples (16-byte rows, and
             # not: the wgmma route and the tiles route in bf16)
             (512, 1, 4096), (333, 8, 1000), (512, 9, 4096),
             (512, 16, 4096), (136, 1000, 264), (1000, 1000, 1000)]
MM_TIMED = MM_SHAPES[:7]
# depths of the decode timed on each route that can take them
MM_ROUTE_K = (2, 4, 8, 9, 16)
# flash_attention head widths the wrapper pads to the next kernel width,
# at (B, H, Nq, Nk)
FA_PAD_D = (8, 24, 48, 80, 100)
FA_PAD_SHAPE = (4, 4, 256, 77)
# training path: the gate's protocol cut to the phase's time. Each of the
# three full-width experts takes TRAIN_STEPS steps at the gate's batch, the
# probe PROBE_STEPS (the committed PASS took 48000 and 2000); the served
# program and the gate's scoring run at the gate's 256 samples, 50 steps
TRAIN_STEPS, TRAIN_BATCH, PROBE_STEPS, GATE_SAMPLES = 500, 256, 500, 256
PROFILE_TRAIN_STEPS = 20
# discrete-DDPM paths: colored_mnist_guided (batch 64 of 28 x 28 x 3, 1000
# timesteps; SD_CUT for the cases cut for time), shapes_bbox (64 x 64 x 3,
# 500 timesteps, batch 4 and a timed batch 64); the gray + color DDIM of
# shapes_ddim (batch 128, 200 steps); the DDIM family on path A's experts
SD_BATCH, SD_T, SD_CUT = 64, 1000, 100
BBOX_BATCH, BBOX_BATCH_TIMED, BBOX_T = 4, 64, 500
GC_BATCH, GC_STEPS, FAM_STEPS = 128, 200, 20
PROFILE_STEPS, UNFUSED_STEPS = 5, 20
# the shapes gate (phase 16): scripts/quality_gate_shapes.py's protocol cut
# to the phase's time: its 8192 shapes of 64 x 64 x 3 (made on the card),
# the probe SG_PROBE_STEPS (its 2000), each configuration's shape and color
# experts SG_TRAIN_STEPS at its batch 128 (its 12000), then its 9 cells at
# its 64 samples and 50 steps
SG_DATA_N, SG_IMG, SG_BATCH = 8192, 64, 128
SG_TRAIN_STEPS, SG_PROBE_STEPS, SG_SAMPLES, SG_STEPS = 300, 300, 64, 50
SG_PROFILE_STEPS = 10
SG_K1 = (SG_SAMPLES, 64, 256, 8)  # (B, T, D, heads) of the DiT cells' K1
# NLL and the last samplers (phase 17) on the trained unet64 shape expert:
# eval_nll at NLL_N images, NLL_STEPS steps, 1 probe; Picard sweeps over
# PPF_STEPS time points at batch PPF_BATCH, as many sweeps as points (the
# sequential Euler solve's fixed point); classifier-guided DDIM
NLL_N, NLL_STEPS = 64, 50
PPF_BATCH, PPF_STEPS = 8, 16
CG_BATCH, CG_STEPS, CG_SCALE = 64, 20, 2.0
# the config-driven paths (phases 18-20), written under SMOKE_OUT (git
# ignored, removed at the end). Phase 18: two colored_mnist_guided experts
# trained on disjoint digit subsets, the preset's 4000 steps cut to
# TRAIN_CFG_STEPS for time, then SUPERDIFF OR and the rigorous AND at its
# 1000 timesteps, batch SD_BATCH. Phase 19: two mnist_image experts cut the
# same way, sample_image (ddim) and compose_scores (em) at the preset's 50
# steps and batch 64. Phase 20: the beta-VAE and its latent expert, the
# script's 2000 + 2000 steps cut to VAE_STEPS each, composed at bs 16 over
# 300 timesteps
SMOKE_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "outputs", "chip_smoke")
TRAIN_CFG_STEPS, VAE_STEPS = 300, 300
GUIDED_SUBSETS = ((0, 1, 2, 3, 4), (5, 6, 7, 8, 9))
MNIST_SUBSETS = ((0, 1, 2), (5, 6, 7))
PRESET_BATCH, PRESET_STEPS = 64, 50
# the batch of eval_superdiff's mixture protocol (phase 23): its 256
# samples a job
EV_BATCH = 256
# groupnorm_silu at those paths' shapes (float32): the guided UNet's three
# levels at batch 64, two and three experts' rows at once, the bbox
# experts' levels at batch 4 and the timed batch 64 (batch 128 at 64 x 64
# is GN_MAIN), the mixture experts' levels at EV_BATCH; the two-part form at
# their up blocks
GN_DDPM_SHAPES = [(SD_BATCH, 28, 28, 64), (SD_BATCH, 14, 14, 128),
                  (SD_BATCH, 7, 7, 256), (2 * SD_BATCH, 28, 28, 64),
                  (3 * SD_BATCH, 28, 28, 64), (BBOX_BATCH, 64, 64, 64),
                  (BBOX_BATCH, 32, 32, 128), (BBOX_BATCH, 16, 16, 256),
                  (BBOX_BATCH_TIMED, 64, 64, 64), (EV_BATCH, 28, 28, 64),
                  (EV_BATCH, 14, 14, 128), (EV_BATCH, 7, 7, 256)]
GN_DDPM_SPLIT = [((SD_BATCH, 14, 14), (256, 128)),
                 ((SD_BATCH, 28, 28), (128, 64)),
                 ((BBOX_BATCH, 32, 32), (256, 128)),
                 ((BBOX_BATCH, 64, 64), (128, 64)),
                 ((EV_BATCH, 14, 14), (256, 128)),
                 ((EV_BATCH, 28, 28), (128, 64))]

# the trained latent and 2-D experts and the composition scores (phases
# 21-23), each at its script's published widths, with training and sampling
# steps cut for time and nothing else (the script's value printed beside
# each). Phase 21: two shapes_latent ScoreMLP(256, 3, 2) experts on shape
# subsets (holdouts of every pair of shape 2, of shape 0), the preset's
# 4000 steps cut to LT_STEPS, served by sample_latent at its 1000 steps;
# superposition_2d's two ScoreMLP(512, 4, 2) experts, its 20000 steps cut
# to SP_STEPS, its 1000 sampling steps. Phase 22: eval_composition on
# shapes, holdout (2, 2), 32 samples a combination, a gray (luma_norm) and
# an RGB unet64 expert: the preset's 4000 training steps cut to EC_TRAIN,
# the probe's 1200 to EC_PROBE, its 200 steps to EC_STEPS (EC_ITO_STEPS
# under ito, whose jvps cost 7x a step). Phase 23:
# eval_superdiff's mixture protocol at T 1000 (its 12000 training and 2000
# probe steps cut to EV_TRAIN and EV_PROBE; the kernel path held to the
# plain path on the OR job at EV_BATCH, before the clip), compose_images_ito
# on phase 22's experts (its 1000 steps cut to CI_STEPS) and
# summarize_evals
LT_STEPS, SP_STEPS = 1000, 1000
LT_HOLDOUTS = {"latent_a": "((2,0),(2,1),(2,2))",
               "latent_b": "((0,0),(0,1),(0,2))"}
EC_TRAIN, EC_PROBE, EC_STEPS, EC_ITO_STEPS, EC_SAMPLES = 300, 300, 50, 20, 32
EC_OPS = ("avg", "cfg", "proj", "ito")
EC_CG_STEPS = 10
EV_TRAIN, EV_PROBE = 300, 300
CI_STEPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_records(fn, match: str) -> list:
    """(start, duration in us) of the device kernels that ``fn`` runs whose
    name contains ``match``, in time order, from a trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.device_time) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and match in e.name)


def device_ms(fn, iters: int = 10, match: str = "cdm::") -> float:
    """Device time per call of the device kernels inside ``fn`` whose name
    contains ``match`` (the port's own by default; "" for all of them, as
    for a library call), read from a trace: a launch of a few microseconds
    is timed by ``time_ms`` at the rate the host can launch it, not at what
    the card needs. A trace now and then comes back without its device
    records: it is taken again, and the run fails after ten such."""
    fn()
    for attempt in range(10):
        records = device_records(lambda: [fn() for _ in range(iters)], match)
        if records and len(records) % iters == 0:
            return sum(us for _, us in records) / 1e3 / iters
        time.sleep(0.2 * (attempt + 1))
    fail(f"ten traces in a row kept no whole set of device records "
         f"matching {match!r}")


def split_sweep(kernels, call) -> str:
    """Device ms of ``call()`` (a groupnorm_silu launch) at each of
    GN_SPLIT_COUNTS row splits a sample, forced past ``gn_splits``."""
    out = []
    for splits in GN_SPLIT_COUNTS:
        with mock.patch.object(kernels, "gn_splits", lambda *a, n=splits: n):
            out.append(f"{splits}: {device_ms(call):.4f}")
    return ", ".join(out)


def fa_strides(*tensors) -> tuple:
    """The 12 (batch, head, row) strides that flash_route reads."""
    return sum((tuple(t.stride()[:3]) for t in tensors), ())


def flash_route_sweep(attention, dtype, bhqd, gen) -> str:
    """Device ms of flash_attention on (B, N, H, D) views of ``bhqd`` at
    each of FA_ROUTE_NK keys, on every route that can take them, forced
    past ``flash_route``: where the short route's limit should sit."""
    b, h, nq, d = bhqd
    routes = ("short", "tiles") + (("wgmma",) if dtype == torch.bfloat16
                                   else ())
    out = []
    for nk in FA_ROUTE_NK:
        q, k, v = (torch.randn(b, n, h, d, generator=gen).to("cuda", dtype)
                   .transpose(1, 2) for n in (nq, nk, nk))
        for r in routes:
            with mock.patch.object(attention, "flash_route",
                                   lambda *a, r=r: r):
                dev = device_ms(lambda: attention.flash_attention(q, k, v))
            out.append(f"Nk {nk} {r} {dev:.4f}")
    return ", ".join(out)


def matmul_route_sweep(kernels, dtype, m, n, gen) -> str:
    """Device ms of matmul (M, K) x (K, N) at each of MM_ROUTE_K depths, on
    every route that can take them, forced past ``matmul_route``: where
    the small-K route's limit should sit."""
    out = []
    for k in MM_ROUTE_K:
        a = torch.randn(m, k, generator=gen).to("cuda", dtype)
        b = torch.randn(k, n, generator=gen).to("cuda", dtype)
        # the tensor cores take bf16 rows of a multiple of 8 elements
        routes = (("small_k",) if k <= 8 else ()) + ("tiles",) + (
            ("wgmma",) if dtype == torch.bfloat16 and k % 8 == 0 else ())
        for r in routes:
            with mock.patch.object(kernels, "matmul_route",
                                   lambda *a, r=r, **kw: r):
                dev = device_ms(lambda: kernels.matmul(a, b))
            out.append(f"K {k} {r} {dev:.4f}")
    return ", ".join(out)


def saturating(n: int, dtype) -> torch.Tensor:
    """(n,) values on the card cycling through SATURATED."""
    reps = -(-n // len(SATURATED))
    return torch.tensor(SATURATED).repeat(reps)[:n].to("cuda", dtype)


def block_inputs(b, t, d, dtype, gen):
    """Residual stream ~N(0, 1), folded weights ~N(0, 1/fan_in), biases
    ~N(0, 0.02^2): the scale of the serving path's folded blocks."""
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)
    return [rnd(b, t, d), rnd(d, 3 * d, std=d ** -0.5), rnd(3 * d, std=0.02),
            rnd(d, d, std=d ** -0.5), rnd(d, std=0.02),
            rnd(d, 4 * d, std=d ** -0.5), rnd(4 * d, std=0.02),
            rnd(4 * d, d, std=(4 * d) ** -0.5), rnd(d, std=0.02)]


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tolerance(dtype, ref: torch.Tensor, fp32_tol: float) -> float:
    """float32: summation order only, ``fp32_tol`` of the output scale.
    bfloat16: both sides round at the same sites, but a different fp32
    summation order can flip one rounding of an intermediate; allow 4 bf16
    ulps (2^-8 relative each) of the output scale."""
    scale = max(1.0, float(ref.float().abs().max()))
    return (fp32_tol if dtype == torch.float32 else 4 * 2.0 ** -8) * scale


def check_kernels(kernels):
    """Phase 3. Returns the serving-shape bf16 numbers for the JSON line."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, d, h in SHAPES:
            hd = d // h
            es = torch.empty((), dtype=dtype).element_size()
            args = block_inputs(b, t, d, dtype, gen)
            got = kernels.fused_dit_block(*args, h)
            torch.cuda.synchronize()
            ref = kernels.fused_dit_block_ref(*args, h)
            err = float((got.float() - ref.float()).abs().max())
            tol = tolerance(dtype, ref, 2e-4)
            log(f"fused_dit_block {str(dtype)[6:]} B={b} T={t} D={d} H={h}: "
                f"max_abs_err={err:.3e} tol={tol:.3e}")
            if not err <= tol:
                fail("fused_dit_block disagrees with its plain version")
            qkv = torch.randn(b, t, 3 * d, generator=gen).to("cuda", dtype)
            got_a = kernels.short_seq_attention(qkv, h)
            torch.cuda.synchronize()
            ref_a = kernels.short_seq_attention_ref(qkv, h)
            err_a = float((got_a.float() - ref_a.float()).abs().max())
            tol_a = tolerance(dtype, ref_a, 1e-5)
            log(f"short_seq_attention {str(dtype)[6:]} B={b} T={t} D={d} "
                f"H={h}: max_abs_err={err_a:.3e} tol={tol_a:.3e}")
            if not err_a <= tol_a:
                fail("short_seq_attention disagrees with its plain version")
            if (b, t, d, h) == SHAPES[1]:
                # the MLP's hidden values (unit scale) around each of
                # SATURATED: the GELU where it saturates
                args[6] = saturating(4 * d, dtype)
                got = kernels.fused_dit_block(*args, h)
                torch.cuda.synchronize()
                ref = kernels.fused_dit_block_ref(*args, h)
                err, tol = max_err(got, ref), tolerance(dtype, ref, 2e-4)
                log(f"fused_dit_block {str(dtype)[6:]} B={b} T={t} D={d} "
                    f"H={h}, GELU of values around {SATURATED}: "
                    f"max_abs_err={err:.3e} tol={tol:.3e} at output scale "
                    f"{float(ref.float().abs().max()):.1f}")
                if not err <= tol:
                    fail("fused_dit_block disagrees with its plain version "
                         "where the GELU saturates")
            if (b, t, d, h) != MAIN:
                continue
            ms = time_ms(lambda: kernels.fused_dit_block(*args, h))
            dev = device_ms(lambda: kernels.fused_dit_block(*args, h))
            plain = time_ms(lambda: kernels.fused_dit_block_ref(*args, h))
            flops = 2 * b * t * 12 * d * d + 4 * b * t * t * d
            nbytes = es * (2 * b * t * d + 12 * d * d + 9 * d)
            bms, by = bound_ms(flops, nbytes, dtype)
            blocks = -(-b // (kernels.block_rows(dtype, t, d) // t))
            log(f"  fused_dit_block {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({dev:.4f} ms on the device in a trace), "
                f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}; "
                f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); {blocks} "
                f"blocks each read all {12 * d * d * es / 1e6:.2f} MB of "
                f"weights: {blocks * 12 * d * d * es / 1e6:.1f} MB through "
                f"L2 per launch")
            rows[("fused_dit_block", dtype)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None)
            q, k, v = (qkv.reshape(b, t, 3, h, hd)[:, :, i].transpose(1, 2)
                       .contiguous() for i in range(3))
            ms = time_ms(lambda: kernels.short_seq_attention(qkv, h))
            dev = device_ms(lambda: kernels.short_seq_attention(qkv, h))
            plain = time_ms(lambda: kernels.short_seq_attention_ref(qkv, h))
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            lib_dev = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), match="")
            flops = 4 * b * t * t * d
            nbytes = es * (b * t * 3 * d + b * t * d)
            bms, by = bound_ms(flops, nbytes, dtype)
            log(f"  short_seq_attention {str(dtype)[6:]}: kernel {ms:.4f} ms "
                f"({dev:.4f} ms on the device in a trace), plain "
                f"{plain:.4f} ms, SDPA {lib:.4f} ms ({lib_dev:.4f} ms on the "
                f"device), bound {bms:.4f} ms ({by}; {nbytes / 1e6:.2f} MB)")
            rows[("short_seq_attention", dtype)] = dict(
                max_abs_err=err_a, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)
    return rows


def max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max())


def check_unet_kernels(kernels, attention):
    """Phase 3 for groupnorm_silu and flash_attention. Returns the numbers
    of the main-path shapes for the JSON line: groupnorm_silu in bf16 (path
    A serves bf16), flash_attention in float32 (path B computes in it)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(2)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        for shape, groups in GN_SHAPES:
            c = shape[-1]
            x = (torch.randn(*shape, generator=gen) * 2 + 0.5).to("cuda", dtype)
            scale = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
            bias = (0.1 * torch.randn(c, generator=gen)).cuda()
            hw = shape[1] * shape[2]
            ref = kernels.groupnorm_silu_ref(x, scale, bias, groups)
            got = kernels.groupnorm_silu(x, scale, bias, groups)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            # float32: summation order of the statistics only
            tol = tolerance(dtype, ref, 1e-5)
            log(f"groupnorm_silu {name} {shape} G={groups}: "
                f"max_abs_err={err:.3e} tol={tol:.3e}, the same bits at "
                f"{float((got == ref).float().mean()):.3f} of the elements")
            if not err <= tol:
                fail("groupnorm_silu disagrees with its plain version")
            if shape == GN_SHAPES[5][0]:
                # normalised values (unit scale) around each of SATURATED:
                # the sigmoid where it saturates
                far = saturating(c, torch.float32)
                ref = kernels.groupnorm_silu_ref(x, scale, far, groups)
                got = kernels.groupnorm_silu(x, scale, far, groups)
                torch.cuda.synchronize()
                err, tol = max_err(got, ref), tolerance(dtype, ref, 1e-5)
                log(f"groupnorm_silu {name} {shape} G={groups}, SiLU of "
                    f"values around {SATURATED}: max_abs_err={err:.3e} "
                    f"tol={tol:.3e} at output scale "
                    f"{float(ref.float().abs().max()):.1f}")
                if not err <= tol:
                    fail("groupnorm_silu disagrees with its plain version "
                         "where the sigmoid saturates")
            if (shape, groups) not in GN_TIMED:
                continue
            ms = time_ms(lambda: kernels.groupnorm_silu(x, scale, bias, groups))
            dev = device_ms(
                lambda: kernels.groupnorm_silu(x, scale, bias, groups))
            plain = time_ms(
                lambda: kernels.groupnorm_silu_ref(x, scale, bias, groups))
            unfused = time_ms(lambda: kernels.groupnorm_silu_split_ref(
                (x,), scale, bias, groups))
            # the library's two calls, on the same memory seen as NCHW
            x_nchw, sc_t, bi_t = x.permute(0, 3, 1, 2), scale.to(dtype), \
                bias.to(dtype)
            lib = time_ms(lambda: F.silu(F.group_norm(x_nchw, groups, sc_t,
                                                      bi_t, 1e-5)))
            nbytes = 2 * x.numel() * es + 2 * c * 4
            bms, by = bound_ms(12 * x.numel(), nbytes, torch.float32)
            log(f"  groupnorm_silu {name} {shape}: kernel {ms:.4f} ms "
                f"({dev:.4f} ms on the device in a trace), plain "
                f"{plain:.4f} ms, PyTorch-op composition (fused_gn=False) "
                f"{unfused:.4f} ms, F.group_norm + F.silu (two calls) "
                f"{lib:.4f} ms, bound {bms:.4f} ms ({by}; "
                f"{nbytes / 1e6:.2f} MB)")
            # what the choice of row splits per sample is worth
            log(f"  groupnorm_silu {name} {shape} device ms by row splits "
                f"(wrapper picks {kernels.gn_splits(dtype, shape[0], hw, c)}"
                f"): " + split_sweep(kernels, lambda: kernels.groupnorm_silu(
                    x, scale, bias, groups)))
            if shape == GN_MAIN:
                rows[("groupnorm_silu", dtype)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)
        for (b, h, w), chans, groups in GN_SPLIT_SHAPES:
            c = sum(chans)
            parts = [(torch.randn(b, h, w, cc, generator=gen) * 2 + 0.5).to(
                "cuda", dtype) for cc in chans]
            scale = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
            bias = (0.1 * torch.randn(c, generator=gen)).cuda()
            refs = kernels.groupnorm_silu_split_ref(parts, scale, bias, groups)
            whole = kernels.groupnorm_silu_ref(torch.cat(parts, -1), scale,
                                               bias, groups)
            tol = tolerance(dtype, whole, 1e-5)
            got = kernels.groupnorm_silu_split(parts, scale, bias, groups)
            torch.cuda.synchronize()
            # against the plain split version, and against the plain
            # single-tensor version on the concatenation
            err = max(max(max_err(g, r) for g, r in zip(got, refs)),
                      max_err(torch.cat(got, -1), whole))
            same = float((torch.cat(got, -1) == torch.cat(refs, -1)).float()
                         .mean())
            log(f"groupnorm_silu_split {name} {(b, h, w)} + {chans} "
                f"G={groups}: max_abs_err={err:.3e} tol={tol:.3e}, the same "
                f"bits at {same:.3f} of the elements")
            if not err <= tol:
                fail("groupnorm_silu_split disagrees with its plain version")
            if ((b, h, w), chans, groups) not in GN_SPLIT_TIMED:
                continue
            ms = time_ms(lambda: kernels.groupnorm_silu_split(
                parts, scale, bias, groups))
            dev = device_ms(lambda: kernels.groupnorm_silu_split(
                parts, scale, bias, groups))
            plain = time_ms(lambda: kernels.groupnorm_silu_split_ref(
                parts, scale, bias, groups))
            nbytes = 2 * b * h * w * c * es + 2 * c * 4
            bms, by = bound_ms(12 * b * h * w * c, nbytes, torch.float32)
            log(f"  groupnorm_silu_split {name} {(b, h, w)} + {chans}: kernel "
                f"{ms:.4f} ms ({dev:.4f} ms on the device in a trace), "
                f"PyTorch ops (its plain version, what the path ran before) "
                f"{plain:.4f} ms, bound {bms:.4f} ms ({by}; "
                f"{nbytes / 1e6:.2f} MB); device ms by row splits (wrapper "
                f"picks {kernels.gn_splits(dtype, b, h * w, max(chans))}): "
                + split_sweep(kernels, lambda: kernels.groupnorm_silu_split(
                    parts, scale, bias, groups)))
            if ((b, h, w), chans, groups) == GN_SPLIT_SHAPES[0]:
                # no single PyTorch call normalises two tensors as one
                rows[("groupnorm_silu_split", dtype)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)
        for b, h, nq, nk, d in FA_SHAPES:
            # (B, N, H, D) memory seen as (B, H, N, D): the layout the
            # UNet's cross-attention hands over
            q, k, v = (torch.randn(b, n, h, d, generator=gen).to("cuda", dtype)
                       .transpose(1, 2) for n in (nq, nk, nk))
            got = attention.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = attention.flash_attention_ref(q, k, v)
            err = max_err(got, ref)
            got_c = attention.flash_attention(q.contiguous(), k.contiguous(),
                                              v.contiguous())
            err = max(err, max_err(got_c, ref))
            tol = tolerance(dtype, ref, 1e-5)
            route = attention.flash_route(dtype, h, nk, d,
                                          fa_strides(q, k, v, got))
            log(f"flash_attention {name} B={b} H={h} Nq={nq} Nk={nk} D={d} "
                f"({route} route): max_abs_err={err:.3e} tol={tol:.3e} "
                f"(strided and contiguous)")
            if not err <= tol:
                fail("flash_attention disagrees with its plain version")
            if (b, h, nq, nk, d) in FA_SHAPES[:3]:
                # path B's sites: the short route keeps the tiles route's
                # arithmetic, so its outputs are the same bits, whichever
                # route the helper picks there
                outs = []
                for r in ("short", "tiles"):
                    with mock.patch.object(attention, "flash_route",
                                           lambda *a, r=r: r):
                        outs.append(attention.flash_attention(q, k, v))
                same = torch.equal(*outs)
                log(f"  short route vs tiles route: the same bits {same}")
                if not same:
                    fail("the short route does not give the tiles route's "
                         "bits")
            if (b, h, nq, nk, d) not in FA_TIMED:
                continue
            iters = 3 if nq * nk > 1e6 else 20
            ms = time_ms(lambda: attention.flash_attention(q, k, v), iters, 1)
            dev = device_ms(lambda: attention.flash_attention(q, k, v), iters)
            plain = time_ms(lambda: attention.flash_attention_ref(q, k, v),
                            iters, 1)
            lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                          iters, 1)
            lib_dev = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v), iters,
                match="")
            flops = 4 * b * h * nq * nk * d
            nbytes = es * b * h * d * (2 * nq + 2 * nk)
            bms, by = bound_ms(flops, nbytes, dtype)
            log(f"  flash_attention {name} Nq={nq} Nk={nk} D={d} ({route} "
                f"route): kernel {ms:.4f} ms ({dev:.4f} ms on the device in a "
                f"trace), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
                f"({lib_dev:.4f} ms on the device), bound {bms:.4f} ms ({by}; "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
            if (b, h, nq, nk, d) == FA_MAIN:
                for bhqd in ((b, h, nq, d),) + (
                        (FA_ROUTE_LONG_Q,) if dtype == torch.bfloat16 else ()):
                    log(f"  flash_attention {name} (B, H, Nq, D) = {bhqd}, "
                        f"device ms by route and Nk: "
                        + flash_route_sweep(attention, dtype, bhqd, gen))
            if (b, h, nq, nk, d) == FA_MAIN:
                rows[("flash_attention", dtype)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)
        # head widths the kernel does not take: padded with zero columns to
        # the next of 16, 32, 64, 128, one launch, held at the true D
        b, h, nq, nk = FA_PAD_SHAPE
        for d in FA_PAD_D:
            q, k, v = (torch.randn(b, n, h, d, generator=gen).to("cuda", dtype)
                       .transpose(1, 2) for n in (nq, nk, nk))
            n0 = attention.flash_attention.launches
            got = attention.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = attention.flash_attention_ref(q, k, v)
            err, tol = max_err(got, ref), tolerance(dtype, ref, 1e-5)
            width = attention.flash_head_dim(d)
            log(f"flash_attention {name} B={b} H={h} Nq={nq} Nk={nk} D={d} "
                f"(padded to {width}): max_abs_err={err:.3e} "
                f"tol={tol:.3e}, launches "
                f"{attention.flash_attention.launches - n0}, layout "
                f"{'kept' if got.stride() == q.stride() else 'NOT kept'}")
            if not (err <= tol and got.stride() == q.stride()
                    and attention.flash_attention.launches == n0 + 1):
                fail(f"flash_attention at D={d} disagrees with its plain "
                     f"version")
    return rows


def check_latent_kernels(kernels, compose):
    """Phase 3 for blend_eps and matmul. Returns the float32 numbers at the
    latent path's shapes (the path computes in float32) for the JSON
    line."""
    gen = torch.Generator().manual_seed(4)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        es = torch.empty((), dtype=dtype).element_size()
        for shape in BLEND_SHAPES:
            k = shape[0]
            eps = torch.randn(*shape, generator=gen).to("cuda", dtype)
            w = (torch.rand(k, generator=gen) + 0.5).cuda()
            got = kernels.blend_eps(eps, w)
            torch.cuda.synchronize()
            ref = kernels.blend_eps_ref(eps, w)
            err = max_err(got, ref)
            # float32: the kernel keeps the plain version's order and
            # rounding sites (expected 0); 1e-6 of scale allows a fused
            # multiply-add on either side
            tol = tolerance(dtype, ref, 1e-6)
            err_w = max_err(got, compose.weighted(eps.float(), w))
            log(f"blend_eps {name} {shape}: max_abs_err={err:.3e} "
                f"tol={tol:.3e}; vs compose.weighted in float32 "
                f"{err_w:.3e}")
            if not err <= tol:
                fail("blend_eps disagrees with its plain version")
            if shape not in BLEND_TIMED:
                continue
            ms = time_ms(lambda: kernels.blend_eps(eps, w))
            dev = device_ms(lambda: kernels.blend_eps(eps, w))
            plain = time_ms(lambda: kernels.blend_eps_ref(eps, w))
            ops_ms = time_ms(lambda: compose.weighted(eps, w))
            n = eps[0].numel()
            nbytes = (k + 1) * n * es + 4 * k
            bms, by = bound_ms((2 * k + 1) * n, nbytes, torch.float32)
            log(f"  blend_eps {name} {shape}: kernel {ms:.4f} ms ({dev:.4f} "
                f"ms on the device in a trace), plain "
                f"{plain:.4f} ms, compose.weighted (PyTorch ops, "
                f"fused_blend=False) {ops_ms:.4f} ms, bound {bms:.6f} ms "
                f"({by}; {nbytes / 1e6:.3f} MB)")
            if shape == BLEND_MAIN:
                # no single PyTorch call computes the normalised blend
                rows[("blend_eps", dtype)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None, config_path_shapes=[])
            elif shape in BLEND_CONFIG and dtype == torch.float32:
                rows[("blend_eps", dtype)]["config_path_shapes"].append(dict(
                    shape=list(shape), max_abs_err=err, ms=ms, dev_ms=dev,
                    plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=None))
        if dtype == torch.float32:
            # the floor under any launch: an empty kernel (torch's spin
            # kernel asked for no cycles), its device time from a trace
            empty = device_ms(lambda: torch.cuda._sleep(0), match="spin")
            log(f"an empty kernel launch (torch.cuda._sleep(0)): {empty:.4f} "
                f"ms on the device in a trace, the floor under blend_eps's "
                f"bound of {rows[('blend_eps', dtype)]['bound_ms']:.7f} ms")
            rows[("blend_eps", dtype)]["empty_launch_dev_ms"] = empty
        for m, k, n in MM_SHAPES:
            a = torch.randn(m, k, generator=gen).to("cuda", dtype)
            b = torch.randn(k, n, generator=gen).to("cuda", dtype)
            got = kernels.matmul(a, b)
            torch.cuda.synchronize()
            ref = kernels.matmul_ref(a, b)
            err = max_err(got, ref)
            # either operand and both as transposed views, read through
            # their strides
            a_t, b_t = a.t().contiguous().t(), b.t().contiguous().t()
            err = max(err, max_err(kernels.matmul(a, b_t), ref),
                      max_err(kernels.matmul(a_t, b), ref),
                      max_err(kernels.matmul(a_t, b_t), ref))
            # float32: two sums of K products in different orders, each
            # off by ~2^-24 sqrt(K) of the output scale: 2 * 2^-23 sqrt(K)
            tol = tolerance(dtype, ref, 2 * 2.0 ** -23 * max(1, k) ** 0.5)
            routes = [kernels.matmul_route(dtype, m, k, n, x.stride(),
                                           y.stride())
                      for x, y in ((a, b), (a, b_t), (a_t, b), (a_t, b_t))]
            log(f"matmul {name} M={m} K={k} N={n} (routes {routes}: "
                f"contiguous, b, a, both transposed): max_abs_err={err:.3e} "
                f"tol={tol:.3e}")
            if not err <= tol:
                fail("matmul disagrees with its plain version")
            if (m, k, n) not in MM_TIMED:
                continue
            iters = 5 if m * k * n > 1e9 else 20
            ms = time_ms(lambda: kernels.matmul(a, b), iters, 2)
            dev = device_ms(lambda: kernels.matmul(a, b), iters)
            plain = time_ms(lambda: kernels.matmul_ref(a, b), iters, 2)
            lib = time_ms(lambda: torch.matmul(a, b), iters, 2)
            lib_dev = device_ms(lambda: torch.matmul(a, b), iters, match="")
            flops = 2 * m * n * k
            nbytes = es * (m * k + k * n + m * n)
            bms, by = bound_ms(flops, nbytes, dtype)
            log(f"  matmul {name} M={m} K={k} N={n}: kernel {ms:.4f} ms "
                f"({dev:.4f} ms on the device in a trace), "
                f"plain {plain:.4f} ms, torch.matmul {lib:.4f} ms "
                f"({lib_dev:.4f} ms on the device in a trace), bound "
                f"{bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB)")
            if (m, k, n) == MM_MAIN:
                log(f"  matmul {name} decode (M, N) = {(m, n)}, device ms by "
                    f"route and K: " + matmul_route_sweep(kernels, dtype, m, n,
                                                          gen))
                rows[("matmul", dtype)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)
    return rows


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_sampler(entry, params, x_init, n_steps, **kw):
    return timed(lambda: entry.sample(params, x_init, n_steps=n_steps, **kw))


def profile_steps(label: str, fn, steps: int) -> None:
    """Device busy share and device time per step over a short window of
    ``steps`` sampler steps, and the device kernels that take the most time
    there, by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, sec = timed(fn)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.device_time, calls + 1)
    busy_us = sum(us for us, _ in by_name.values())
    log(f"profile ({label}): {sum(c for _, c in by_name.values())} device "
        f"kernels, {busy_us / 1e3:.3f} ms busy of {sec * 1e3:.3f} ms wall "
        f"-> busy share {busy_us / 1e6 / sec:.3f}; device "
        f"{busy_us / 1e3 / steps:.3f} ms per step")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 16, and the port's own kernels wherever they rank
    for rank, (name, (us, calls)) in enumerate(ranked):
        if rank < 16 or "cdm::" in name:
            log(f"  {us / busy_us:6.1%} {us / 1e3:9.3f} ms {calls:5d} x  "
                f"{name[:110]}")


def reset_launches(kernels, attention) -> None:
    for fn in (kernels.fused_dit_block, kernels.short_seq_attention,
               kernels.groupnorm_silu, kernels.groupnorm_silu_split,
               attention.flash_attention, kernels.blend_eps, kernels.matmul):
        fn.launches = 0


def read_launches(kernels, attention) -> dict:
    return {"fused_dit_block": kernels.fused_dit_block.launches,
            "short_seq_attention": kernels.short_seq_attention.launches,
            "groupnorm_silu": kernels.groupnorm_silu.launches,
            "groupnorm_silu_split": kernels.groupnorm_silu_split.launches,
            "flash_attention": attention.flash_attention.launches,
            "blend_eps": kernels.blend_eps.launches,
            "matmul": kernels.matmul.launches}


@contextlib.contextmanager
def plain_groupnorm(unet, kernels):
    """The UNet with both GroupNorm wrappers replaced by their plain
    versions: the plain path a kernel path is held against."""
    with mock.patch.object(unet, "groupnorm_silu",
                           kernels.groupnorm_silu_ref), \
            mock.patch.object(unet, "groupnorm_silu_split",
                              kernels.groupnorm_silu_split_ref):
        yield


def gn_rounded_twice(kernels):
    """``groupnorm_silu_ref`` with x * a + b as a rounded product and a
    rounded sum, where it (and the kernel) take one fused multiply-add."""
    def fn(x, scale, bias, groups=8, eps=1e-5):
        b, h, w, c = x.shape
        xf = x.reshape(b, h * w, c).float()
        a, bb = kernels._gn_affine(xf.sum(1), (xf * xf).sum(1),
                                   h * w * (c // groups), scale, bias, groups,
                                   eps)
        y = xf * a[:, None, :] + bb[:, None, :]
        return (y * torch.sigmoid(y)).to(x.dtype).reshape(b, h, w, c)
    return fn


def unet_paths(card, convert, entry, unet, kernels, attention) -> dict:
    """Phases 7 and 8. Returns the kernel launches of the two main runs."""
    gen = torch.Generator().manual_seed(3)
    launches = {}

    # 7. path A: shapes composition, 2 experts, bf16
    trees = [convert.from_flax(convert.init_params(entry.SHAPES_UNET, seed=i))
             for i in range(entry.N_SHAPES_EXPERTS)]
    params = entry.load_unets(trees)  # once, as a server would
    params32 = entry.load_unets(trees, dtype=torch.float32)
    x_a = torch.randn(A_BATCH, 64, 64, 3, generator=gen).cuda()
    labels = torch.randint(0, 3, (entry.N_SHAPES_EXPERTS, A_BATCH),
                           generator=gen)

    def shapes(p, n_steps=UNET_STEPS, **kw):
        return entry.sample_shapes(p, x_a, labels, n_steps=n_steps, **kw)

    shapes(params, 2)  # warm-up: cuDNN's choice of algorithms, caches
    reset_launches(kernels, attention)
    out, sec = timed(lambda: shapes(params))
    launches["A"] = read_launches(kernels, attention)
    gflop = entry.unet_gflop_per_image(entry.SHAPES_UNET, 64, 64) * \
        entry.N_SHAPES_EXPERTS * UNET_STEPS
    log(f"path A (shapes composition, batch {A_BATCH}, {UNET_STEPS} steps, "
        f"bf16): {tuple(out.shape)} in {sec:.3f} s = {A_BATCH / sec:.1f} "
        f"images/s, {sec / UNET_STEPS * 1e3:.3f} ms/step ({card}); "
        f"{gflop:.1f} GFLOP/image -> {gflop * A_BATCH / sec / 1e3:.1f} "
        f"TFLOP/s achieved; launches {launches['A']}")
    if not bool(torch.isfinite(out).all()):
        fail("path A output is not finite")
    if tuple(out.shape) != (A_BATCH, 64, 64, 3):
        fail("path A output has the wrong shape")
    forwards = entry.N_SHAPES_EXPERTS * UNET_STEPS
    for kname, per_forward in (("groupnorm_silu", 8),
                               ("groupnorm_silu_split", 2)):
        if launches["A"][kname] != per_forward * forwards:
            fail(f"{kname} launched {launches['A'][kname]} times on path A, "
                 f"expected {per_forward * forwards}")
    reset_launches(kernels, attention)
    _, sec_unfused = timed(lambda: shapes(params, fused_gn=False))
    unfused = read_launches(kernels, attention)
    if unfused["groupnorm_silu"] or unfused["groupnorm_silu_split"]:
        fail(f"fused_gn=False launched a GroupNorm kernel: {unfused}")
    out_again, sec_again = timed(lambda: shapes(params))
    log(f"  fused_gn=False (PyTorch-op GroupNorm + SiLU, no kernel launch): "
        f"{A_BATCH / sec_unfused:.1f} images/s, "
        f"{sec_unfused / UNET_STEPS * 1e3:.3f} ms/step; fused_gn=True "
        f"again: {A_BATCH / sec_again:.1f} images/s")
    if not torch.equal(out, out_again):
        fail("path A is not deterministic")
    with plain_groupnorm(unet, kernels):
        out_plain, sec_plain = timed(lambda: shapes(params))
    diff = (out - out_plain).abs()
    log(f"  plain version: {A_BATCH / sec_plain:.1f} images/s; kernel vs "
        f"plain bf16 after {UNET_STEPS} steps: mean |diff| "
        f"{float(diff.mean()):.4e}, max {float(diff.max()):.4e}")
    # bf16 held on the mean, as for the DiT path (phase 4)
    if not float(diff.mean()) <= 0.05:
        fail("bf16 path A drifts from the plain path")
    out32, sec32 = timed(lambda: shapes(params32, dtype=torch.float32))
    with plain_groupnorm(unet, kernels):
        ref32, _ = timed(lambda: shapes(params32, dtype=torch.float32))
    err32 = max_err(out32, ref32)
    log(f"  float32 kernel path vs float32 plain path, {UNET_STEPS} steps: "
        f"max |diff| {err32:.3e} (tol 1e-3: summation order only); float32 "
        f"path {A_BATCH / sec32:.1f} images/s")
    if not err32 <= 1e-3:
        fail("float32 path A disagrees with the plain path")
    profile_steps(f"path A, 3 steps of 2 forwards, batch {A_BATCH}",
                  lambda: shapes(params, 3), 3)
    del params32, out32, ref32

    # 8. path B: cross-attention CFG, one model, float32 (the preset's)
    tree = convert.from_flax(convert.init_params(entry.CFG_UNET, seed=7))
    p_b, = entry.load_unets([tree], dtype=torch.float32)
    p_b16, = entry.load_unets([tree], dtype=torch.bfloat16)
    x_b = torch.randn(B_BATCH, 28, 28, 3, generator=gen).cuda()

    def cfg(p=p_b, n_steps=UNET_STEPS, **kw):
        return entry.sample_cfg(p, x_b, 3, 1, guidance=(2.0, 2.0),
                                n_steps=n_steps, **kw)

    cfg(n_steps=2)
    reset_launches(kernels, attention)
    out, sec = timed(cfg)
    launches["B"] = read_launches(kernels, attention)
    gflop = entry.unet_gflop_per_image(entry.CFG_UNET, 28, 28) * 3 * UNET_STEPS
    log(f"path B (cross-attention CFG, batch {B_BATCH} = {3 * B_BATCH} rows, "
        f"{UNET_STEPS} steps (the preset's 1000 cut to {UNET_STEPS}), "
        f"float32): {tuple(out.shape)} in {sec:.3f} s = "
        f"{B_BATCH / sec:.1f} images/s, {sec / UNET_STEPS * 1e3:.3f} "
        f"ms/step ({card}); {gflop:.1f} GFLOP/image -> "
        f"{gflop * B_BATCH / sec / 1e3:.1f} TFLOP/s achieved; launches "
        f"{launches['B']}")
    if not bool(torch.isfinite(out).all()):
        fail("path B output is not finite")
    if tuple(out.shape) != (B_BATCH, 28, 28, 3):
        fail("path B output has the wrong shape")
    if launches["B"]["flash_attention"] != 5 * UNET_STEPS:
        fail(f"flash_attention launched {launches['B']['flash_attention']} "
             f"times on path B, expected {5 * UNET_STEPS}")
    for kname, per_forward in (("groupnorm_silu", 8),
                               ("groupnorm_silu_split", 2)):
        if launches["B"][kname] != per_forward * UNET_STEPS:
            fail(f"{kname} launched {launches['B'][kname]} times on path B, "
                 f"expected {per_forward * UNET_STEPS}")
    out_e, sec_e = timed(lambda: cfg(flash_attn=False))
    err_e = max_err(out, out_e)
    log(f"  flash_attn=False (einsum pair): {B_BATCH / sec_e:.1f} images/s; "
        f"flash vs einsum float32 after {UNET_STEPS} steps: max |diff| "
        f"{err_e:.3e} (tol 1e-3: both float32, summation order only)")
    if not err_e <= 1e-3:
        fail("flash_attn=True disagrees with flash_attn=False")
    with plain_groupnorm(unet, kernels), \
            mock.patch.object(unet, "flash_attention",
                              attention.flash_attention_ref):
        ref, _ = timed(cfg)
    err = max_err(out, ref)
    # What the path makes of the least difference there is: the same plain
    # path with x * a + b of the single-tensor GroupNorms rounded twice (a
    # product, then a sum) where the plain version and the kernel round
    # once; the statistics are the same bits. 50 guided steps of a
    # random-weight UNet grow that one rounding to the size of the figure
    # above, which therefore reads the path's sensitivity; the kernels' own
    # errors are phase 3's.
    with mock.patch.object(unet, "groupnorm_silu", gn_rounded_twice(kernels)), \
            mock.patch.object(unet, "groupnorm_silu_split",
                              kernels.groupnorm_silu_split_ref), \
            mock.patch.object(unet, "flash_attention",
                              attention.flash_attention_ref):
        ref_b, _ = timed(cfg)
    log(f"  float32 kernel path vs float32 plain path, {UNET_STEPS} steps: "
        f"max |diff| {err:.3e} (tol 1e-3: summation order only); plain path "
        f"vs the plain path with x * a + b rounded twice: "
        f"{max_err(ref, ref_b):.3e}, kernel path vs that one: "
        f"{max_err(out, ref_b):.3e}")
    if not err <= 1e-3:
        fail("float32 path B disagrees with the plain path")
    out16, sec16 = timed(lambda: cfg(p_b16, dtype=torch.bfloat16))
    d16 = (out16 - out).abs()
    log(f"  bf16 compute: {B_BATCH / sec16:.1f} images/s; bf16 vs float32 "
        f"after {UNET_STEPS} steps: mean |diff| {float(d16.mean()):.4e}")
    if not bool(torch.isfinite(out16).all()):
        fail("bf16 path B output is not finite")
    profile_steps(f"path B, 3 steps, {3 * B_BATCH} rows",
                  lambda: cfg(n_steps=3), 3)
    return launches


def blob_images(n: int, size: int, seed: int) -> torch.Tensor:
    """(n, size, size, 1) float32 images in [-1, 1] made on the card from a
    seed: one soft disc per image with a random centre, radius and
    brightness, so the set has visible low-rank structure for the PCA."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(n, 4, generator=gen, device="cuda")
    cx, cy = (size * (0.25 + 0.5 * u[:, i])[:, None, None] for i in (0, 1))
    radius = size * (0.1 + 0.15 * u[:, 2])[:, None, None]
    level = (0.5 + 0.5 * u[:, 3])[:, None, None]
    ax = torch.arange(size, dtype=torch.float32, device="cuda")
    d2 = (ax[None, :, None] - cy) ** 2 + (ax[None, None, :] - cx) ** 2
    return (2.0 * level * torch.exp(-d2 / (2.0 * radius ** 2))
            - 1.0)[..., None]


def fit_codec(card, entry, pca_codec, kernels, attention, n, size, seed):
    """Images, fit_pca(2) and the encode of the whole set: one matmul
    launch, checked against the plain product, reconstruction error below
    the data's variance."""
    imgs = blob_images(n, size, seed)
    codec, sec_fit = timed(lambda: pca_codec.fit_pca(imgs, 2))
    reset_launches(kernels, attention)
    z_all, sec_enc = timed(lambda: codec.encode(imgs))
    if kernels.matmul.launches != 1:
        fail(f"encode launched matmul {kernels.matmul.launches} times, "
             f"expected 1")
    flat = imgs.reshape(n, -1)
    z_plain = kernels.matmul_ref(flat - codec.mean, codec.components_t)
    err = max_err(z_all, z_plain)
    tol = 2 * 2.0 ** -23 * size * max(1.0, float(z_plain.abs().max()))
    mse = float(((codec.decode(z_all) - flat) ** 2).mean())
    var = float(flat.var(dim=0).mean())
    log(f"codec {n} x {size} x {size} x 1 ({card}): fit_pca(2) "
        f"{sec_fit:.3f} s, explained variance "
        f"{[round(v, 3) for v in codec.explained_variance.tolist()]}; encode "
        f"{tuple(z_all.shape)} in {sec_enc * 1e3:.3f} ms with 1 matmul "
        f"launch, vs plain product max |diff| {err:.3e} (tol {tol:.3e}: "
        f"2 * 2^-23 sqrt(D) of scale); reconstruction mse {mse:.4f} against "
        f"a per-pixel variance of {var:.4f}")
    if not err <= tol:
        fail("encode disagrees with the plain product")
    if not (mse == mse and mse < var):
        fail("the 2-component reconstruction is no better than the mean")
    return entry.load_pca(codec)


def latent_path(card, convert, entry, pca_codec, kernels, attention) -> dict:
    """Phase 9. Returns the kernel launches of the ddim run."""
    codec = fit_codec(card, entry, pca_codec, kernels, attention, LATENT_N,
                      LATENT_SIZE, seed=5)
    codec_em = fit_codec(card, entry, pca_codec, kernels, attention, EM_N,
                         EM_SIZE, seed=6)
    params = entry.load_latent_experts(
        [convert.from_flax(convert.init_params(entry.SHAPES_LATENT_MLP,
                                               seed=i)) for i in range(2)])
    gen = torch.Generator().manual_seed(8)
    z_init = torch.randn(LATENT_BATCH, 2, generator=gen).cuda()
    launches = {}
    for op in entry.LATENT_OPS:
        em = op == "em"
        pca, z0 = (codec_em, z_init[:EM_BATCH]) if em else (codec, z_init)
        size, batch = (EM_SIZE, EM_BATCH) if em else (LATENT_SIZE,
                                                      LATENT_BATCH)

        def run(n_steps=LATENT_STEPS, **kw):
            return entry.sample_latent(params, pca, z0, op=op,
                                       n_steps=n_steps, **kw)

        run(2)  # warm-up: cuBLAS handles, caches
        reset_launches(kernels, attention)
        (z, imgs), sec = timed(run)
        counts = read_launches(kernels, attention)
        log(f"latent path, op {op} ({batch} latents, {LATENT_STEPS} steps, "
            f"2 experts, float32, decode to {size} x {size}): {tuple(z.shape)}"
            f" -> {tuple(imgs.shape)} in {sec:.3f} s = {batch / sec:.1f} "
            f"latents/s, {sec / LATENT_STEPS * 1e3:.3f} ms/step ({card}); "
            f"max |z| {float(z.abs().max()):.1f}; launches blend_eps "
            f"{counts['blend_eps']}, matmul {counts['matmul']}")
        if not (bool(torch.isfinite(z).all())
                and bool(torch.isfinite(imgs).all())):
            fail(f"latent path ({op}) output is not finite")
        if tuple(z.shape) != (batch, 2) or \
                tuple(imgs.shape) != (batch, size, size, 1):
            fail(f"latent path ({op}) output has the wrong shape")
        want = LATENT_STEPS if op in ("ddim", "em") else 0
        if counts["blend_eps"] != want or counts["matmul"] != 1:
            fail(f"latent path ({op}): expected {want} blend_eps and 1 "
                 f"matmul launches")
        if op == "ddim":
            launches = counts
        if want:
            # the plain path: compose.weighted for the blend and the plain
            # product for the decode, with the preset's unit weights and
            # with uneven ones. With K = 2 both blends add the same two
            # rounded products in the same order and divide once, so 0 is
            # expected; phase 3 holds the kernel to its plain version at
            # K = 3 and 5, where the orders differ
            for weights in (None, (0.7, 1.9)):
                kw = {} if weights is None else {"weights": weights}
                z_k, img_k = (z, imgs) if weights is None else run(**kw)
                with mock.patch.object(kernels, "matmul", kernels.matmul_ref):
                    z_p, img_p = run(fused_blend=False, **kw)
                scale = max(1.0, float(z_p.abs().max()))
                err_z, err_i = max_err(z_k, z_p), max_err(img_k, img_p)
                log(f"  weights {weights or 'ones'}: kernel path vs plain "
                    f"path after {LATENT_STEPS} steps: latents max |diff| "
                    f"{err_z:.3e} at scale {scale:.1f}, images max |diff| "
                    f"{err_i:.3e} (tol 1e-3 of the latents' scale, float32)")
                if not (err_z <= 1e-3 * scale and err_i <= 1e-3 * scale):
                    fail(f"latent path ({op}) disagrees with the plain path")
            # fused_blend on, off, off, on: the host sets this path's pace,
            # so single readings move with its load
            secs = [timed(lambda f=f: run(fused_blend=f))[1]
                    for f in (True, False, False, True)]
            log("  ms/step with fused_blend True, False, False, True: "
                + ", ".join(f"{t / LATENT_STEPS * 1e3:.3f}" for t in secs))
        else:
            # no blend on this operator: the plain path differs in the
            # decode alone
            img_p = (kernels.matmul_ref(z, pca.components) + pca.mean).reshape(
                batch, size, size, 1).clamp(-1.0, 1.0)
            err_i = max_err(imgs, img_p)
            tol = 4 * 2.0 ** -23 * max(1.0, float(z.abs().max()))
            log(f"  decode through the kernel vs the plain product: images "
                f"max |diff| {err_i:.3e} (tol {tol:.3e}: two products per "
                f"pixel, 4 * 2^-23 of the latents' scale)")
            if not err_i <= tol:
                fail(f"latent path ({op}): decode disagrees with the plain "
                     f"product")
        _, sec20 = timed(lambda: run(20))
        log(f"  20 steps without the profiler: {sec20 * 1e3:.3f} ms wall")
        profile_steps(f"latent path, op {op}, 20 steps, {batch} latents",
                      lambda: run(20), 20)
    return launches


def training_path(card, entry, kernels, attention) -> int:
    """Phase 10. Returns the fused_dit_block launches of the served run."""
    import dataclasses
    import shutil
    from pathlib import Path
    from composable_diffusion_models_tpu_torch import (checkpoint, convert,
                                                       data, gate, train)
    from composable_diffusion_models_tpu_torch.schedules import VPSchedule

    # a. the gate's three experts at full width, bf16 compute
    trees, losses = None, None

    def train_all():
        nonlocal trees, losses
        trees, losses = entry.train_experts(steps=TRAIN_STEPS,
                                            batch_size=TRAIN_BATCH)
    _, sec = timed(train_all)
    steps = len(trees) * TRAIN_STEPS
    log(f"training path: {len(trees)} dit_p14_d256_l4 experts x "
        f"{TRAIN_STEPS} steps, batch {TRAIN_BATCH}, bf16 compute over "
        f"float32 parameters, Adam 2e-4, EMA 0.999, procedural digits made "
        f"on the card: {sec:.1f} s = {steps / sec:.2f} train steps/s = "
        f"{steps * TRAIN_BATCH / sec:.0f} train images/s (data build, init "
        f"and first-call set-up included) ({card})")
    for i, loss in enumerate(losses):
        loss = loss.float().cpu()
        first, last = float(loss[:10].mean()), float(loss[-50:].mean())
        curve = ", ".join(f"{float(loss[j:j + 25].mean()):.4f}"
                          for j in range(0, len(loss), 25))
        log(f"  expert {i} (digits {gate.SUBSETS[i]}): mean loss of the "
            f"first 10 steps {first:.4f}, of the last 50 {last:.4f}; "
            f"25-step window means: {curve}")
        if not (math.isfinite(last) and last < 0.5 * first):
            fail(f"expert {i}'s loss did not fall below half its start")
    for tree in trees:
        if not all(bool(torch.isfinite(leaf).all())
                   for leaf in train.flatten(tree)[1]):
            fail("an EMA tree is not finite")

    # b. the EMA trees through the CheckpointManager and back
    root = Path(__file__).resolve().parent / "outputs" / "chip_smoke_ckpt"
    mgr = checkpoint.CheckpointManager(str(root), "flagship")
    state = {"ema_params": trees, "step": TRAIN_STEPS}
    mgr.save("experts", state)
    mgr.save_step("experts", state, TRAIN_STEPS)
    back = [mgr.load("experts", device="cuda"),
            mgr.restore_latest("experts", device="cuda")[0]]
    same = all(torch.equal(a, b) and a.dtype == b.dtype
               for got in back
               for t, r in zip(trees, got["ema_params"])
               for a, b in zip(train.flatten(t)[1], train.flatten(r)[1]))
    shutil.rmtree(root)
    log(f"  CheckpointManager save / load and save_step / restore_latest "
        f"of the EMA trees: bitwise {same}")
    if not same:
        fail("a checkpoint did not restore the EMA trees bitwise")

    # c. steady state of one expert's training, then a short profile
    imgs, _ = data.get_mnist(1, n=8192, classes=gate.SUBSETS[0],
                             device="cuda")
    p0 = convert.flax_init(entry.GATE_DIT, 1, "cuda")

    def run():
        return train.train_expert(2, entry.GATE_DIT.apply, p0, VPSchedule(),
                                  imgs,
                                  steps=PROFILE_TRAIN_STEPS,
                                  batch_size=TRAIN_BATCH, ema_decay=0.999)
    run()
    _, sec = timed(run)
    log(f"  {PROFILE_TRAIN_STEPS} steps of one expert without the profiler: "
        f"{sec / PROFILE_TRAIN_STEPS * 1e3:.3f} ms/step = "
        f"{PROFILE_TRAIN_STEPS / sec:.2f} train steps/s = "
        f"{TRAIN_BATCH * PROFILE_TRAIN_STEPS / sec:.0f} train images/s")
    profile_steps(f"training, {PROFILE_TRAIN_STEPS} steps of one expert, "
                  f"batch {TRAIN_BATCH}", run, PROFILE_TRAIN_STEPS)

    # d. the EMA experts served through the folded DiT on fused_dit_block
    x = torch.randn(GATE_SAMPLES, 28, 28, 1,
                    generator=torch.Generator().manual_seed(9)).cuda()
    entry.sample(trees, x[:8], n_steps=2)  # warm-up
    reset_launches(kernels, attention)
    out, sec = timed(lambda: entry.sample(trees, x, n_steps=N_STEPS))
    served = read_launches(kernels, attention)
    want = 4 * len(trees) * N_STEPS
    log(f"  the trained EMA experts composed through entry.sample "
        f"({GATE_SAMPLES} samples, {N_STEPS} steps, bf16): "
        f"{GATE_SAMPLES / sec:.1f} images/s; launches {served}")
    if not bool(torch.isfinite(out).all()) or \
            tuple(out.shape) != (GATE_SAMPLES, 28, 28, 1):
        fail("the served EMA experts' output is not finite or misshapen")
    if served["fused_dit_block"] != want:
        fail(f"fused_dit_block launched {served['fused_dit_block']} times "
             f"serving the EMA experts, expected {want}")

    # e. the unfolded forward's inference route: DiT.apply with its
    # attention core through short_seq_attention (fused-QKV layout, random
    # full-width weights), against the einsum route, no autograd
    tree, = entry.load_experts(
        [convert.from_flax(convert.init_params(entry.FLAGSHIP, seed=0))],
        dtype=torch.float32)
    t = torch.full((GATE_SAMPLES,), 0.5, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(entry.FLAGSHIP, dtype=dtype)
        with torch.no_grad():
            ref = cfg.apply(tree, x, t)
            n0 = kernels.short_seq_attention.launches
            got = dataclasses.replace(cfg, pallas_attn=True).apply(tree, x, t)
            torch.cuda.synchronize()
        n_k2 = kernels.short_seq_attention.launches - n0
        diff = (got - ref).abs()
        scale = max(1.0, float(ref.abs().max()))
        log(f"  DiT.apply (unfolded, {GATE_SAMPLES} images, {str(dtype)[6:]})"
            f" with pallas_attn=True vs the einsum attention: "
            f"short_seq_attention launches {n_k2}, max |diff| "
            f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e} at "
            f"output scale {scale:.1f}")
        # float32: summation order (1e-5 of scale); bf16: the einsum route
        # rounds the scores to bf16 before the softmax, the kernel does not
        # (held on the mean, as the other bf16 path checks)
        ok = (float(diff.max()) <= 1e-5 * scale if dtype == torch.float32
              else float(diff.mean()) <= 0.05)
        if n_k2 != entry.FLAGSHIP.depth or not ok:
            fail("DiT.apply with pallas_attn=True disagrees with the einsum "
                 "route or missed short_seq_attention")

    # f. the gate's numbers for these under-trained experts
    report, sec = timed(lambda: entry.quality_gate(
        train_steps=TRAIN_STEPS, probe_steps=PROBE_STEPS,
        n_samples=GATE_SAMPLES, experts=trees))
    base = json.loads(gate.BASELINE.read_text())
    log(f"  quality gate of an UNDER-TRAINED run ({TRAIN_STEPS} steps per "
        f"expert; the committed PASS took {base['train_steps']}), probe "
        f"{PROBE_STEPS} steps, {report['n_samples']} samples, {sec:.1f} s: "
        f"probe held-in {report['probe_heldin']}, solo in-subset "
        + ", ".join(f"{s['in_set_frac']:.3f}"
                    for s in report["solo"].values())
        + f"; verdict against {gate.BASELINE.name} (not a condition of this "
        f"run): {report['verdict']}")
    log(json.dumps({"gate_under_trained": report["criteria"]}))
    return served["fused_dit_block"]


def check_ddpm_gn_shapes(kernels) -> list:
    """Phase 3 for groupnorm_silu and its two-part form at the shapes of
    the discrete-DDPM paths (float32, as they compute), each against its
    plain version and timed. Returns their rows for the JSON line."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(11)
    rows = []
    for shape in GN_DDPM_SHAPES + GN_DDPM_SPLIT:
        split = len(shape) == 2
        bhw, chans = (shape if split else (shape[:3], (shape[3],)))
        c = sum(chans)
        parts = [(torch.randn(*bhw, cc, generator=gen) * 2 + 0.5).cuda()
                 for cc in chans]
        scale = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
        bias = (0.1 * torch.randn(c, generator=gen)).cuda()
        whole = torch.cat(parts, -1) if split else parts[0]
        if split:
            def call():
                return kernels.groupnorm_silu_split(parts, scale, bias, 8)

            def plain():
                return kernels.groupnorm_silu_split_ref(parts, scale, bias, 8)
            got = torch.cat(call(), -1)
        else:
            def call():
                return kernels.groupnorm_silu(parts[0], scale, bias, 8)

            def plain():
                return kernels.groupnorm_silu_ref(parts[0], scale, bias, 8)
            got = call()
        torch.cuda.synchronize()
        ref = kernels.groupnorm_silu_ref(whole, scale, bias, 8)
        err, tol = max_err(got, ref), tolerance(torch.float32, ref, 1e-5)
        ms, dev, plain_ms = time_ms(call), device_ms(call), time_ms(plain)
        lib = lib_dev = None
        if not split:
            x_nchw = parts[0].permute(0, 3, 1, 2)

            def library():
                return F.silu(F.group_norm(x_nchw, 8, scale, bias, 1e-5))
            lib, lib_dev = time_ms(library), device_ms(library, match="")
        nbytes = 2 * whole.numel() * 4 + 2 * c * 4
        bms, by = bound_ms(12 * whole.numel(), nbytes, torch.float32)
        name = "groupnorm_silu_split" if split else "groupnorm_silu"
        desc = f"{bhw} + {chans}" if split else str(shape)
        log(f"{name} float32 {desc} G=8 (DDPM paths): max_abs_err={err:.3e} "
            f"tol={tol:.3e}; kernel {ms:.4f} ms ({dev:.4f} ms on the device "
            f"in a trace), plain {plain_ms:.4f} ms, "
            + (f"F.group_norm + F.silu {lib:.4f} ms ({lib_dev:.4f} ms on the "
               f"device), " if lib else "")
            + f"bound {bms:.4f} ms ({by}; {nbytes / 1e6:.2f} MB)")
        if not err <= tol:
            fail(f"{name} disagrees with its plain version at {desc}")
        rows.append(dict(name=name, shape=desc, dtype="float32",
                         max_abs_err=err, ms=ms, dev_ms=dev,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib, library_dev_ms=lib_dev))
    return rows


def sync_free(label: str, fn) -> None:
    """A warm call of ``fn`` under ``set_sync_debug_mode("error")``: any
    call that makes the host wait for the card raises there."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"  {label}: a warm call under set_sync_debug_mode('error') made "
        f"no host sync; output finite {bool(torch.isfinite(out).all())}")


@contextlib.contextmanager
def last_output(module, name: str):
    """Records the last value ``module.name`` returned while patched: the
    sampler's kappa at its last step."""
    box, orig = {}, getattr(module, name)

    def record(*args, **kw):
        box["out"] = orig(*args, **kw)
        return box["out"]
    with mock.patch.object(module, name, record):
        yield box


def k4_path(card, label: str, run, forwards: int, batch: int, steps: int,
            shape: tuple, kernels, attention, unet, compose=None,
            kappa_fn: str = None, bf16: bool = False, also: dict = None,
            plain=contextlib.nullcontext) -> dict:
    """One UNet path of phases 11-15: ``run(**kw)`` samples at full depth
    with replayed draws (``fused_gn=``; ``n=`` for a shorter run with
    seeded draws). The kernel run (counts from 0, timed), exact launches,
    fused_gn=False (none), the plain path on the same draws: x and, where
    ``kappa_fn`` names the function that returns it, kappa at the last
    step. ``also``: the exact launches of other kernels a call makes
    (``fused_gn=False`` leaves them be); ``plain()``: a context that puts
    those kernels' plain versions in place for the plain path.
    bf16 is held on the mean (0.05). float32 is held per element
    (1e-3 of the scale, and kappa to 1e-3) unless the path itself is
    sensitive: the plain path against itself with x * a + b rounded twice
    (one more rounding per GroupNorm element), run beside it, moving by
    more than a tenth of that bar. Random-weight experts over hundreds of
    steps grow a rounding that far (and turn it into flips of the heuristic
    AND's kappa): there the mean is held (1e-3 of the scale) and the
    largest differences are printed beside the path's own. A short profile
    closes. Returns the kernel run's launches."""
    def kappa_of():
        return (last_output(compose, kappa_fn) if kappa_fn
                else contextlib.nullcontext({}))
    run(n=2)  # warm-up: cuDNN's choice of algorithms, caches
    reset_launches(kernels, attention)
    with kappa_of() as box:
        out, sec = timed(run)
    counts = read_launches(kernels, attention)
    log(f"{label}: {tuple(out.shape)} in {sec:.3f} s = {batch / sec:.1f} "
        f"images/s, {sec / steps * 1e3:.3f} ms/step ({card}); launches "
        f"{counts}")
    if not bool(torch.isfinite(out).all()):
        fail(f"{label}: output is not finite")
    if tuple(out.shape) != shape:
        fail(f"{label}: output has the wrong shape")
    want = dict.fromkeys(counts, 0)
    want.update(groupnorm_silu=8 * forwards,
                groupnorm_silu_split=2 * forwards, **(also or {}))
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    cut = min(steps, UNFUSED_STEPS)
    reset_launches(kernels, attention)
    _, sec_u = timed(lambda: run(n=cut, fused_gn=False))
    unfused = read_launches(kernels, attention)
    if any(v for k, v in unfused.items() if k not in (also or {})):
        fail(f"{label}: fused_gn=False launched a kernel: {unfused}")
    with plain_groupnorm(unet, kernels), plain(), kappa_of() as box_p:
        ref, sec_p = timed(run)
    scale = max(1.0, float(ref.abs().max()))
    diff = (out - ref).abs()
    log(f"  fused_gn=False ({cut} steps): {sec_u / cut * 1e3:.3f} ms/step; "
        f"plain path {batch / sec_p:.1f} images/s; kernel path vs plain path "
        f"after {steps} steps: max |diff| {float(diff.max()):.3e}, mean "
        f"{float(diff.mean()):.3e} at scale {scale:.4g}; |x| >= 1 at "
        f"{float((out.abs() >= 1).float().mean()):.3f} of the elements")
    if bf16:
        if not float(diff.mean()) <= 0.05:
            fail(f"{label}: the bf16 kernel path drifts from the plain path")
    else:
        with mock.patch.object(unet, "groupnorm_silu",
                               gn_rounded_twice(kernels)), \
                mock.patch.object(unet, "groupnorm_silu_split",
                                  kernels.groupnorm_silu_split_ref), \
                plain(), kappa_of() as box_b:
            ref_b = run()
        d_b = (ref - ref_b).abs()
        sensitive = float(d_b.max()) > 1e-4 * scale
        log(f"  the plain path against itself with x * a + b rounded twice:"
            f" max |diff| {float(d_b.max()):.3e}, mean "
            f"{float(d_b.mean()):.3e}; kernel path vs that one: max "
            f"{max_err(out, ref_b):.3e}; held "
            + ("on the mean (the path is sensitive)" if sensitive
               else "per element") + ", bar 1e-3 of the scale")
        stat = diff.mean() if sensitive else diff.max()
        if not float(stat) <= 1e-3 * scale:
            fail(f"{label}: the kernel path disagrees with the plain path")
        if kappa_fn:
            k_diff = (box["out"] - box_p["out"]).abs()
            k_b = (box_p["out"] - box_b["out"]).abs()
            log(f"  kappa at the last step, kernel vs plain: max |diff| "
                f"{float(k_diff.max()):.3e}, {int((k_diff > 1e-3).sum())} of "
                f"{k_diff.numel()} entries beyond 1e-3; plain vs plain "
                f"rounded twice: max {float(k_b.max()):.3e}, "
                f"{int((k_b > 1e-3).sum())} beyond 1e-3"
                + ("" if not sensitive else " (printed, not held: the path "
                   "is sensitive)"))
            if not sensitive and not float(k_diff.max()) <= 1e-3:
                fail(f"{label}: kappa of the kernel path disagrees with the "
                     f"plain path's")
    prof = min(steps, PROFILE_STEPS)
    profile_steps(f"{label}, {prof} steps", lambda: run(n=prof), prof)
    return counts


def ddpm_paths(card, convert, entry, unet, kernels, attention,
               compose) -> dict:
    """Phases 11-14. Returns the launches of each path's kernel run."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    launches = {}

    def draws(shape, n, per_step=()):
        return torch.randn((n,) + per_step + shape, generator=gen,
                           device="cuda")

    # 11. SUPERDIFF on two guided experts, float32
    params = entry.load_unets(
        [convert.from_flax(convert.init_params(entry.GUIDED_UNET, seed=20 + i))
         for i in range(entry.N_GUIDED_EXPERTS)], dtype=torch.float32)
    img = (SD_BATCH, 28, 28, 3)
    x = torch.randn(img, generator=gen, device="cuda")
    # per-expert (digit, color); expert 0's color slot is the null token
    labels = torch.tensor([[3, 10], [7, 2]], device="cuda")
    # OR and the rigorous AND run at the preset's 1000 timesteps on the
    # trained experts of phase 18; on these random-weight experts, whose
    # outputs all clip there, at SD_CUT like the rest
    noise1, noise2 = draws(img, SD_CUT), draws(img, SD_CUT, (2,))
    cases = [("OR", False, SD_CUT, "or_softmax"),
             ("AND", True, SD_CUT, "and_solve_k"),
             ("AND", False, SD_CUT, "and_heuristic"),
             ("FIXED", False, SD_CUT, None), ("AVG", False, SD_CUT, None),
             ("OR", True, SD_CUT, "or_softmax")]
    for op, rigorous, steps, kappa_fn in cases:
        replay = (noise2 if rigorous and op == "AND" else noise1)[:steps]

        def run(n=steps, op=op, rigorous=rigorous, replay=replay, **kw):
            return entry.sample_superdiff(
                params, x, labels, operation=op, rigorous_and=rigorous,
                kappa=(0.7, 0.3), num_timesteps=n,
                noise=replay if n == replay.shape[0] else None, **kw)

        label = (f"SUPERDIFF {'rigorous ' if rigorous else ''}{op} "
                 f"({entry.N_GUIDED_EXPERTS} guided experts, batch "
                 f"{SD_BATCH}, {steps} timesteps"
                 + ("" if steps == SD_T else
                    f" (the preset's {SD_T} cut for time)") + ", float32)")
        launches[f"superdiff_{'solve_' if rigorous else ''}{op.lower()}"] = \
            k4_path(card, label, run, entry.N_GUIDED_EXPERTS * steps,
                    SD_BATCH, steps, img, kernels, attention, unet, compose,
                    kappa_fn)
        sync_free(f"SUPERDIFF {'rigorous ' if rigorous else ''}{op}",
                  lambda run=run: run(n=2))
    del noise2

    # 12. layout: background everywhere, the foreground in a circle
    replay = noise1[:SD_CUT]

    def run_layout(n=SD_CUT, **kw):
        return entry.sample_layout(
            params, x, num_timesteps=n,
            noise=replay if n == SD_CUT else None, **kw)
    launches["layout"] = k4_path(
        card, f"layout (2 guided experts, a circular mask, batch {SD_BATCH}, "
        f"{SD_CUT} timesteps (the preset's {SD_T} cut for time), float32)",
        run_layout, 2 * SD_CUT, SD_BATCH, SD_CUT, img, kernels, attention,
        unet)
    sync_free("layout", lambda: run_layout(n=2))
    del noise1, params

    # 13. the bbox composition: shape, color and bbox experts
    bbox = entry.load_unets(
        [convert.from_flax(convert.init_params(entry.SHAPES_UNET, seed=30 + i))
         for i in range(3)], dtype=torch.float32)
    img = (BBOX_BATCH_TIMED, 64, 64, 3)
    x_all = torch.randn(img, generator=gen, device="cuda")
    lab_all = torch.randint(0, 3, (3, BBOX_BATCH_TIMED), generator=gen,
                            device="cuda")
    noise = draws(img, BBOX_T)

    def run_bbox(n=BBOX_T, b=BBOX_BATCH, **kw):
        return entry.sample_ancestral(
            bbox, x_all[:b], lab_all[:, :b], num_timesteps=n,
            noise=noise[:, :b] if n == BBOX_T else None, **kw)
    launches["ancestral"] = k4_path(
        card, f"bbox composition (3 experts, weights (1, 1, 1), batch "
        f"{BBOX_BATCH}, {BBOX_T} timesteps, float32)", run_bbox, 3 * BBOX_T,
        BBOX_BATCH, BBOX_T, (BBOX_BATCH, 64, 64, 3), kernels, attention, unet)
    sync_free("ancestral", lambda: run_bbox(n=2))
    run_bbox(n=2, b=BBOX_BATCH_TIMED)
    reset_launches(kernels, attention)
    out, sec = timed(lambda: run_bbox(b=BBOX_BATCH_TIMED))
    counts = read_launches(kernels, attention)
    log(f"  batch {BBOX_BATCH_TIMED}, {BBOX_T} timesteps: "
        f"{BBOX_BATCH_TIMED / sec:.1f} images/s, "
        f"{sec / BBOX_T * 1e3:.3f} ms/step ({card}); launches {counts}")
    if not bool(torch.isfinite(out).all()) or \
            counts["groupnorm_silu"] != 8 * 3 * BBOX_T or \
            counts["groupnorm_silu_split"] != 2 * 3 * BBOX_T:
        fail("the batch-64 bbox run is not finite or missed its launches")
    profile_steps(f"bbox composition, batch {BBOX_BATCH_TIMED}, "
                  f"{PROFILE_STEPS} steps", lambda: run_bbox(
                      n=PROFILE_STEPS, b=BBOX_BATCH_TIMED), PROFILE_STEPS)
    del noise, out

    # 14. gray + color DDIM: a 1-channel shape expert beside a color one
    shape_p, color_p = entry.load_unets(
        [convert.from_flax(convert.init_params(m, seed=40 + i))
         for i, m in enumerate((entry.GRAY_UNET, entry.SHAPES_UNET))],
        dtype=torch.float32)
    img = (GC_BATCH, 64, 64, 3)
    x = torch.randn(img, generator=gen, device="cuda")
    sl, cl = (torch.randint(0, 3, (GC_BATCH,), generator=gen, device="cuda")
              for _ in range(2))
    for op, protocol in (("avg", "white"), ("proj", "luma_norm")):
        def run_gc(n=GC_STEPS, op=op, protocol=protocol, **kw):
            return entry.sample_gray_color(shape_p, color_p, x, sl, cl,
                                           op=op, gray_protocol=protocol,
                                           n_steps=n, **kw)
        launches[f"gray_color_{op}"] = k4_path(
            card, f"gray + color DDIM, op {op} ({protocol}; batch "
            f"{GC_BATCH}, 64 x 64, {GC_STEPS} steps, float32)", run_gc,
            2 * GC_STEPS, GC_BATCH, GC_STEPS, img, kernels, attention, unet)
        sync_free(f"gray + color DDIM, op {op}", lambda run=run_gc: run(n=2))
    return launches


def ddim_family(card, convert, entry, unet, kernels, attention, compose,
                samplers) -> dict:
    """Phase 15: the DDIM variants and DPM-Solver++(2M) on path A's two bf16
    experts, as ``entry.sample_shapes`` builds its prediction."""
    import dataclasses
    from composable_diffusion_models_tpu_torch.experts import (ExpertStack,
                                                               per_expert)
    from composable_diffusion_models_tpu_torch.schedules import VPSchedule
    gen = torch.Generator(device="cuda").manual_seed(13)
    params = entry.load_unets(
        [convert.from_flax(convert.init_params(entry.SHAPES_UNET, seed=i))
         for i in range(entry.N_SHAPES_EXPERTS)])
    x = torch.randn(A_BATCH, 64, 64, 3, generator=gen, device="cuda")
    labs = per_expert(torch.randint(0, 3, (entry.N_SHAPES_EXPERTS, A_BATCH),
                                    generator=gen, device="cuda"))
    w = compose.constant([1.0] * entry.N_SHAPES_EXPERTS, torch.float32,
                         "cuda")
    grid = VPSchedule().ddim_grid(FAM_STEPS)
    gated_in = int((grid[1:] <= 0.5).sum())
    variants = [
        ("ddim eta=1", dict(eta=1.0, key=5), 0),
        ("ddim predict=x0", dict(predict="x0"), 0),
        ("ddim predict=v", dict(predict="v"), 0),
        ("ddim, 1 corrector step at t <= 0.5",
         dict(corrector_steps=1, corrector_t_max=0.5, key=6), gated_in),
        ("dpm_solver_pp_2m (logsnr)", None, 0)]
    launches = {}
    for label, kw, extra in variants:
        def run(n=FAM_STEPS, fused_gn=True, kw=kw):
            model = dataclasses.replace(entry.SHAPES_UNET,
                                        dtype=torch.bfloat16,
                                        fused_gn=fused_gn)
            stack = ExpertStack(model.apply, params)

            def eps_fn(xx, t):
                return compose.weighted(
                    stack(xx.bfloat16(), t.bfloat16(), labs).float(), w)
            with torch.inference_mode():
                if kw is None:
                    return samplers.dpm_solver_pp_2m(eps_fn, VPSchedule(), x,
                                                     n)
                return samplers.ddim(eps_fn, VPSchedule(), x, n, **kw)
        # a short run's corrector count differs: only the full one counts
        launches[label] = k4_path(
            card, f"{label} (path A's 2 experts, batch {A_BATCH}, "
            f"{FAM_STEPS} steps, bf16)", run,
            entry.N_SHAPES_EXPERTS * (FAM_STEPS + extra), A_BATCH, FAM_STEPS,
            (A_BATCH, 64, 64, 3), kernels, attention, unet, bf16=True)
        sync_free(label, lambda run=run: run(n=2))
    return launches


def k1_at(kernels, b, t, d, h) -> dict:
    """fused_dit_block in bf16 at (B, T, D) with H heads against its plain
    version on the same random inputs, timed by events and from a trace,
    beside its bound; the numbers for the JSON line."""
    gen = torch.Generator().manual_seed(16)
    dtype = torch.bfloat16
    args = block_inputs(b, t, d, dtype, gen)
    got = kernels.fused_dit_block(*args, h)
    torch.cuda.synchronize()
    ref = kernels.fused_dit_block_ref(*args, h)
    err, tol = max_err(got, ref), tolerance(dtype, ref, 2e-4)
    ms = time_ms(lambda: kernels.fused_dit_block(*args, h))
    dev = device_ms(lambda: kernels.fused_dit_block(*args, h))
    plain = time_ms(lambda: kernels.fused_dit_block_ref(*args, h))
    flops = 2 * b * t * 12 * d * d + 4 * b * t * t * d
    nbytes = 2 * (2 * b * t * d + 12 * d * d + 9 * d)
    bms, by = bound_ms(flops, nbytes, dtype)
    log(f"fused_dit_block bf16 B={b} T={t} D={d} H={h} (one image a block): "
        f"max_abs_err={err:.3e} tol={tol:.3e}; kernel {ms:.4f} ms ({dev:.4f} "
        f"ms on the device in a trace), plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
        f"MB)")
    if not err <= tol:
        fail(f"fused_dit_block disagrees with its plain version at "
             f"{(b, t, d)}")
    return dict(shape=[b, t, d, h], max_abs_err=err, ms=ms, device_ms=dev,
                plain_ms=plain, bound_ms=bms, bound_by=by)


def loss_curve(label: str, losses) -> None:
    """Prints a loss curve's start and end; fails unless the mean of its
    last 50 steps is below half the mean of its first 10."""
    loss = losses.float().cpu()
    first, last = float(loss[:10].mean()), float(loss[-50:].mean())
    curve = ", ".join(f"{float(loss[j:j + 50].mean()):.4f}"
                      for j in range(0, len(loss), 50))
    log(f"  {label}: mean loss of the first 10 steps {first:.4f}, of the "
        f"last 50 {last:.4f}; 50-step window means: {curve}")
    if not (math.isfinite(last) and last < 0.5 * first):
        fail(f"{label}'s loss did not fall below half its start")


@contextlib.contextmanager
def per_call_launches(module, name: str, kernels, attention, record: list):
    """Patches ``module.name`` so that each call counts its launches from 0
    and appends (launches, seconds) to ``record``."""
    orig = getattr(module, name)

    def run(*args, **kw):
        reset_launches(kernels, attention)
        out, sec = timed(lambda: orig(*args, **kw))
        record.append((read_launches(kernels, attention), sec))
        return out
    with mock.patch.object(module, name, run):
        yield


def shapes_gate_path(card, entry, dit, kernels, attention) -> dict:
    """Phase 16. Returns the launches of each configuration's first 9-cell
    pass, the trained trees and the gate's probe."""
    from composable_diffusion_models_tpu_torch import data, train
    from composable_diffusion_models_tpu_torch import eval as ceval
    from composable_diffusion_models_tpu_torch.rng import Draws
    from composable_diffusion_models_tpu_torch.schedules import VPSchedule

    # a. the dataset on the card
    full, sec = timed(lambda: data.make_shapes_dataset(SG_DATA_N, SG_IMG,
                                                       device="cuda"))
    log(f"shapes gate: {SG_DATA_N} shapes of {SG_IMG} x {SG_IMG} x 3 made "
        f"on the card in {sec:.3f} s")

    # b. each configuration's shape and color experts
    trees = {}
    for cfg in entry.SHAPES_GATE_CONFIGS:
        compute = ("bf16 compute, GroupNorm in PyTorch ops"
                   if cfg.startswith("unet")
                   else "float32 compute, einsum attention")
        (trees[cfg], losses), sec = timed(lambda: entry.train_shapes_experts(
            cfg, SG_TRAIN_STEPS, SG_BATCH, data_n=SG_DATA_N, img=SG_IMG,
            dataset=full))
        steps = 2 * SG_TRAIN_STEPS
        log(f"  {cfg}: shape and color experts x {SG_TRAIN_STEPS} steps, "
            f"batch {SG_BATCH}, {compute}, Adam 2e-4, clip 1.0, EMA 0.999: "
            f"{sec:.1f} s = {steps / sec:.2f} train steps/s = "
            f"{steps * SG_BATCH / sec:.0f} train images/s (init and "
            f"first-call set-up included) ({card})")
        for i, loss in enumerate(losses):
            loss_curve(f"{cfg} {('shape', 'color')[i]} expert", loss)
        for tree in trees[cfg]:
            if not all(bool(torch.isfinite(leaf).all())
                       for leaf in train.flatten(tree)[1]):
                fail(f"a {cfg} EMA tree is not finite")
        # steady state of one expert's training, then a short profile
        model, _ = entry.shapes_gate_model(cfg, SG_IMG)

        def run(model=model, p0=trees[cfg][0]):
            return train.train_expert(
                3, model.apply, p0, VPSchedule(), full[0], (full[1],),
                steps=SG_PROFILE_STEPS, batch_size=SG_BATCH, ema_decay=0.999,
                clip_norm=1.0)
        run()
        _, sec = timed(run)
        log(f"  {cfg}: {SG_PROFILE_STEPS} steps of one expert without the "
            f"profiler: {sec / SG_PROFILE_STEPS * 1e3:.3f} ms/step = "
            f"{SG_BATCH * SG_PROFILE_STEPS / sec:.0f} train images/s")
        profile_steps(f"{cfg} training, {SG_PROFILE_STEPS} steps of one "
                      f"expert, batch {SG_BATCH}", run, SG_PROFILE_STEPS)

    # c. the gate: the probe, the 9 cells of each configuration through
    # the served programs (warmed at the cells' batch first), the judge
    served = {"unet64": entry.SHAPES_GATE_CONFIGS[0],
              "dit": entry.SHAPES_GATE_CONFIGS[1]}
    _, unet_serve = entry.shapes_gate_model(served["unet64"], SG_IMG)
    _, dit_serve = entry.shapes_gate_model(served["dit"], SG_IMG)
    unet_params = entry.load_unets(trees[served["unet64"]])
    dit_params = entry.load_experts(trees[served["dit"]])
    x = Draws(40, "cuda").normal((SG_SAMPLES, SG_IMG, SG_IMG, 3))
    labs_u = torch.zeros((2, SG_SAMPLES), dtype=torch.long, device="cuda")
    labs_d = torch.zeros((2, 1), dtype=torch.long, device="cuda")
    profile_steps(f"unet64 cell, {PROFILE_STEPS} steps of 2 forwards, "
                  f"batch {SG_SAMPLES}",
                  lambda: entry.sample_shapes(unet_params, x, labs_u,
                                              PROFILE_STEPS,
                                              model=unet_serve),
                  PROFILE_STEPS)
    profile_steps(f"dit_p8_d256_l8 cell, {PROFILE_STEPS} steps of 2 "
                  f"forwards, batch {SG_SAMPLES}",
                  lambda: entry.sample(dit_params, x, PROFILE_STEPS,
                                       labels=(labs_d,), model=dit_serve),
                  PROFILE_STEPS)
    cells = {"sample_shapes": [], "sample": []}
    with per_call_launches(entry, "sample_shapes", kernels, attention,
                           cells["sample_shapes"]), \
            per_call_launches(entry, "sample", kernels, attention,
                              cells["sample"]), \
            last_output(ceval, "train_probe") as probe_box:
        reports, sec = timed(lambda: entry.quality_gate_shapes(
            probe_steps=SG_PROBE_STEPS, samples_per_cell=SG_SAMPLES,
            n_steps=SG_STEPS, train_steps=SG_TRAIN_STEPS, experts=trees))
    log(f"  quality_gate_shapes (probe {SG_PROBE_STEPS} steps, 9 cells x "
        f"{SG_SAMPLES} samples x {SG_STEPS} steps per configuration, the "
        f"experts above): {sec:.1f} s")
    want = {"sample_shapes": dict(groupnorm_silu=8 * 2 * SG_STEPS,
                                  groupnorm_silu_split=2 * 2 * SG_STEPS),
            "sample": dict(fused_dit_block=dit_serve.depth * 2 * SG_STEPS)}
    first_pass = {}
    for fn, cfg in (("sample_shapes", served["unet64"]),
                    ("sample", served["dit"])):
        rec = cells[fn]
        report = reports[cfg]
        n = report["n_samples"]
        if len(rec) not in (9, 18):
            fail(f"{cfg}: {len(rec)} cells served, expected 9 (18 with the "
                 f"escalation)")
        for counts, _ in rec:
            expect = dict.fromkeys(counts, 0)
            expect.update(want[fn])
            if counts != expect:
                fail(f"{cfg}: a cell launched {counts}, expected {expect}")
        first_pass[cfg] = {k: 9 * v for k, v in want[fn].items()}
        cell_sec = [s_ for _, s_ in rec[:9]]
        gflop = (entry.unet_gflop_per_image(unet_serve, SG_IMG, SG_IMG)
                 if fn == "sample_shapes"
                 else entry.dit_gflop_per_image(dit_serve)) * 2 * SG_STEPS
        log(f"  {cfg}: 9 cells of {SG_SAMPLES} in {sum(cell_sec):.3f} s = "
            f"{9 * SG_SAMPLES / sum(cell_sec):.1f} images/s (cells "
            f"{min(cell_sec):.3f}-{max(cell_sec):.3f} s); {gflop:.1f} "
            f"GFLOP/image -> {gflop * 9 * SG_SAMPLES / sum(cell_sec) / 1e3:.1f}"
            f" TFLOP/s; launches per cell {rec[0][0]}; probe held-in "
            f"{report['probe_heldin']}; composed {report['composed']}"
            + (f"; escalated to {n} samples a cell" if len(rec) == 18
               else ""))
        log(f"  {cfg}: verdict {report['verdict']} against "
            f"{report['baseline_config']} (an under-trained run: "
            f"{SG_TRAIN_STEPS} steps where the script takes 12000; not a "
            f"condition)")
        log(json.dumps({"shapes_gate": {"config": cfg, "criteria":
                                        report.get("criteria")}}))

    # d. trained cells against their plain paths, on the same noise
    out, sec = timed(lambda: entry.sample_shapes(
        unet_params, x, labs_u, SG_STEPS, model=unet_serve))
    ref, sec_p = timed(lambda: entry.sample_shapes(
        unet_params, x, labs_u, SG_STEPS, model=unet_serve, fused_gn=False))
    diff = (out - ref).abs()
    log(f"  trained unet64 cell (0, 0), bf16: kernel path vs fused_gn=False "
        f"after {SG_STEPS} steps: mean |diff| {float(diff.mean()):.4e}, max "
        f"{float(diff.max()):.4e}; |x| >= 1 at "
        f"{float((out.abs() >= 1).float().mean()):.3f} of the elements; "
        f"{SG_SAMPLES / sec:.1f} against {SG_SAMPLES / sec_p:.1f} images/s")
    if not float(diff.mean()) <= 0.05:
        fail("the trained unet64 cell's kernel path drifts from its plain "
             "path")
    p32 = entry.load_unets(trees[served["unet64"]], dtype=torch.float32)
    out32 = entry.sample_shapes(p32, x, labs_u, SG_STEPS, model=unet_serve,
                                dtype=torch.float32)
    ref32 = entry.sample_shapes(p32, x, labs_u, SG_STEPS, model=unet_serve,
                                dtype=torch.float32, fused_gn=False)
    scale = max(1.0, float(ref32.abs().max()))
    err32 = max_err(out32, ref32)
    log(f"  the same cell in float32: max |diff| {err32:.3e}, mean "
        f"{float((out32 - ref32).abs().mean()):.3e} at scale {scale:.3g} "
        f"(bar 1e-3 of the scale, per element)")
    if not err32 <= 1e-3 * scale:
        fail("the trained unet64 cell in float32 disagrees with its plain "
             "path")
    del p32, out32, ref32
    out = entry.sample(dit_params, x, SG_STEPS, labels=(labs_d,),
                       model=dit_serve)
    with mock.patch.object(dit, "fused_dit_block",
                           kernels.fused_dit_block_ref):
        ref = entry.sample(dit_params, x, SG_STEPS, labels=(labs_d,),
                           model=dit_serve)
    diff = (out - ref).abs()
    log(f"  trained dit_p8_d256_l8 cell (0, 0), bf16: fused_dit_block vs "
        f"its plain version after {SG_STEPS} steps: mean |diff| "
        f"{float(diff.mean()):.4e}, max {float(diff.max()):.4e}; |x| >= 1 at "
        f"{float((out.abs() >= 1).float().mean()):.3f} of the elements")
    if not float(diff.mean()) <= 0.05:
        fail("the trained DiT cell's kernel path drifts from its plain path")
    probe, probe_params = probe_box["out"]
    return dict(launches=first_pass, trees=trees, probe=(probe, probe_params))


def nll_and_samplers(card, entry, samplers, kernels, attention, tree,
                     probe) -> None:
    """Phase 17 on the trained unet64 shape expert ``tree`` (float32 EMA)
    and the gate's probe."""
    import dataclasses
    from composable_diffusion_models_tpu_torch.schedules import VPSchedule
    reset_launches(kernels, attention)
    rep, sec = timed(lambda: entry.eval_nll(
        tree, entry.SHAPES_UNET, dataset="shapes",
        dataset_kw=dict(img_size=SG_IMG), n_data=NLL_N, n_steps=NLL_STEPS,
        n_probes=1, conditional=True, label_slots=(0,), seed=0))
    counts = read_launches(kernels, attention)
    log(f"NLL (entry.eval_nll): the trained unet64 shape expert, float32, "
        f"{NLL_N} shapes, {NLL_STEPS} steps, 1 Rademacher probe: "
        f"{rep['bits_per_dim_mean']:.4f} +- {rep['bits_per_dim_sem']:.4f} "
        f"bits/dim ({rep['nll_nats_mean']:.1f} nats) in {sec:.2f} s = "
        f"{NLL_N / sec:.1f} images/s ({card}); launches {counts}")
    if not all(math.isfinite(rep[k]) for k in ("bits_per_dim_mean",
                                               "nll_nats_mean")):
        fail("eval_nll's bits/dim are not finite")
    if any(counts.values()):
        fail(f"eval_nll launched a kernel inside its jvps: {counts}")

    params, = entry.load_unets([tree])  # bf16, served through K4
    model = dataclasses.replace(entry.SHAPES_UNET, dtype=torch.bfloat16,
                                fused_gn=True)
    sched = VPSchedule()
    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = PPF_STEPS * PPF_BATCH
    lab = torch.zeros((rows,), dtype=torch.long, device="cuda")

    # Picard sweeps of the float32 expert (K4 in float32): after as many
    # sweeps as time points the iteration has reached the sequential Euler
    # solve's fixed point, which prob_flow_ode computes one step at a time
    p32, = entry.load_unets([tree], dtype=torch.float32)
    m32 = dataclasses.replace(model, dtype=torch.float32)

    def score(x, t):
        eps = m32.apply(p32, x, t, lab[:x.shape[0]])
        return -eps / sched.sigma(t).reshape(-1, 1, 1, 1)
    x = torch.randn(PPF_BATCH, SG_IMG, SG_IMG, 3, generator=gen,
                    device="cuda")

    def ppf():
        with torch.inference_mode():
            return samplers.parallel_prob_flow(score, sched, x, PPF_STEPS,
                                               n_iters=PPF_STEPS)
    reset_launches(kernels, attention)
    (x_fin, resid), sec = timed(ppf)
    counts = read_launches(kernels, attention)
    with torch.inference_mode():
        seq, sec_seq = timed(lambda: samplers.prob_flow_ode(
            lambda xx, t: score(xx, t.expand(xx.shape[0])), sched, x,
            PPF_STEPS))
    scale = max(1.0, float(seq.abs().max()))
    err = max_err(x_fin, seq)
    log(f"parallel_prob_flow: the shape expert (float32, K4), batch "
        f"{PPF_BATCH}, {PPF_STEPS} time points folded into {rows} rows, "
        f"{PPF_STEPS} sweeps: {sec:.3f} s (prob_flow_ode, one step at a "
        f"time: {sec_seq:.3f} s); residuals "
        f"{[float(f'{float(r):.3g}') for r in resid]}; against "
        f"prob_flow_ode: max |diff| {err:.3e} at scale {scale:.3g} (bar "
        f"1e-3 of the scale); launches {counts}")
    if counts["groupnorm_silu"] != 8 * PPF_STEPS or \
            counts["groupnorm_silu_split"] != 2 * PPF_STEPS:
        fail(f"parallel_prob_flow launched {counts}, expected "
             f"{8 * PPF_STEPS} + {2 * PPF_STEPS} GroupNorm kernels")
    if not err <= 1e-3 * scale:
        fail("parallel_prob_flow's fixed point is not the sequential solve")
    sync_free("parallel_prob_flow", lambda: ppf()[0])
    del p32

    probe_model, probe_params = probe
    xg = torch.randn(CG_BATCH, SG_IMG, SG_IMG, 3, generator=gen,
                     device="cuda")

    def eps_fn(xx, t):
        return model.apply(params, xx.bfloat16(), t.bfloat16(),
                           lab[:xx.shape[0]]).float()

    def ddim(fn):
        with torch.no_grad():  # the guidance's gradient needs a graph
            return samplers.ddim(fn, sched, xg, CG_STEPS)

    def colors(o):
        return probe_model.apply(probe_params, o.clamp(-1, 1))[1].argmax(-1)
    # the color the probe reads least in the unguided circles is the target
    target = int(torch.bincount(colors(ddim(eps_fn)), minlength=3).argmin())

    def logp(xx, t):
        return torch.log_softmax(probe_model.apply(probe_params, xx)[1],
                                 dim=-1)[:, target]
    guided = samplers.make_classifier_guided_eps_fn(eps_fn, sched, logp,
                                                    CG_SCALE)
    out, sec = timed(lambda: ddim(guided))
    hits = [float((colors(o) == target).float().mean())
            for o in (out, ddim(eps_fn))]
    log(f"classifier-guided ddim: the shape expert's circles steered by the "
        f"gate's probe to color {target} (the one it reads least unguided) "
        f"at scale {CG_SCALE}, batch {CG_BATCH}, {CG_STEPS} steps: "
        f"{sec:.3f} s; the probe reads color {target} in {hits[0]:.3f} of "
        f"the guided samples, {hits[1]:.3f} of the unguided (not a "
        f"condition)")
    if not bool(torch.isfinite(out).all()):
        fail("classifier-guided ddim's output is not finite")
    sync_free("classifier-guided ddim", lambda: ddim(guided))


def read_png(path: str):
    """(width, height, pixels) of an 8-bit RGB PNG with filter-0 rows, the
    form ``utils.viz.save_grid`` writes, decoded with zlib."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} lacks the PNG signature")
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        chunks[kind] = chunks.get(kind, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = torch.frombuffer(bytearray(zlib.decompress(chunks[b"IDAT"])),
                           dtype=torch.uint8).reshape(h, 1 + 3 * w)
    return w, h, raw[:, 1:].reshape(h, w, 3).numpy()


def train_named(card, entry, kernels, attention, preset: str, names,
                subsets, overrides, conditional: bool, batch: int) -> list:
    """``entry.train_image`` for each (name, digit subset): time, train
    images/s, the loss curve (held: last 50 below half the first 10), no
    kernel launched. Returns the trained trees."""
    trees = []
    for name, classes in zip(names, subsets):
        reset_launches(kernels, attention)
        (tree, losses, _), sec = timed(lambda: entry.train_image(
            preset, name, classes=classes, conditional=conditional,
            out=SMOKE_OUT, overrides=overrides))
        counts = read_launches(kernels, attention)
        steps = losses.shape[0]
        log(f"  {preset} expert {name} (digits {classes}), {steps} steps at "
            f"batch {batch}: {sec:.1f} s = {sec / steps * 1e3:.2f} ms/step = "
            f"{batch * steps / sec:.0f} train images/s (data, init and "
            f"first-call set-up included) ({card}); launches {counts}")
        if any(counts.values()):
            fail(f"training {name} launched a kernel: {counts}")
        loss_curve(f"{preset} {name}", losses)
        trees.append(tree)
    return trees


def same_bits(trees, loaded, label: str) -> None:
    from composable_diffusion_models_tpu_torch import train
    for a, b in zip(trees, loaded):
        pa, la = train.flatten(a)
        pb, lb = train.flatten(b)
        if pa != pb or not all(torch.equal(x, y) for x, y in zip(la, lb)):
            fail(f"{label}: the trees read back are not the trees saved")
    log(f"  {label}: {len(trees)} trees saved through CheckpointManager and "
        f"read back by name (entry.load_named): bit for bit")


def trained_superdiff(card, entry, unet, kernels, attention,
                      compose) -> dict:
    """Phase 18. Returns the launches of each SUPERDIFF call."""
    log(f"colored_mnist_guided: two GUIDED_UNET experts (base 64, (1, 2, 4), "
        f"digit and color slots with the null token) through "
        f"entry.train_image, batch 128, float32, DDPMSchedule(1000), label "
        f"dropout 0.1 to (10, 10); the preset's 4000 steps cut to "
        f"{TRAIN_CFG_STEPS} for time")
    names = ("guided_a", "guided_b")
    trees = train_named(card, entry, kernels, attention,
                        "colored_mnist_guided", names, GUIDED_SUBSETS,
                        [f"--train.steps={TRAIN_CFG_STEPS}"], True, 128)
    loaded = entry.load_named("colored_mnist_guided", names, SMOKE_OUT)
    same_bits(trees, loaded, "colored_mnist_guided experts")
    del trees
    gen = torch.Generator(device="cuda").manual_seed(18)
    img = (SD_BATCH, 28, 28, 3)
    x = torch.randn(img, generator=gen, device="cuda")
    # per-expert (digit, color): a digit of each expert's subset in its
    # own colour (the preset's per-digit colours)
    labels = torch.tensor([[3, 3], [7, 7]], device="cuda")
    noise = {False: torch.randn((SD_T,) + img, generator=gen, device="cuda"),
             True: torch.randn((SD_T, 2) + img, generator=gen,
                               device="cuda")}
    launches = {}
    for op, rigorous, kappa_fn in (("OR", False, "or_softmax"),
                                   ("AND", True, "and_solve_k")):
        def run(n=SD_T, op=op, rigorous=rigorous, **kw):
            return entry.sample_superdiff(
                loaded, x, labels, operation=op, rigorous_and=rigorous,
                num_timesteps=n, noise=noise[rigorous] if n == SD_T else None,
                **kw)
        name = f"SUPERDIFF {'rigorous ' if rigorous else ''}{op}"
        launches[f"trained_superdiff_{'solve_' if rigorous else ''}"
                 f"{op.lower()}"] = k4_path(
            card, f"{name} on the TRAINED guided experts (batch {SD_BATCH}, "
            f"{SD_T} timesteps, float32, labels (3, 3) and (7, 7))", run,
            2 * SD_T, SD_BATCH, SD_T, img, kernels, attention, unet,
            compose, kappa_fn)
        sync_free(f"{name} on the trained experts", lambda run=run: run(n=2))
    return launches


@contextlib.contextmanager
def loaded_once(entry, trees: dict):
    """The entry points read ``trees`` (by name) instead of their
    checkpoints and write no grid: what is left is the sampler."""
    from composable_diffusion_models_tpu_torch.utils import viz
    with mock.patch.object(entry, "load_named",
                           lambda preset, names, *a, **k: [trees[n]
                                                           for n in names]), \
            mock.patch.object(viz, "save_grid", lambda *a, **k: None):
        yield


def preset_paths(card, entry, unet, kernels, attention) -> dict:
    """Phase 19. Returns the launches of the sample_image and
    compose_scores calls."""
    log(f"mnist_image: two UNet experts (base 64, (1, 2, 4), 28 x 28 x 1) "
        f"through entry.train_image, batch 128, float32, VPSchedule; the "
        f"preset's 4000 steps cut to {TRAIN_CFG_STEPS} for time")
    names = ("expert_a", "expert_b")
    trees = train_named(card, entry, kernels, attention, "mnist_image",
                        names, MNIST_SUBSETS,
                        [f"--train.steps={TRAIN_CFG_STEPS}"], False, 128)
    loaded = entry.load_named("mnist_image", names, SMOKE_OUT)
    same_bits(trees, loaded, "mnist_image experts")
    del trees
    launches = {}
    shape = (PRESET_BATCH, 28, 28, 1)

    def run_s(n=PRESET_STEPS, **kw):
        return entry.sample_image("mnist_image", "expert_a", sampler="ddim",
                                  out=SMOKE_OUT,
                                  overrides=[f"--sample.n_steps={n}"], **kw)
    launches["sample_image"] = k4_path(
        card, f"sample_image, ddim (expert_a, batch {PRESET_BATCH}, "
        f"{PRESET_STEPS} steps, float32)", run_s, PRESET_STEPS, PRESET_BATCH,
        PRESET_STEPS, shape, kernels, attention, unet)
    out = run_s()
    path = f"{SMOKE_OUT}/mnist_image/run_0/results/expert_a_samples.png"
    from composable_diffusion_models_tpu_torch.utils import viz
    w, h, pixels = read_png(path)
    grid = viz._to_numpy_grid(out.cpu().numpy(), 8)
    if (h, w) != grid.shape[:2] or not (pixels == grid).all():
        fail("the PNG does not hold the sample grid")
    log(f"  {path.split('/')[-1]}: PNG signature, IHDR {w} x {h}, every "
        f"pixel equal to viz._to_numpy_grid of the samples")

    def run_c(n=PRESET_STEPS, **kw):
        return entry.compose_scores("mnist_image", names, sampler="em",
                                    out=SMOKE_OUT,
                                    overrides=[f"--sample.n_steps={n}"], **kw)

    def plain_blend():
        return mock.patch.object(entry, "blend_eps", kernels.blend_eps_ref)
    launches["compose_scores"] = k4_path(
        card, f"compose_scores, em (expert_a + expert_b, unit weights, batch "
        f"{PRESET_BATCH}, {PRESET_STEPS} steps, float32)", run_c,
        2 * PRESET_STEPS, PRESET_BATCH, PRESET_STEPS, shape, kernels,
        attention, unet, also={"blend_eps": PRESET_STEPS}, plain=plain_blend)
    out = run_c()
    reset_launches(kernels, attention)
    out_w, sec = timed(lambda: run_c(fused_blend=False))
    counts = read_launches(kernels, attention)
    want = dict.fromkeys(counts, 0)
    want.update(groupnorm_silu=8 * 2 * PRESET_STEPS,
                groupnorm_silu_split=2 * 2 * PRESET_STEPS)
    log(f"  compose_scores with fused_blend=False (compose.weighted): "
        f"{PRESET_BATCH / sec:.1f} images/s; launches {counts}; against "
        f"blend_eps: max |diff| {max_err(out, out_w):.3e}")
    if counts != want:
        fail(f"compose_scores(fused_blend=False) launched {counts}")
    with loaded_once(entry, dict(zip(names, loaded))):
        sync_free("sample_image, ddim (checkpoint loaded, no grid)",
                  lambda: run_s(n=2))
        sync_free("compose_scores, em (checkpoints loaded, no grid)",
                  lambda: run_c(n=2))
    return launches


def vae_paths(card, entry, kernels, attention) -> dict:
    """Phase 20. Returns the launches of compose_latent_vae(weighted)."""
    reset_launches(kernels, attention)
    res, sec = timed(lambda: entry.train_vae(
        vae_steps=VAE_STEPS, diff_steps=VAE_STEPS, out=SMOKE_OUT))
    counts = read_launches(kernels, attention)
    vl, dl = res["vae_losses"].cpu(), res["diff_losses"].cpu()
    log(f"train_vae (mnist_image: 8192 procedural digits of 28 x 28 x 1, "
        f"BetaVAE latent 10 base 32, Adam 1e-3 at batch 128; then the "
        f"latent expert under DDPMSchedule(300) at batch 256; the script's "
        f"2000 + 2000 steps cut to {VAE_STEPS} + {VAE_STEPS}): {sec:.1f} s "
        f"({card}); VAE loss (BCE + KL a sample) first 10 steps "
        f"{float(vl[:10].mean()):.2f}, last 50 {float(vl[-50:].mean()):.2f}; "
        f"latent expert first 10 {float(dl[:10].mean()):.4f}, last 50 "
        f"{float(dl[-50:].mean()):.4f}; launches {counts}")
    if any(counts.values()):
        fail(f"train_vae launched a kernel: {counts}")
    if not (bool(torch.isfinite(vl).all()) and bool(torch.isfinite(dl).all())
            and float(vl[-50:].mean()) < float(vl[:10].mean())):
        fail("train_vae's losses are not finite or did not fall")
    launches = {}
    for mode in ("weighted", "cfg"):
        def run(mode=mode, **kw):
            return entry.compose_latent_vae(mode=mode, out=SMOKE_OUT, **kw)
        run()
        reset_launches(kernels, attention)
        imgs, sec = timed(run)
        counts = read_launches(kernels, attention)
        want = dict.fromkeys(counts, 0)
        want["blend_eps"] = 300 if mode == "weighted" else 0
        with mock.patch.object(entry, "blend_eps", kernels.blend_eps_ref):
            ref, sec_p = timed(run)
        imgs_w = run(fused_blend=False)
        log(f"compose_latent_vae, {mode} (digits (3, 5), bs 16, 300 "
            f"timesteps, float32; the checkpoint read each call): "
            f"{16 / sec:.1f} decoded images/s ({card}), plain path "
            f"{16 / sec_p:.1f}; launches {counts}; kernel path vs plain path "
            f"max |diff| {max_err(imgs, ref):.3e} (bar 1e-3), vs "
            f"fused_blend=False (compose.weighted) {max_err(imgs, imgs_w):.3e}"
            f"; images in [{float(imgs.min()):.3f}, {float(imgs.max()):.3f}]")
        if counts != want:
            fail(f"compose_latent_vae({mode}) launched {counts}, expected "
                 f"{want}")
        if not bool(torch.isfinite(imgs).all()) or \
                tuple(imgs.shape) != (16, 28, 28, 1):
            fail(f"compose_latent_vae({mode}): bad output")
        if not max_err(imgs, ref) <= 1e-3:
            fail(f"compose_latent_vae({mode}): the kernel path disagrees "
                 f"with the plain path")
        launches[f"compose_latent_vae_{mode}"] = counts
    return launches


def latent_trained(card, entry, kernels, attention, samplers) -> dict:
    """Phase 21. Returns the launches of each train_latent_2d call and of
    sample_latent's ddim and em calls on the trained experts."""
    reset_launches(kernels, attention)
    codec, sec = timed(lambda: entry.fit_pca("shapes_latent", out=SMOKE_OUT))
    counts = read_launches(kernels, attention)
    log(f"fit_pca (shapes_latent: 10000 shapes of 64 x 64 x 1 made on the "
        f"card, 2 components): {sec:.2f} s ({card}); explained variance "
        f"{[round(v, 3) for v in codec.explained_variance.tolist()]}; "
        f"launches {counts}")
    if any(counts.values()):
        fail(f"fit_pca launched a kernel: {counts}")
    launches = {}
    for name, hold in LT_HOLDOUTS.items():
        reset_launches(kernels, attention)
        (_, losses, _), sec = timed(lambda: entry.train_latent_2d(
            "shapes_latent", name=name, out=SMOKE_OUT,
            overrides=[f"--train.steps={LT_STEPS}",
                       f"--data.holdout={hold}"]))
        counts = read_launches(kernels, attention)
        want = dict.fromkeys(counts, 0)
        want["matmul"] = 1
        log(f"train_latent_2d {name} (holdout {hold}; ScoreMLP(256, 3, 2), "
            f"batch 512, lr 1e-3; the preset's 4000 steps cut to {LT_STEPS})"
            f": {sec:.2f} s = {sec / LT_STEPS * 1e3:.2f} ms/step ({card}); "
            f"launches {counts} (the encode)")
        if counts != want:
            fail(f"train_latent_2d {name} launched {counts}, expected {want}")
        loss_curve(f"shapes_latent {name}", losses)
        launches[f"train_latent_2d_{name}"] = counts
    trees = entry.load_named("shapes_latent", tuple(LT_HOLDOUTS), SMOKE_OUT)
    pca = entry.load_pca(os.path.join(SMOKE_OUT, "pca"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    z0 = torch.randn(LATENT_BATCH, 2, generator=gen, device="cuda")
    noise = torch.randn((LATENT_STEPS, LATENT_BATCH, 2), generator=gen,
                        device="cuda")
    for op in ("ddim", "em"):
        def run(n=LATENT_STEPS, op=op, **kw):
            return entry.sample_latent(
                trees, pca, z0, op=op, n_steps=n,
                noise=noise if op == "em" and n == LATENT_STEPS else None,
                **kw)
        run(n=2)
        reset_launches(kernels, attention)
        (z, imgs), sec = timed(run)
        counts = read_launches(kernels, attention)
        want = dict.fromkeys(counts, 0)
        want.update(blend_eps=LATENT_STEPS, matmul=1)
        with mock.patch.object(kernels, "matmul", kernels.matmul_ref):
            z_p, img_p = run(fused_blend=False)
        scale = max(1.0, float(z_p.abs().max()))
        err_z, err_i = max_err(z, z_p), max_err(imgs, img_p)
        log(f"sample_latent {op} on the TRAINED experts ({LATENT_BATCH} "
            f"latents, the preset's {LATENT_STEPS} steps, decode to 64 x 64):"
            f" {sec:.3f} s = {LATENT_BATCH / sec:.1f} latents/s ({card}); "
            f"launches {counts}; kernel path vs plain path: latents max "
            f"|diff| {err_z:.3e} at scale {scale:.2f}, images {err_i:.3e} "
            f"(tol 1e-3 of the scale); |z| max {float(z.abs().max()):.2f}")
        if counts != want:
            fail(f"sample_latent {op} launched {counts}, expected {want}")
        if not (bool(torch.isfinite(z).all()) and tuple(imgs.shape) ==
                (LATENT_BATCH, LATENT_SIZE, LATENT_SIZE, 1)):
            fail(f"sample_latent {op} on the trained experts: bad output")
        if not (err_z <= 1e-3 * scale and err_i <= 1e-3 * scale):
            fail(f"sample_latent {op}: the kernel path disagrees with the "
                 f"plain path")
        launches[f"latent_trained_{op}"] = counts
        sync_free(f"sample_latent {op} on the trained experts",
                  lambda run=run: run(n=2)[0])
    reset_launches(kernels, attention)
    res, sec = timed(lambda: entry.superposition_2d(
        steps=SP_STEPS, out=os.path.join(SMOKE_OUT, "superposition_2d")))
    counts = read_launches(kernels, attention)
    x, ll = res["samples"], res["ll"]
    log(f"superposition_2d (two ScoreMLP(512, 4, 2) on the toy2d halves, "
        f"batch 512, VPSchedule(jax_faithful); the script's 20000 steps cut "
        f"to {SP_STEPS}, its 1000 sampling steps over 512 points): "
        f"{sec:.1f} s ({card}); launches {counts}; samples mean "
        f"{[round(v, 3) for v in x.mean(0).tolist()]}, |ll1 - ll2| mean "
        f"{float((ll[0] - ll[1]).abs().mean()):.3f}")
    if any(counts.values()):
        fail(f"superposition_2d launched a kernel: {counts}")
    if not (bool(torch.isfinite(x).all()) and bool(torch.isfinite(ll).all())
            and tuple(x.shape) == (512, 2) and tuple(ll.shape) == (2, 512)):
        fail("superposition_2d: bad output")
    for label, losses in zip(("up", "down"), res["losses"]):
        loss_curve(f"superposition_2d {label} expert", losses)
    from composable_diffusion_models_tpu_torch.models.mlp import ScoreMLP
    from composable_diffusion_models_tpu_torch.schedules import VPSchedule
    m = ScoreMLP(hidden=512, depth=4, out_dim=2)
    fns = tuple((lambda x_, t, p=p: m.apply(p, t.expand(x_.shape[0]), x_))
                for p in res["experts"])

    def sp_run():
        with torch.no_grad():
            return samplers.superposition_2d(
                fns, VPSchedule(kind="jax_faithful"),
                torch.Generator(device="cuda").manual_seed(0), x, 2)[0]
    sync_free("superposition_2d sampler", sp_run)
    return launches


def composer_run(ec, cfg, experts, op: str, labels, gpp=None):
    """``run(n=, fused_gn=)``: one combination of eval_composition's
    operator ``op`` (the protocol's ``build_composer``) over the trained
    gray and color experts, with the key of combination (2, 2); ``gpp``:
    the guidance probe's tree."""
    sp, cp, _ = experts

    def run(n=EC_STEPS, fused_gn=True):
        comp = ec.build_composer(op, cfg, (3, 3), 64, n, f0_ch=1,
                                 fused_gn=fused_gn, gray_norm=True)
        return comp(sp, cp, gpp, labels, labels, (2.0, 1.0), 28)
    return run


def composition_eval(card, kernels, attention, unet) -> dict:
    """Phase 22. Returns the launches of each operator's eval_composition
    call and of each per-combination check, and the trained experts."""
    import glob
    from composable_diffusion_models_tpu_torch import eval_composition as ec
    from composable_diffusion_models_tpu_torch.convert import flax_init
    from composable_diffusion_models_tpu_torch.models.probe import (
        ProbeClassifier)
    overrides = [f"--train.steps={EC_TRAIN}"]
    log(f"eval_composition (shapes 3 x 3, 5000 images of 64 x 64 x 3 made on "
        f"the card, holdout (2, 2); a gray unet64 shape expert on the "
        f"unit-norm luma and an RGB unet64 color expert, base 64, (1, 2, 4), "
        f"null token, label dropout 0.1, float32, batch 128; the preset's "
        f"4000 steps cut to {EC_TRAIN}, the probe's 1200 to {EC_PROBE}, "
        f"{EC_SAMPLES} samples a combination, the script's 200 steps cut to "
        f"{EC_STEPS}, to {EC_ITO_STEPS} under ito); one call per operator, "
        f"the experts trained in the first")
    launches, forwards = {}, 9 * EC_STEPS * 2
    for op in EC_OPS:
        reset_launches(kernels, attention)
        rep, sec = timed(lambda op=op: ec.eval_composition(
            op=op, holdout=((2, 2),), samples_per_combo=EC_SAMPLES,
            probe_steps=EC_PROBE,
            n_steps=EC_ITO_STEPS if op == "ito" else EC_STEPS,
            factor0_grayscale=True,
            gray_norm=True, out=SMOKE_OUT, overrides=overrides))
        counts = read_launches(kernels, attention)
        want = dict.fromkeys(counts, 0)
        if op != "ito":
            want.update(groupnorm_silu=8 * forwards,
                        groupnorm_silu_split=2 * forwards)
        if op == "avg":
            want["blend_eps"] = 9 * EC_STEPS
        r = rep["ops"][op]
        log(f"eval_composition op {op}: {sec:.1f} s ({card}; the first call "
            f"trains the probe and both experts); launches {counts}; "
            f"seen_joint_acc {r['seen_joint_acc']:.3f}, heldout_joint_acc "
            f"{r['heldout_joint_acc']:.3f} (reported, not held: experts of "
            f"{EC_TRAIN} steps); held-out margin "
            f"{r['combos']['2,2']['joint_target_prob']:.3f}")
        if counts != want:
            fail(f"eval_composition {op} launched {counts}, expected {want}")
        accs = [c["joint_acc"] for c in r["combos"].values()]
        if len(accs) != 9 or not all(0.0 <= a <= 1.0 for a in accs):
            fail(f"eval_composition {op}: bad report")
        launches[f"eval_composition_{op}"] = counts
    cfg = ec.get_config("shapes_ddim", overrides)
    # the experts the four calls shared, from the protocol's cache
    path, = glob.glob(os.path.join(SMOKE_OUT, "eval_composition", "run_0",
                                   "results", "cache_experts_shapes_cell0_*"))
    experts = torch.load(path, map_location="cuda", weights_only=True)
    labels = torch.full((EC_SAMPLES,), 2, dtype=torch.long, device="cuda")
    img = (EC_SAMPLES, 64, 64, 3)
    for op in ("avg", "cfg", "proj"):
        run = composer_run(ec, cfg, experts, op, labels)

        def plain(op=op):
            return (mock.patch.object(ec, "blend_eps", kernels.blend_eps_ref)
                    if op == "avg" else contextlib.nullcontext())
        launches[f"eval_composition_{op}_cell"] = k4_path(
            card, f"eval_composition {op}, combination (2, 2) (held out), "
            f"weights (2, 1), batch {EC_SAMPLES}, {EC_STEPS} steps, float32",
            run, 2 * EC_STEPS, EC_SAMPLES, EC_STEPS, img, kernels, attention,
            unet, also={"blend_eps": EC_STEPS} if op == "avg" else None,
            plain=plain)
        sync_free(f"eval_composition {op} sampler", lambda run=run: run(n=2))
    run = composer_run(ec, cfg, experts, "ito", labels)
    reset_launches(kernels, attention)
    out, sec = timed(lambda: run(n=EC_ITO_STEPS))
    counts = read_launches(kernels, attention)
    log(f"eval_composition ito, combination (2, 2), batch {EC_SAMPLES}, "
        f"{EC_ITO_STEPS} steps (jvps through both experts, GroupNorm in "
        f"PyTorch ops): {sec:.3f} s = {sec / EC_ITO_STEPS * 1e3:.2f} ms/step"
        f" ({card}); launches {counts}")
    if any(counts.values()) or not bool(torch.isfinite(out).all()):
        fail(f"eval_composition ito launched {counts} or is not finite")
    sync_free("eval_composition ito sampler", lambda: run(n=2))
    # the gradient route: cg steers the blend by a guidance probe's
    # gradient; the experts see x without grad and stay on the kernels
    run = composer_run(ec, cfg, experts, "cg", labels, flax_init(
        ProbeClassifier((3, 3), in_channels=3), 22, "cuda"))
    reset_launches(kernels, attention)
    out, sec = timed(lambda: run(n=EC_CG_STEPS))
    counts = read_launches(kernels, attention)
    want = dict.fromkeys(counts, 0)
    want.update(groupnorm_silu=16 * EC_CG_STEPS,
                groupnorm_silu_split=4 * EC_CG_STEPS,
                blend_eps=EC_CG_STEPS)
    log(f"eval_composition cg (a guidance probe from its init, scale 2), "
        f"batch {EC_SAMPLES}, {EC_CG_STEPS} steps: {sec:.3f} s; launches "
        f"{counts}: the experts' and the blend's, none from the probe's "
        f"gradient")
    if counts != want or not bool(torch.isfinite(out).all()):
        fail(f"eval_composition cg launched {counts}, expected {want}")
    sync_free("eval_composition cg sampler", lambda: run(n=2))
    return {"launches": launches, "experts": experts}


def without_null_row(tree):
    """A one-slot conditional UNet tree with the null token's embedding
    row dropped: the expert restricted to its real labels, as a model
    without the null token reads it."""
    if isinstance(tree, dict):
        return {k: v[:-1] if k == "embedding" else without_null_row(v)
                for k, v in tree.items()}
    return tree


def superdiff_eval_and_ito(card, entry, kernels, attention, unet, compose,
                           experts) -> dict:
    """Phase 23. Returns the launches of the mixture protocol's call and of
    its OR check."""
    import glob
    from composable_diffusion_models_tpu_torch import eval_superdiff as es
    from composable_diffusion_models_tpu_torch.checkpoint import (
        CheckpointManager)
    from composable_diffusion_models_tpu_torch.schedules import DDPMSchedule
    from composable_diffusion_models_tpu_torch.utils import summarize, viz
    launches = {}
    sd_out = os.path.join(SMOKE_OUT, "superdiff_eval")
    reset_launches(kernels, attention)
    rep, sec = timed(lambda: es.eval_superdiff(
        protocol="mixture", T=SD_T, train_steps=EV_TRAIN,
        probe_steps=EV_PROBE, n_samples=EV_BATCH, out=sd_out))
    counts = read_launches(kernels, attention)
    forwards = 3 * 2 * SD_T
    want = dict.fromkeys(counts, 0)
    want.update(groupnorm_silu=8 * forwards, groupnorm_silu_split=2 * forwards)
    log(f"eval_superdiff mixture (colored MNIST 28 x 28 x 3, 8192 digits; two "
        f"unconditional unet64 experts on {{0-4}} and {{5-9}}, base 64, "
        f"batch 256, DDPMSchedule(1000), EMA 0.999; the script's 12000 steps "
        f"cut to {EV_TRAIN}, its probe's 2000 to {EV_PROBE}; OR, the AND "
        f"heuristic and the rigorous AND at T {SD_T}, {EV_BATCH} samples "
        f"each): "
        f"{sec:.1f} s ({card}); launches {counts}")
    for name, row in rep["ops"].items():
        log(f"  {name}: frac_expert_a {row['frac_expert_a']:.3f}, balance "
            f"error {row['mixture_balance_error']:.3f}, mean top probability "
            f"{row['mean_max_prob']:.3f}, class histogram {row['class_hist']}"
            f" (reported, not held)")
    if counts != want:
        fail(f"eval_superdiff mixture launched {counts}, expected {want}")
    launches["eval_superdiff_mixture"] = counts
    # the experts the call trained, from the protocol's cache; the OR job as
    # the call ran it (its key, its batch), held before the clip
    params = [torch.load(glob.glob(os.path.join(
        sd_out, f"cache_mixture_expert{i}_*.pt"))[0], map_location="cuda",
        weights_only=True) for i in range(2)]

    def run(n=SD_T, fused_gn=True):
        fn = es.mixture_stack(params, 64, n, "cuda", fused_gn)
        (_, job), = es.mixture_jobs(fn, DDPMSchedule(num_timesteps=n),
                                    EV_BATCH, [1.0], "cuda")[:1]
        with torch.no_grad():
            return job(entry._subkey(0, 50))
    launches["eval_superdiff_or_check"] = k4_path(
        card, f"eval_superdiff mixture OR job on the trained experts (batch "
        f"{EV_BATCH}, {SD_T} timesteps, float32, before the clip)", run,
        2 * SD_T, EV_BATCH, SD_T, (EV_BATCH, 28, 28, 3), kernels, attention,
        unet, compose, "or_softmax")
    sync_free("eval_superdiff mixture OR job", lambda: run(n=2))

    mgr = CheckpointManager(SMOKE_OUT, "shapes_ddim")
    sp, cp, _ = experts
    for name, tree in (("shape_expert", sp), ("color_expert", cp)):
        mgr.save(name, {"params": without_null_row(tree), "step": EC_TRAIN})
    reset_launches(kernels, attention)
    out, sec = timed(lambda: entry.compose_images_ito(
        n_steps=CI_STEPS, gray_protocol="luma_norm", out=SMOKE_OUT))
    counts = read_launches(kernels, attention)
    w, h, pixels = read_png(os.path.join(mgr.results_dir,
                                         "ito_composition_grid.png"))
    grid = viz._to_numpy_grid(out.cpu().numpy(), 3)
    same = (h, w) == grid.shape[:2] and bool((pixels == grid).all())
    log(f"compose_images_ito on phase 22's experts (their null-token rows "
        f"dropped; luma_norm, bs 1, 9 combinations, gaussian probes; the "
        f"script's 1000 steps cut to {CI_STEPS}): {sec:.1f} s = "
        f"{sec / (9 * CI_STEPS) * 1e3:.2f} ms/step ({card}); launches "
        f"{counts}; PNG {w} x {h}, every pixel equal to the grid of the "
        f"samples: {same}")
    if any(counts.values()):
        fail(f"compose_images_ito launched a kernel: {counts}")
    if tuple(out.shape) != (9, 64, 64, 3) or \
            not bool(torch.isfinite(out).all()):
        fail("compose_images_ito: bad output")
    if not same:
        fail("compose_images_ito: the PNG does not hold the sample grid")

    text = summarize.summarize_evals(
        [os.path.join(SMOKE_OUT, "eval_composition", "run_0", "results"),
         sd_out])
    n_rows = len(text.splitlines()) - 2
    log(f"summarize_evals over the reports of phases 22 and 23: {n_rows} "
        f"rows (the mixture report has no joint accuracy: no row)")
    if n_rows != len(EC_OPS):
        fail(f"summarize_evals gave {n_rows} rows, expected {len(EC_OPS)}")
    return launches

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from composable_diffusion_models_tpu_torch import (compose, convert, entry,
                                                       samplers)
    from composable_diffusion_models_tpu_torch.models import dit, unet
    from composable_diffusion_models_tpu_torch.ops import (_build, attention,
                                                           kernels)
    from composable_diffusion_models_tpu_torch.ops import pca as pca_codec

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    rows = check_kernels(kernels)
    rows.update(check_unet_kernels(kernels, attention))
    rows.update(check_latent_kernels(kernels, compose))
    ddpm_gn_rows = check_ddpm_gn_shapes(kernels)
    # fused_dit_block at the shapes gate's DiT cells (phase 16): timed here,
    # where traces keep their device records (after the profiles of the
    # later phases, a CUDA-only trace came back without them)
    k1_gate = k1_at(kernels, *SG_K1)

    # 4. main path
    trees = [convert.from_flax(convert.init_params(entry.FLAGSHIP, seed=i))
             for i in range(entry.N_EXPERTS)]
    params = entry.load_experts(trees)  # once, as a server would
    params32 = entry.load_experts(trees, dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    x_init = torch.randn(BATCH, 28, 28, 1, generator=gen).cuda()
    run_sampler(entry, params, x_init[:64], 2)  # warm-up: cuBLAS, caches
    reset_launches(kernels, attention)
    out, sec = run_sampler(entry, params, x_init, N_STEPS)
    launches = read_launches(kernels, attention)
    want = 4 * entry.N_EXPERTS * N_STEPS
    log(f"DiT path: {tuple(out.shape)} in {sec:.3f} s = "
        f"{BATCH / sec:.1f} images/s, {sec / N_STEPS * 1e3:.3f} ms/step "
        f"({card}); launches {launches}")
    if not bool(torch.isfinite(out).all()):
        fail("main path output is not finite")
    if tuple(out.shape) != (BATCH, 28, 28, 1):
        fail("main path output has the wrong shape")
    if launches["fused_dit_block"] != want:
        fail(f"fused_dit_block launched {launches['fused_dit_block']} "
             f"times, expected {want}")
    gflop = entry.gflop_per_image()
    log(f"  {gflop:.3f} GFLOP/image -> {gflop * BATCH / sec / 1e3:.1f} "
        f"TFLOP/s achieved")
    with mock.patch.object(dit, "fused_dit_block",
                           kernels.fused_dit_block_ref):
        out_plain, sec_plain = run_sampler(entry, params, x_init, N_STEPS)
    diff = (out - out_plain).abs()
    log(f"  plain versions: {BATCH / sec_plain:.1f} images/s, "
        f"{sec_plain / N_STEPS * 1e3:.3f} ms/step; kernel vs "
        f"plain bf16 after {N_STEPS} steps: mean |diff| "
        f"{float(diff.mean()):.4e}, max {float(diff.max()):.4e}")
    # bf16 trajectories of random-weight experts amplify single rounding
    # flips over 50 steps (phase 6 shows the same for a change of rounding
    # sites alone), so bf16 is held on the mean; float32 is exact up to
    # summation order and is held per element below.
    if not float(diff.mean()) <= 0.05:
        fail("bf16 kernel path drifts from the plain path")
    out32, _ = run_sampler(entry, params32, x_init, N_STEPS,
                           dtype=torch.float32)
    with mock.patch.object(dit, "fused_dit_block",
                           kernels.fused_dit_block_ref):
        ref32, _ = run_sampler(entry, params32, x_init, N_STEPS,
                               dtype=torch.float32)
    err32 = float((out32 - ref32).abs().max())
    log(f"  float32 kernel path vs float32 plain path, {N_STEPS} steps: "
        f"max |diff| {err32:.3e} (tol 1e-3: summation order only)")
    if not err32 <= 1e-3:
        fail("float32 kernel path disagrees with the plain path")

    # 5. device busy share over a short window of the DiT path
    profile_steps(f"DiT path, 5 steps, batch {BATCH}",
                  lambda: entry.sample(params, x_init, n_steps=5), 5)

    # 6. second path: fused_block=False through short_seq_attention
    reset_launches(kernels, attention)
    out2, sec2 = run_sampler(entry, params, x_init, N_STEPS_SECOND,
                             fused_block=False)
    want2 = 4 * entry.N_EXPERTS * N_STEPS_SECOND
    launches["short_seq_attention"] = kernels.short_seq_attention.launches
    log(f"second path ({N_STEPS_SECOND} steps): {BATCH / sec2:.1f} images/s, "
        f"{sec2 / N_STEPS_SECOND * 1e3:.3f} ms/step; "
        f"short_seq_attention launches "
        f"{kernels.short_seq_attention.launches}, fused_dit_block "
        f"{kernels.fused_dit_block.launches}")
    if kernels.short_seq_attention.launches != want2:
        fail(f"short_seq_attention launched "
             f"{kernels.short_seq_attention.launches} times, expected "
             f"{want2}")
    if not bool(torch.isfinite(out2).all()):
        fail("second path output is not finite")
    out_f, _ = run_sampler(entry, params, x_init, N_STEPS_SECOND)
    d2 = (out2 - out_f).abs()
    log(f"  unfused vs fused bf16 after {N_STEPS_SECOND} steps: mean "
        f"|diff| {float(d2.mean()):.4e}, max {float(d2.max()):.4e}")
    # the two block paths round at different sites (bf16 GEMM outputs
    # before the bias vs after it); same mean bar as above
    if not float(d2.mean()) <= 0.05:
        fail("fused_block=False path drifts from the fused path")

    del params32, out32, ref32, out_plain

    # 7, 8. the UNet paths
    unet_launches = unet_paths(card, convert, entry, unet, kernels, attention)
    launches["groupnorm_silu"] = unet_launches["A"]["groupnorm_silu"]
    launches["groupnorm_silu_split"] = \
        unet_launches["A"]["groupnorm_silu_split"]
    launches["flash_attention"] = unet_launches["B"]["flash_attention"]

    # 9. the latent path
    latent_launches = latent_path(card, convert, entry, pca_codec, kernels,
                                  attention)
    launches["blend_eps"] = latent_launches["blend_eps"]
    launches["matmul"] = latent_launches["matmul"]

    # 10. the training path, served through fused_dit_block
    training_path(card, entry, kernels, attention)

    # 11-14. the discrete-DDPM paths and the gray + color DDIM; 15. the
    # DDIM family
    by_path = {"A": unet_launches["A"], "B": unet_launches["B"]}
    by_path.update(ddpm_paths(card, convert, entry, unet, kernels, attention,
                              compose))
    by_path.update(ddim_family(card, convert, entry, unet, kernels,
                               attention, compose, samplers))

    # 16. the shapes gate; 17. NLL and the last samplers on its expert
    gate_run = shapes_gate_path(card, entry, dit, kernels, attention)
    nll_and_samplers(card, entry, samplers, kernels, attention,
                     gate_run["trees"]["unet64"][0], gate_run["probe"])
    by_path["shapes_gate"] = gate_run["launches"]["unet64"]

    # 18-20. the config-driven paths: presets through train_image,
    # sample_image, compose_scores and SUPERDIFF; the beta-VAE
    shutil.rmtree(SMOKE_OUT, ignore_errors=True)
    took = {}
    t0 = time.perf_counter()
    by_path.update(trained_superdiff(card, entry, unet, kernels, attention,
                                     compose))
    took[18] = time.perf_counter() - t0
    t0 = time.perf_counter()
    preset_launches = preset_paths(card, entry, unet, kernels, attention)
    by_path.update(preset_launches)
    took[19] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vae_launches = vae_paths(card, entry, kernels, attention)
    took[20] = time.perf_counter() - t0

    # 21-23. the trained latent and 2-D experts; the composition scores:
    # eval_composition, eval_superdiff, compose_images_ito, summarize_evals
    t0 = time.perf_counter()
    latent_launches = latent_trained(card, entry, kernels, attention,
                                     samplers)
    took[21] = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp = composition_eval(card, kernels, attention, unet)
    by_path.update(comp["launches"])
    took[22] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_path.update(superdiff_eval_and_ito(card, entry, kernels, attention,
                                          unet, compose, comp["experts"]))
    took[23] = time.perf_counter() - t0
    shutil.rmtree(SMOKE_OUT, ignore_errors=True)
    log("phases 18-23 took " + ", ".join(f"{k}: {v:.1f} s"
                                         for k, v in took.items()))

    # 21. the kernels line, then the result line. launches: each kernel's
    # count on the path that serves it (fused_dit_block: the DiT path;
    # short_seq_attention: fused_block=False; groupnorm_silu and its two-part
    # form groupnorm_silu_split (the same source; the JAX function it
    # carries is left to the compiler there): path A; flash_attention: path
    # B; blend_eps and matmul: the latent path under ddim); times at that
    # path's shape and dtype. The two GroupNorm rows also carry their
    # launches on every UNet path (phases 7, 8, 11-16) and their numbers at
    # the DDPM paths' shapes; fused_dit_block's row its launches on the DiT
    # path and on the shapes gate's DiT cells, and its numbers there;
    # blend_eps's row its launches on the paths of phases 9, 19 and 20, its
    # numbers at the shapes of 19 and 20 and an empty launch's device time
    src = "composable_diffusion_models_tpu_torch/csrc/"
    tpu = "composable_diffusion_models_tpu/ops/"
    line = {"kernels": [
        dict(name=name, route="cuda", source=src + source + ".cu",
             replaces=tpu + where, launches=launches[name],
             **rows[(name, dtype)])
        for name, source, where, dtype in (
            ("fused_dit_block", "fused_dit_block", "pallas_kernels.py:467",
             torch.bfloat16),
            ("short_seq_attention", "short_seq_attention",
             "pallas_kernels.py:319", torch.bfloat16),
            ("groupnorm_silu", "groupnorm_silu", "pallas_kernels.py:85",
             torch.bfloat16),
            ("groupnorm_silu_split", "groupnorm_silu",
             "pallas_kernels.py:122", torch.bfloat16),
            ("flash_attention", "flash_attention", "attention.py:54",
             torch.float32),
            ("blend_eps", "blend_eps", "pallas_kernels.py:197",
             torch.float32),
            ("matmul", "matmul", "pallas_kernels.py:229", torch.float32))]}
    for row in line["kernels"]:
        if row["name"] == "fused_dit_block":
            row["launches_by_path"] = {
                "dit": launches["fused_dit_block"],
                "shapes_gate": gate_run["launches"]["dit_p8_d256_l8"][
                    "fused_dit_block"]}
            row["shapes_gate_shape"] = k1_gate
        if row["name"] == "blend_eps":
            row["launches_by_path"] = {
                "latent_ddim": launches["blend_eps"],
                "compose_scores": preset_launches["compose_scores"][
                    "blend_eps"],
                "compose_latent_vae_weighted": vae_launches[
                    "compose_latent_vae_weighted"]["blend_eps"],
                "compose_latent_vae_cfg": vae_launches[
                    "compose_latent_vae_cfg"]["blend_eps"],
                "latent_trained_ddim": latent_launches[
                    "latent_trained_ddim"]["blend_eps"],
                "latent_trained_em": latent_launches[
                    "latent_trained_em"]["blend_eps"],
                **{p: by_path[p]["blend_eps"] for p in by_path
                   if p.startswith("eval_composition")}}
        if row["name"] == "matmul":
            row["launches_by_path"] = {
                "latent_ddim": launches["matmul"],
                **{p: c["matmul"] for p, c in latent_launches.items()}}
        if row["name"] in ("groupnorm_silu", "groupnorm_silu_split"):
            row["launches_by_path"] = {p: c[row["name"]]
                                       for p, c in by_path.items()}
            row["ddpm_path_shapes"] = [
                {k: v for k, v in r.items() if k != "name"}
                for r in ddpm_gn_rows if r["name"] == row["name"]]
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
