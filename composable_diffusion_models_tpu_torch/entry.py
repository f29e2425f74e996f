"""The serving paths end to end, each a deterministic DDIM loop on
``VPSchedule()`` in float32 around its experts.

* :func:`sample`: 3 composed experts on MNIST. Counterpart of the JAX
  package's bench program (``bench.py`` ``measure_dit_throughput``) and of
  ``__graft_entry__``: three ``dit_p14_d256_l4`` experts (patch 14, so 4
  tokens per 28 x 28 image; dim 256; 8 heads; depth 4) served in bf16
  through the folded DiT, blended by ``compose.weighted`` with unit weights.
* :func:`sample_shapes`: 2 composed class-conditional ``unet64`` experts on
  64 x 64 RGB shapes. Counterpart of ``bench.py``
  ``measure_shapes_throughput`` (the ``scripts/compose_images_ddim.py``
  workload): per-expert labels, bf16 experts, ``compose.weighted``.
* :func:`sample_cfg`: classifier-free-guidance composition with ONE
  dual-conditioned cross-attention ``unet64`` on 28 x 28 RGB. Counterpart
  of ``scripts/compose_cfg.py`` on the ``ito_cross_attention`` preset: the
  null slot and the two conditions folded into the batch axis, blended by
  ``compose.cfg``.
* :func:`sample_latent`: 2-D PCA-latent ``ScoreMLP`` experts composed in the
  latent and decoded to images. Counterpart of
  ``scripts/latent_shape_experts.py`` (operators ``ddim``, ``avg``, ``ito``
  on the ``shapes_latent`` preset) and ``scripts/sample_latent.py``
  (Euler-Maruyama on the ``mnist_latent2d`` preset). float32 throughout, as
  the presets compute; the K-expert blend of ``ddim`` and ``em`` runs
  through the ``blend_eps`` kernel and the PCA decode through ``matmul``.

The discrete-DDPM composition paths, on ``DDPMSchedule`` with linear
betas, float32 as their presets compute, every GroupNorm of their UNets
through the ``groupnorm_silu`` kernel:

* :func:`sample_superdiff`: K ``GUIDED_UNET`` experts (the
  ``colored_mnist_guided`` preset's model: digit and color label slots with
  the null token) composed by SUPERDIFF with the Ito density estimator (OR,
  AND heuristic, FIXED, AVG) or the rigorous AND / OR of the K x K linear
  system, 1000 timesteps. Counterpart of ``scripts/superdiff.py``.
* :func:`sample_layout`: a background expert everywhere and a foreground
  expert in a centred circle (``layout``). Counterpart of
  ``scripts/layout_compose.py``.
* :func:`sample_ancestral`: three class-conditional ``unet64`` experts
  (shape, color, bbox) blended by ``compose.weighted`` under ancestral DDPM
  at 500 timesteps. Counterpart of ``scripts/compose_bbox.py``'s sampler.

And one more DDIM path:

* :func:`sample_gray_color`: a 1-channel shape ``unet64`` that sees the gray
  projection of the RGB state beside a 3-channel color ``unet64``, blended
  by ``compose.weighted`` over the lifted gray prediction or by
  ``compose.projected``, 200 DDIM steps in float32. Counterpart of
  ``scripts/compose_images_ddim.py`` on the ``shapes_ddim`` preset.

And the training path, the protocol of ``scripts/quality_gate_flagship.py``:

* :func:`train_experts`: three ``dit_p14_d256_l4`` experts trained on the
  digit subsets {0-2}, {3-5}, {6-8} of procedural MNIST made on the card,
  through the differentiable ``DiT.apply`` in bf16 compute with float32
  parameters, Adam and an EMA; returns the EMA trees, which :func:`sample`
  serves as they are.
* :func:`quality_gate`: the whole gate: a 10-class digit probe, the
  experts, each sampled solo and the three composed through :func:`sample`
  (the folded DiT on the ``fused_dit_block`` kernel), the probe's
  statistics, and the judge against a baseline report (``gate.py``).

The shapes gate, the protocol of ``scripts/quality_gate_shapes.py``, and
the NLL evaluator of ``scripts/eval_nll.py``:

* :func:`train_shapes_experts`: a shape- and a color-conditional expert of
  one gate configuration (``unet64``: bf16 compute, GroupNorm in PyTorch
  ops; ``dit_p8_d256_l8``: float32 compute) trained on procedural 64 x 64
  shapes made on the card.
* :func:`quality_gate_shapes`: a two-factor probe, the experts of each
  configuration served in bf16 through the bench program (the ``unet64``
  cells through :func:`sample_shapes` on the ``groupnorm_silu`` kernel, the
  DiT cells through :func:`sample`'s folded stack on ``fused_dit_block``),
  the 9 (shape, color) cells scored, and the judge against the ``unet64``
  baseline.
* :func:`eval_nll`: per-example log-likelihood and bits/dim of a trained
  expert by the probability-flow ODE (``samplers.log_likelihood``), its
  jvps through the PyTorch-op GroupNorm.

The config-driven paths, each reading a preset of ``utils.config`` with
dotted overrides and building through ``builders`` as the JAX package's
scripts do, checkpoints by name under ``CheckpointManager(out, cfg.name)``:

* :func:`train_image`: one image expert of any preset
  (``scripts/train_image.py``), e.g. the ``colored_mnist_guided`` experts
  that :func:`sample_superdiff` serves once :func:`load_named` has read
  them back (``scripts/superdiff.py``).
* :func:`sample_image`: one trained expert under E-M, the probability-flow
  ODE, Picard sweeps, DPM-Solver++(2M) or DDIM
  (``scripts/sample_image.py``); the UNet's GroupNorm through K4.
* :func:`compose_scores`: K trained experts blended by weights, the blend
  through the ``blend_eps`` kernel (``scripts/compose_scores.py``).
* :func:`train_vae` and :func:`compose_latent_vae`: the beta-VAE codec and
  its digit-conditional latent expert, composed in the 10-D latent by CFG
  or by a ``blend_eps`` blend under ancestral DDPM and decoded
  (``scripts/train_vae.py``, ``scripts/compose_latent_vae.py``).

The latent and 2-D experts and the Ito-kappa image composition:

* :func:`fit_pca` and :func:`train_latent_2d`: the PCA codec's files and a
  2-D latent ``ScoreMLP`` expert trained on its encodings (one ``matmul``
  launch), which :func:`sample_latent` serves (``scripts/fit_pca.py``,
  ``scripts/train_latent_2d.py``).
* :func:`superposition_2d`: two 2-D toy experts trained and composed with
  their log-likelihoods (``scripts/superposition_2d.py``).
* :func:`compose_images_ito`: a gray shape and a color expert read by name,
  composed by the Ito-kappa ODE over the 3 x 3 labels
  (``scripts/compose_images_ito.py``).

The evaluation protocols live in ``eval_composition`` and
``eval_superdiff``, the results table in ``utils.summarize``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import compose, data, gate, resolve_device, samplers, train
from . import eval as ceval
from .builders import build_dataset, build_model, build_schedule, init_params
from .checkpoint import CheckpointManager
from .compose import weighted
from .convert import flax_init, param_shapes, unet_torch_layout
from .experts import ExpertStack, gray_to_rgb, per_expert, rgb_to_gray
from .models.dit import DiT, make_folded_apply
from .models.mlp import LatentDiffusionMLP, ScoreMLP
from .models.unet import UNet
from .models.vae import BetaVAE, vae_loss
from .ops import pca as pca_codec
from .ops.kernels import blend_eps
from .rng import Draws, as_draws, fold_in
from .utils import viz
from .utils.config import get_config, save_yaml
from .utils.profiling import annotate
from .samplers import ddim, make_cfg_eps_fn
from .schedules import DDPMSchedule, VPSchedule

FLAGSHIP = DiT(patch=14, dim=256, depth=4, n_heads=8, in_channels=1,
               qkv_fused=True, img_size=28)
N_EXPERTS = 3
# the gate trains the flagship as its script builds it: flax's stock
# multi-head attention layout (which the folded path serves as well), bf16
# compute over float32 parameters
GATE_DIT = dataclasses.replace(FLAGSHIP, qkv_fused=False,
                               dtype=torch.bfloat16)
# the unet64 family: base 64, widths (64, 128, 256), GroupNorm(8)
SHAPES_UNET = UNet(in_channels=3, base_dim=64, channel_mults=(1, 2, 4),
                   num_classes=(3,))
N_SHAPES_EXPERTS = 2
CFG_UNET = UNet(in_channels=3, base_dim=64, channel_mults=(1, 2, 4),
                num_classes=(10, 3), null_token=True, cross_attn=True,
                flash_attn=True)
# the colored_mnist_guided preset's model: digit and color label slots, each
# with the null token, added into the time embedding (no cross-attention)
GUIDED_UNET = UNet(in_channels=3, base_dim=64, channel_mults=(1, 2, 4),
                   num_classes=(10, 10), null_token=True)
N_GUIDED_EXPERTS = 2
# scripts/compose_images_ddim.py's shape expert: the unet64 on one gray
# channel (its color expert is SHAPES_UNET)
GRAY_UNET = dataclasses.replace(SHAPES_UNET, in_channels=1)
GRAY_PROTOCOLS = ("white", "luma", "luma_norm")
# the 2-D latent score network of the shapes_latent and mnist_latent2d
# presets
SHAPES_LATENT_MLP = ScoreMLP(hidden=256, depth=3, out_dim=2)
LATENT_OPS = ("ddim", "em", "avg", "ito")


def dit_gflop_per_image(model: DiT) -> float:
    """Analytic GFLOP of one DiT forward per image (MACs x 2), counted
    from the configuration with N = ``n_tokens`` tokens of width D: per
    block the q, k, v and out projections 4ND^2, the two attention products
    2N^2D, the MLP 8ND^2 (width 4D) and the adaLN modulation 6D^2; the
    patchify and unpatchify GEMMs 2ND P^2 C. The time and label towers, the
    final modulation and the elementwise work are left out."""
    n_tok, dim = model.n_tokens, model.dim
    per_block = (12 * n_tok * dim * dim + 2 * n_tok * n_tok * dim
                 + 6 * dim * dim)
    patchify = 2 * n_tok * dim * model.patch ** 2 * model.in_channels
    return 2.0 * (model.depth * per_block + patchify) / 1e9


def gflop_per_image(n_steps: int = 50) -> float:
    """Analytic GFLOP per sampled image of the flagship composer: three
    :func:`dit_gflop_per_image` forwards a step; 4.377 at 50 steps."""
    return dit_gflop_per_image(FLAGSHIP) * N_EXPERTS * n_steps


def unet_gflop_per_image(model: UNet, h: int, w: int) -> float:
    """Analytic GFLOP of one UNet forward per image (MACs x 2), counted
    from the configuration: every convolution at its level's resolution,
    the output head, the residual blocks' time projections, the bilinear
    upsample matmuls, and per attention site the q and out projections,
    the context's k and v projections and the two attention products. The
    batch-1 time tower and the elementwise work are left out."""
    n_levels = len(model.channel_mults) - 1
    n_ctx = len(model.num_classes)

    def level(name: str) -> int:
        tail = name.rsplit("_", 1)[-1]
        return int(tail) if tail.isdigit() else (
            n_levels if name.startswith("bo") else 0)

    macs = 0
    for path, (shape, _) in param_shapes(model).items():
        if path[-1] != "kernel":
            continue
        pixels = (h >> level(path[0])) * (w >> level(path[0]))
        fan = 1
        for dim in shape:
            fan *= dim
        if len(shape) == 4:                       # a convolution
            macs += fan * pixels
        elif "attn" in path[0]:
            # Dense_0 (q) and Dense_3 (out) per pixel, Dense_1/2 per
            # context token, and once per site scores + values
            per_pixel = path[1] in ("Dense_0", "Dense_3")
            macs += fan * (pixels if per_pixel else n_ctx)
            if path[1] == "Dense_0":
                macs += 2 * pixels * n_ctx * shape[1]
        elif path[0] != "TimeEmbedding_0":        # a block's time projection
            macs += fan
    for i in range(n_levels):                     # upsample into level i
        hh, ww = h >> (i + 1), w >> (i + 1)
        c = model.base_dim * model.channel_mults[i + 1]
        macs += 2 * hh * hh * ww * c + 2 * ww * ww * c * 2 * hh
    return 2.0 * macs / 1e9


def _cast(tree: Any, device: torch.device, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def load_experts(trees: Sequence[Any], device=None,
                 dtype: torch.dtype = torch.bfloat16) -> list:
    """The experts' parameter trees (``convert.from_flax``) in ``dtype`` on
    the device (``None``: the CUDA card). A server does this once; the
    trees it returns pass through :func:`sample` without a copy."""
    dev = resolve_device(device)
    return [_cast(t, dev, dtype) for t in trees]


def load_unets(trees: Sequence[Any], device=None,
               dtype: torch.dtype = torch.bfloat16) -> list:
    """:func:`load_experts` for UNet trees: also puts the convolution
    kernels into ``F.conv2d``'s layout (``convert.unet_torch_layout``).
    The trees it returns pass through :func:`sample_shapes` and
    :func:`sample_cfg` without a copy."""
    return [unet_torch_layout(t) for t in load_experts(trees, device, dtype)]


@torch.inference_mode()
def sample(params_list: Sequence[Any], x_init, n_steps: int = 50,
           fused_block: bool = True, device=None,
           dtype: torch.dtype = torch.bfloat16, labels: Sequence = (),
           model: DiT = FLAGSHIP) -> torch.Tensor:
    """Samples from the composed folded-DiT experts: an fp32 batch shaped
    as ``x_init`` (the flagship's: (B, 28, 28, 1)).

    ``params_list``: the experts' parameter trees as torch tensors
    (``convert.from_flax``), cast here to ``dtype`` on the device unless
    :func:`load_experts` already put them there.
    ``x_init``: the initial noise. ``device=None`` is the CUDA
    card (raises without one). ``dtype`` is the experts' compute type:
    bf16 serves; fp32 holds the port to the JAX reference in tests.
    ``model``: the experts' architecture (``FLAGSHIP``; the shapes gate's
    ``dit_p8_d256_l8`` takes class labels). ``labels``: for a model with
    label slots, one (K, 1) batch-constant label tensor per slot, row i
    for expert i (the folded DiT folds them into its per-step weights)."""
    with annotate("cdm.sample"):
        dev = resolve_device(device)
        model = dataclasses.replace(model, dtype=dtype)
        stack = ExpertStack(make_folded_apply(model, fused_block),
                            load_experts(params_list, dev, dtype))
        w = torch.ones((stack.k,), dtype=torch.float32, device=dev)
        labs = [per_expert(torch.as_tensor(lab).to(dev)) for lab in labels]

        def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            # bf16 experts inside the fp32 sampler, blended in fp32
            return weighted(stack(x.to(dtype), t.to(dtype), *labs).float(),
                            w)

        x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
        return ddim(eps_fn, VPSchedule(), x, n_steps)


@torch.inference_mode()
def sample_shapes(params_list: Sequence[Any], x_init, labels,
                  n_steps: int = 50, fused_gn: bool = True, device=None,
                  dtype: torch.dtype = torch.bfloat16,
                  model: UNet = SHAPES_UNET) -> torch.Tensor:
    """Samples from the composed class-conditional ``unet64`` experts: an
    fp32 (B, H, W, 3) batch (64 x 64 in the served workload; H and W
    multiples of 4).

    ``params_list``: one UNet parameter tree per expert
    (``convert.from_flax``, or already through :func:`load_unets`).
    ``labels``: (K, B) integer class labels, row i for expert i.
    ``fused_gn=True`` runs GroupNorm + SiLU through the ``groupnorm_silu``
    kernel; ``False`` through the PyTorch-op composition. ``device=None``
    is the CUDA card (raises without one). ``model`` is the experts'
    architecture; narrower ones exist for CPU tests only."""
    dev = resolve_device(device)
    model = dataclasses.replace(model, dtype=dtype, fused_gn=fused_gn)
    stack = ExpertStack(model.apply, load_unets(params_list, dev, dtype))
    w = torch.ones((stack.k,), dtype=torch.float32, device=dev)
    labs = per_expert(torch.as_tensor(labels).to(dev))

    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # bf16 experts inside the fp32 sampler, blended in fp32
        return weighted(stack(x.to(dtype), t.to(dtype), labs).float(), w)

    x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
    return ddim(eps_fn, VPSchedule(), x, n_steps)


@torch.inference_mode()
def sample_cfg(params: Any, x_init, digit: int, color: int,
               guidance: Sequence[float] = (2.0, 2.0), n_steps: int = 50,
               flash_attn: bool = True, fused_gn: bool = True, device=None,
               dtype: torch.dtype = torch.float32,
               model: UNet = CFG_UNET) -> torch.Tensor:
    """Samples (digit, color) by classifier-free guidance from one
    dual-conditioned cross-attention ``unet64``: an fp32 (B, 28, 28, 3)
    batch. The two single-condition slots (digit with the null color, the
    null digit with color) and the uncond slot run as one forward of 3B
    rows; ``guidance`` weighs the two conditions.

    ``params``: the UNet parameter tree (``convert.from_flax``, or already
    through :func:`load_unets`). ``flash_attn=True`` routes the
    cross-attention through the ``flash_attention`` kernel, ``False``
    through the einsum pair. ``dtype`` is the model's compute type; the
    preset computes in float32. ``device=None`` is the CUDA card.
    ``model`` is the architecture; narrower ones exist for CPU tests only."""
    dev = resolve_device(device)
    model = dataclasses.replace(model, dtype=dtype, flash_attn=flash_attn,
                                fused_gn=fused_gn)
    tree, = load_unets([params], dev, dtype)
    n1, n2 = model.num_classes  # the null token is the vocabulary size
    eps_fn = make_cfg_eps_fn(
        lambda x, t, *labs: model.apply(tree, x, t, *labs),
        [(digit, n2), (n1, color)], (n1, n2),
        torch.tensor(list(guidance), dtype=torch.float32, device=dev))
    x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
    return ddim(eps_fn, VPSchedule(), x, n_steps)


def load_latent_experts(trees: Sequence[Any], device=None) -> list:
    """:func:`load_experts` in float32, the latent presets' compute type.
    The trees it returns pass through :func:`sample_latent` without a
    copy."""
    return load_experts(trees, device, torch.float32)


def load_pca(pca: Union[pca_codec.PCA, str], device=None) -> pca_codec.PCA:
    """The PCA codec on the device (``None``: the CUDA card), from a
    :class:`ops.pca.PCA` (``ops.pca.fit_pca``, ``convert.pca_from_numpy``)
    or from the path prefix of its ``.npy`` files. Done once: it also lays
    out the transposed components that ``encode`` multiplies by."""
    dev = resolve_device(device)
    if isinstance(pca, str):
        return pca_codec.load_pca(pca, dev)
    return pca.to(dev)


@torch.no_grad()  # not inference_mode: the ito operator runs forward-mode AD
def sample_latent(params_list: Sequence[Any], pca: pca_codec.PCA, z_init,
                  op: str = "ddim", n_steps: int = 1000,
                  weights: Optional[Sequence[float]] = None, xi: float = 1.0,
                  fused_blend: bool = True, seed: int = 0,
                  noise: Optional[torch.Tensor] = None,
                  probes: Optional[torch.Tensor] = None, device=None,
                  model: ScoreMLP = SHAPES_LATENT_MLP,
                  schedule: VPSchedule = VPSchedule()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Composes latent ``ScoreMLP`` experts under one of four operators and
    decodes through the PCA: returns ``(z, images)``, the (B, k) latents and
    the (B, size, size, 1) images clipped to [-1, 1], both float32.

    ``op``:
      * ``"ddim"``: weighted eps blend of K experts under DDIM without the
        x0 clamp;
      * ``"em"``: the same blend under Euler-Maruyama with churn ``xi``;
      * ``"avg"``: two experts, fixed kappa 0.5 (the plain score average)
        under the probability-flow ODE;
      * ``"ito"``: two experts, the equal-density kappa from Hutchinson
        divergences (``samplers.ito_kappa_ode`` on s = -eps_hat).

    ``params_list``: the experts' trees (``convert.from_flax``, or already
    through :func:`load_latent_experts`); ``pca``: the codec
    (:func:`load_pca`); ``z_init``: (B, k) initial noise; ``weights``: (K,)
    blend weights, ones by default. ``fused_blend=True`` blends through the
    ``blend_eps`` kernel, ``False`` through ``compose.weighted``. ``em``
    draws its noise and ``ito`` its Rademacher probes from a generator
    seeded with ``seed`` on the device, unless ``noise=`` (n_steps, B, k) or
    ``probes=`` (n_steps, 2, B, k) replace them. The images are square
    with one channel: the edge is the square root of the codec's width.
    ``device=None`` is the CUDA card (raises without one). ``model``: the
    experts' configuration (only its depth shapes the forward);
    ``schedule``: the VP schedule of both the experts' training and this
    sampling (the presets' ``stable`` kind by default)."""
    if op not in LATENT_OPS:
        raise ValueError(f"op must be one of {LATENT_OPS}, got {op!r}")
    dev = resolve_device(device)
    params = load_latent_experts(params_list, dev)
    if op in ("avg", "ito") and len(params) != 2:
        raise ValueError(f"op {op!r} composes exactly 2 experts, got "
                         f"{len(params)}")
    pca = pca.to(dev)
    z = torch.as_tensor(z_init, dtype=torch.float32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    if op in ("ddim", "em"):
        stack = ExpertStack(lambda p, x, t: model.apply(p, t, x), params)
        w = compose.constant([1.0] * stack.k if weights is None else weights,
                             torch.float32, dev)
        blend = blend_eps if fused_blend else weighted

        def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            return blend(stack(x, t), w)

        if op == "ddim":
            z = ddim(eps_fn, schedule, z, n_steps, clip=None)
        else:
            if noise is not None:
                noise = noise.to(dev)
            z = samplers.euler_maruyama(eps_fn, schedule, gen, z, n_steps,
                                        xi, noise=noise)
    else:
        # sigma-scaled scores s = -eps_hat, the samplers' net convention
        score_fns = tuple(
            (lambda x, t, p=p: -model.apply(p, t, x)) for p in params)
        if op == "avg":
            z = samplers.prob_flow_ode(
                lambda x, t: 0.5 * (score_fns[0](x, t) + score_fns[1](x, t))
                / schedule.sigma(t), schedule, z, n_steps)
        else:
            if probes is not None:
                probes = probes.to(dev)
            z = samplers.ito_kappa_ode(score_fns, schedule, gen, z, n_steps,
                                       probes=probes)
    size = math.isqrt(pca.mean.shape[0])
    images = pca.decode(z, (size, size, 1)).clamp(-1.0, 1.0)
    return z, images


def _ddpm_stack_fn(stack: ExpertStack, num_timesteps: int, labels,
                   dev: torch.device, dtype: torch.dtype):
    """eps_stack_fn(x, ti) of a DDPM sampler over ``stack``: the experts
    take the integer timestep as a float, as the scripts' ``ti.astype(
    float32)`` gives it (the column is built on the device once), compute
    in ``dtype`` and hand the sampler float32."""
    t_col = torch.arange(num_timesteps, dtype=torch.float32, device=dev)

    def eps_stack_fn(x: torch.Tensor, ti: int) -> torch.Tensor:
        return stack(x.to(dtype), t_col[ti].to(dtype), *labels).float()

    return eps_stack_fn


def _slot_labels(labels, k: int, b: int, n_slots: int,
                 dev: torch.device) -> list:
    """(K, n_slots) per-expert labels (None: 0 in every slot, as the
    scripts default) -> one per-expert (K, B) label per slot."""
    if labels is None:
        lab = torch.zeros((k, n_slots), dtype=torch.long, device=dev)
    else:
        lab = torch.as_tensor(labels).to(dev)
    if tuple(lab.shape) != (k, n_slots):
        raise ValueError(f"labels must be ({k}, {n_slots}): one label per "
                         f"expert per slot, got {tuple(lab.shape)}")
    return [per_expert(lab[:, s:s + 1].expand(k, b)) for s in range(n_slots)]


def _ddpm_setup(params_list, x_init, model: UNet, fused_gn: bool,
                device, dtype: torch.dtype, seed: int, noise):
    """The device, the expert stack, x on the device in float32, the
    generator seeded with ``seed`` and the replayed ``noise`` there."""
    dev = resolve_device(device)
    model = dataclasses.replace(model, dtype=dtype, fused_gn=fused_gn)
    stack = ExpertStack(model.apply, load_unets(params_list, dev, dtype))
    x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return dev, model, stack, x, gen, None if noise is None else noise.to(dev)


@torch.inference_mode()
def sample_superdiff(params_list: Sequence[Any], x_init, labels=None,
                     operation: str = "OR", rigorous_and: bool = False,
                     temp: float = 1.0, bias=0.0,
                     kappa: Optional[Sequence[float]] = None,
                     num_timesteps: int = 1000, fused_gn: bool = True,
                     seed: int = 0, noise: Optional[torch.Tensor] = None,
                     device=None, dtype: torch.dtype = torch.float32,
                     model: UNet = GUIDED_UNET) -> torch.Tensor:
    """SUPERDIFF over K ``GUIDED_UNET`` experts: an fp32 (B, H, W, 3)
    batch (28 x 28 in the served workload), as ``scripts/superdiff.py``
    computes it on ``DDPMSchedule(num_timesteps)``.

    ``labels``: (K, n_slots) per-expert labels, one per slot (the null token
    is the slot's class count); None: 0 everywhere. ``operation``: OR, AND
    (the heuristic), FIXED (``kappa``: K weights) or AVG, under
    ``samplers.superdiff``; ``rigorous_and=True``: OR or AND under
    ``samplers.superdiff_and_solve``. ``temp`` and ``bias`` as there.
    ``params_list``: one UNet tree per expert (``convert.from_flax``, or
    already through :func:`load_unets`). The draws come from a generator
    seeded with ``seed`` on the device, unless ``noise=`` replays them
    ((T, B, H, W, 3); (T, 2, B, H, W, 3) for the rigorous AND).
    ``fused_gn=True`` runs every GroupNorm + SiLU through the
    ``groupnorm_silu`` kernel. ``dtype``: the experts' compute type (the
    preset's is float32). ``device=None`` is the CUDA card (raises without
    one). ``model``: narrower ones exist for CPU tests only."""
    op = operation.upper()
    if rigorous_and and op not in ("OR", "AND"):
        raise ValueError("rigorous_and supports operation 'OR' or 'AND' "
                         f"only, got {operation!r}")
    dev, model, stack, x, gen, noise = _ddpm_setup(
        params_list, x_init, model, fused_gn, device, dtype, seed, noise)
    labs = _slot_labels(labels, stack.k, x.shape[0], len(model.num_classes),
                        dev)
    eps_stack_fn = _ddpm_stack_fn(stack, num_timesteps, labs, dev, dtype)
    sde = DDPMSchedule(num_timesteps=num_timesteps)
    if rigorous_and:
        return samplers.superdiff_and_solve(
            eps_stack_fn, sde, gen, x, mode=op, temp=temp, bias=bias,
            k_experts=stack.k, noise=noise)
    return samplers.superdiff(eps_stack_fn, sde, gen, x, operation=op,
                              temp=temp, bias=bias, kappa_fixed=kappa,
                              noise=noise)


def circular_mask(h: int, w: int, center=None, radius=None) -> np.ndarray:
    """(h, w) float32 mask, 1 within ``radius`` of ``center`` (default: the
    centre, and the largest radius that stays inside): the port's copy of
    ``scripts/layout_compose.py``'s helper."""
    if center is None:
        center = (w // 2, h // 2)
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1])
    yy, xx = np.ogrid[:h, :w]
    dist = np.sqrt((xx - center[0]) ** 2 + (yy - center[1]) ** 2)
    return (dist <= radius).astype(np.float32)


@torch.inference_mode()
def sample_layout(params_list: Sequence[Any], x_init,
                  radius: Optional[int] = None, num_timesteps: int = 1000,
                  fused_gn: bool = True, seed: int = 0,
                  noise: Optional[torch.Tensor] = None, device=None,
                  dtype: torch.dtype = torch.float32,
                  model: UNet = GUIDED_UNET) -> torch.Tensor:
    """Layout composition of two ``GUIDED_UNET`` experts, as
    ``scripts/layout_compose.py`` computes it: the first (background)
    expert everywhere, the second in a centred circle of ``radius`` (the
    largest inside by default) on top, under ``samplers.layout`` on
    ``DDPMSchedule(num_timesteps)``, label 0 in every slot as the script
    conditions them. Returns an fp32 (B, H, W, 3) batch. ``seed`` /
    ``noise`` ((T, B, H, W, 3)), ``fused_gn``, ``dtype``, ``device`` and
    ``model`` as in :func:`sample_superdiff`."""
    dev, model, stack, x, gen, noise = _ddpm_setup(
        params_list, x_init, model, fused_gn, device, dtype, seed, noise)
    if stack.k != 2:
        raise ValueError(f"layout composes 2 experts, got {stack.k}")
    labs = _slot_labels(None, stack.k, x.shape[0], len(model.num_classes),
                        dev)
    h, w = x.shape[1:3]
    masks = np.stack([np.ones((h, w), np.float32),
                      circular_mask(h, w, radius=radius)])
    masks = compose.constant(masks.ravel().tolist(), torch.float32,
                             dev).reshape(2, h, w)
    return samplers.layout(
        _ddpm_stack_fn(stack, num_timesteps, labs, dev, dtype),
        DDPMSchedule(num_timesteps=num_timesteps), gen, x, masks,
        noise=noise)


@torch.inference_mode()
def sample_ancestral(params_list: Sequence[Any], x_init, labels,
                     weights: Sequence[float] = (1.0, 1.0, 1.0),
                     num_timesteps: int = 500, fused_gn: bool = True,
                     seed: int = 0, noise: Optional[torch.Tensor] = None,
                     device=None, dtype: torch.dtype = torch.float32,
                     model: UNet = SHAPES_UNET) -> torch.Tensor:
    """The bbox composition of ``scripts/compose_bbox.py``: three
    class-conditional ``unet64`` experts (shape, color, bbox) blended by
    ``compose.weighted`` with ``weights`` under ``samplers.ddpm_ancestral``
    on ``DDPMSchedule(num_timesteps)`` (the ``shapes_bbox`` preset's 500).
    Returns an fp32 (B, H, W, 3) batch (64 x 64 in the served workload).
    ``labels``: (K, B) integer labels, row i for expert i. ``seed`` /
    ``noise`` ((T, B, H, W, 3)), ``fused_gn``, ``dtype``, ``device`` and
    ``model`` as in :func:`sample_superdiff`."""
    dev, model, stack, x, gen, noise = _ddpm_setup(
        params_list, x_init, model, fused_gn, device, dtype, seed, noise)
    stack_fn = _ddpm_stack_fn(stack, num_timesteps,
                              [per_expert(torch.as_tensor(labels).to(dev))],
                              dev, dtype)
    w = compose.constant(weights, torch.float32, dev)
    return samplers.ddpm_ancestral(
        lambda x_, ti: weighted(stack_fn(x_, ti), w),
        DDPMSchedule(num_timesteps=num_timesteps), gen, x, noise=noise)


@torch.inference_mode()
def sample_gray_color(shape_params: Any, color_params: Any, x_init,
                      shape_labels, color_labels, op: str = "avg",
                      gray_protocol: str = "white", w_shape: float = 1.0,
                      w_color: float = 1.0, n_steps: int = 200,
                      fused_gn: bool = True, device=None,
                      dtype: torch.dtype = torch.float32,
                      shape_model: UNet = GRAY_UNET,
                      color_model: UNet = SHAPES_UNET,
                      schedule: VPSchedule = VPSchedule()) -> torch.Tensor:
    """The mixed-channel composition of ``scripts/compose_images_ddim.py``:
    a 1-channel shape expert that sees ``experts.rgb_to_gray(x)`` (unit-norm
    with ``gray_protocol="luma_norm"``) and a 3-channel color expert that
    sees x, under DDIM on ``VPSchedule()`` (the ``shapes_ddim`` preset's
    200 steps). ``op="avg"``: ``compose.weighted`` over the lifted gray
    prediction (``experts.gray_to_rgb``, the adjoint lift for
    ``luma_norm``) and the color one, weights (w_shape, w_color);
    ``op="proj"``: ``compose.projected`` with weight ``w_shape``, which
    needs ``gray_protocol="luma_norm"`` (the gray expert must estimate
    exactly P eps). Returns an fp32 (B, H, W, 3) batch.
    ``shape_labels``, ``color_labels``: (B,) class labels. ``fused_gn``,
    ``dtype`` (the preset's is float32), ``device`` as in
    :func:`sample_shapes`; the models are narrower for CPU tests only.
    ``schedule``: the preset's ``VPSchedule(kind=cfg.schedule.kind)``."""
    if op not in ("avg", "proj"):
        raise ValueError(f"op must be 'avg' or 'proj', got {op!r}")
    if gray_protocol not in GRAY_PROTOCOLS:
        raise ValueError(f"gray_protocol must be one of {GRAY_PROTOCOLS}, "
                         f"got {gray_protocol!r}")
    normalized = gray_protocol == "luma_norm"
    if op == "proj" and not normalized:
        raise ValueError("op='proj' needs gray_protocol='luma_norm' (the "
                         "gray expert must estimate exactly P eps)")
    dev = resolve_device(device)
    shape_model, color_model = (
        dataclasses.replace(m, dtype=dtype, fused_gn=fused_gn)
        for m in (shape_model, color_model))
    sp, cp = load_unets([shape_params, color_params], dev, dtype)
    sl, cl = (torch.as_tensor(lab).to(dev)
              for lab in (shape_labels, color_labels))
    w = compose.constant((w_shape, w_color), torch.float32, dev)

    def eps_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        e_gray = shape_model.apply(sp, rgb_to_gray(x, normalized).to(dtype),
                                   t.to(dtype), sl).float()
        e_color = color_model.apply(cp, x.to(dtype), t.to(dtype), cl).float()
        if op == "proj":
            return compose.projected(e_color, e_gray, w_shape)
        return weighted(torch.stack([gray_to_rgb(e_gray, normalized),
                                     e_color]), w)

    x = torch.as_tensor(x_init, dtype=torch.float32).to(dev)
    return ddim(eps_fn, schedule, x, n_steps)


def train_experts(steps: int = 12000, batch_size: int = 256, lr: float = 2e-4,
                  ema: float = 0.999, seed: int = 0, data_n: int = 8192,
                  device=None) -> Tuple[list, list]:
    """Trains the gate's three ``dit_p14_d256_l4`` experts on the digit
    subsets ``gate.SUBSETS`` of procedural MNIST (``data_n`` images each,
    made on the device), with the script's keys: data ``fold_in(seed,
    3 + i)``, init ``fold_in(seed, 10 + i)``, training ``fold_in(seed,
    20 + i)``. eps-prediction on ``VPSchedule()``, ``GATE_DIT.apply``
    (bf16 compute over float32 parameters), Adam at ``lr``, EMA ``ema`` (0:
    off). Returns (trees, losses): the EMA trees (float32, on the device;
    :func:`sample` serves them as they are) and each expert's (steps,)
    losses on the device. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    trees, losses = [], []
    for i, subset in enumerate(gate.SUBSETS):
        imgs, _ = data.get_mnist(fold_in(seed, 3 + i), n=data_n,
                                 classes=subset, device=dev)
        p0 = flax_init(GATE_DIT, fold_in(seed, 10 + i), dev)
        p, loss = train.train_expert(
            fold_in(seed, 20 + i), GATE_DIT.apply, p0, VPSchedule(), imgs,
            steps=steps, batch_size=batch_size, lr=lr,
            ema_decay=ema or None)
        trees.append(p)
        losses.append(loss)
    return trees, losses


def quality_gate(train_steps: int = 12000, batch_size: int = 256,
                 lr: float = 2e-4, ema: float = 0.999,
                 probe_steps: int = 2000, n_samples: int = 256,
                 n_steps: int = 50, data_n: int = 8192, seed: int = 0,
                 baseline=gate.BASELINE, tol: float = 0.02,
                 div_frac: float = 0.5, fid_slack: float = 1.5,
                 sanity: bool = False, out: Optional[str] = None,
                 experts: Optional[Sequence[Any]] = None,
                 device=None) -> dict:
    """The protocol of ``scripts/quality_gate_flagship.py`` for the
    ``dit_p14_d256_l4`` flagship, on the device (``None``: the CUDA card).

    1. A 10-class digit probe (bf16, noise-augmented at 0.1) trained
       ``probe_steps`` on ``data_n`` procedural digits (key fold_in(seed,
       1) for the data, fold_in(seed, 2) for the probe); its features of
       the first 2048 real images anchor the distributional statistics.
    2. The three experts (:func:`train_experts`; ``experts``: EMA trees it
       already returned for this seed, to skip the training).
    3. Each expert sampled solo and the three composed, ``n_samples`` each,
       ``n_steps`` of DDIM through :func:`sample` in bf16, scored by
       ``gate.probe_stats``.
    4. With a ``baseline`` report (a path; None: report only), the verdict
       of ``gate.judge``; a verdict decided within sampling noise of a
       threshold is scored again with 4x the samples and a second seed.

    ``sanity`` cuts every size as the script's ``--sanity`` does. Returns
    the report (the script's JSON) and, with ``out``, writes it there as
    ``quality_dit_p14_d256_l4[_s<train_steps>].json``, beside the script's
    grids of the first pass (``dit_p14_d256_l4_solo<i>.png``,
    ``dit_p14_d256_l4_composed.png``). :func:`quality_gate_flagship` gates
    any named configuration."""
    dev = resolve_device(device)
    if sanity:
        train_steps, probe_steps = 40, 40
        n_samples, n_steps, data_n = 16, 4, 256
        batch_size = 16
    full_imgs, full_labels = data.get_mnist(fold_in(seed, 1), n=data_n,
                                            device=dev)
    probe, probe_params = ceval.train_probe(
        fold_in(seed, 2), full_imgs, (full_labels,), num_classes=(10,),
        steps=probe_steps, noise_aug=0.1)
    heldin = ceval.probe_accuracy(probe, probe_params, full_imgs[:512],
                                  (full_labels[:512],))
    real_feats = ceval.probe_features(probe, probe_params, full_imgs[:2048])
    if experts is None:
        experts, _ = train_experts(train_steps, batch_size, lr, ema, seed,
                                   data_n, dev)
    params_list = load_experts(experts, dev, GATE_DIT.dtype)
    cfg = "dit_p14_d256_l4"

    def run(idx: Sequence[int], x: torch.Tensor) -> torch.Tensor:
        return sample([params_list[i] for i in idx], x, n_steps, device=dev)

    def score(n: int, seed_salt: int, save_png: bool = True) -> dict:
        return _gate_score(run, n, seed, seed_salt, probe, probe_params,
                           real_feats, dev, cfg, out if save_png else None)

    report = {"config": cfg, "train_steps": train_steps,
              "batch_size": batch_size, "ema": ema, "n_steps": n_steps,
              "n_samples": n_samples,
              "subsets": [list(s) for s in gate.SUBSETS],
              "probe_heldin": heldin}
    report.update(score(n_samples, 0))
    if baseline is not None:
        base = _read_baseline(baseline)
        report.update(_judge_gate(report, base, score, n_samples, tol,
                                  div_frac, fid_slack, escalate=not sanity))
        report["baseline_config"] = base.get("config", str(baseline))
    if out is not None:
        _write_report(out, f"quality_{cfg}", train_steps, report)
    return report


@torch.inference_mode()
def _gate_score(run, n: int, seed: int, seed_salt: int, probe, probe_params,
                real_feats, dev: torch.device, cfg: str,
                out: Optional[str]) -> dict:
    """The flagship gates' scoring pass (the script's ``score``): each of
    the three experts sampled solo from N(0, 1) noise drawn with
    fold_in(seed, seed_salt + 30 + i), the three composed from
    fold_in(seed, seed_salt + 40), ``n`` images of 28 x 28 x 1 each,
    through ``run(expert indices, x)``; the probe's statistics of each set
    (``gate.probe_stats``). With ``out``, the first 64 samples of each set
    as the script's grids ``<cfg>_solo<i>.png`` and ``<cfg>_composed.png``
    there."""
    res = {"solo": {}, "composed": None}
    sets = [((i,), gate.SUBSETS[i], seed_salt + 30 + i, f"solo{i}")
            for i in range(len(gate.SUBSETS))]
    sets.append((tuple(range(len(gate.SUBSETS))),
                 tuple(sorted(c for s in gate.SUBSETS for c in s)),
                 seed_salt + 40, "composed"))
    for idx, allowed, salt, tag in sets:
        x = Draws(fold_in(seed, salt), dev).normal((n, 28, 28, 1))
        samples = run(idx, x)
        stats = gate.probe_stats(probe, probe_params, samples, allowed,
                                 real_feats)
        if len(idx) == 1:
            res["solo"][f"expert_{idx[0]}"] = stats
        else:
            res["composed"] = stats
        if out is not None:
            viz.save_grid(samples[:64], os.path.join(out, f"{cfg}_{tag}.png"),
                          nrow=8)
    return res


def _read_baseline(path) -> dict:
    """A baseline report read from ``path``; it must carry the
    distributional statistics (diversity, FID-lite)."""
    with open(path) as f:
        base = json.load(f)
    if "diversity_mean" not in (base.get("composed") or {}):
        raise ValueError(f"baseline {path} lacks the distributional "
                         "statistics (diversity, fid)")
    return base


def _judge_gate(report: dict, base: dict, score, n_samples: int, tol: float,
                div_frac: float, fid_slack: float, escalate: bool,
                criteria=gate.GATE_CRITERIA,
                scored: Tuple[str, ...] = ("solo", "composed")) -> dict:
    """``gate.judge`` of ``report`` against ``base`` under ``criteria``. A
    verdict decided within sampling noise of a threshold is scored again
    by ``score(4 n_samples, 1000, save_png=False)`` (with ``escalate``),
    which replaces the ``scored`` keys of the report, and judged on that;
    the first pass lands under ``escalation``. Returns the verdict, which
    the caller adds to the report."""
    verdict = gate.judge(report, base, tol, div_frac, fid_slack,
                         criteria=criteria, n_samples=n_samples)
    if verdict.get("near_boundary") and escalate:
        n_esc = 4 * n_samples
        first_pass = {"n_samples": n_samples,
                      **{k: report[k] for k in scored}, **verdict}
        report.update(score(n_esc, 1000, save_png=False))
        report["n_samples"] = n_esc
        report["escalation"] = {"first_pass": first_pass,
                                "escalated_n": n_esc,
                                "second_seed_salt": 1000}
        verdict = gate.judge(report, base, tol, div_frac, fid_slack,
                             criteria=criteria, n_samples=n_esc)
    return verdict


def _write_report(out: str, stem: str, train_steps: int,
                  report: dict) -> str:
    """``report`` as ``<out>/<stem>[_s<train_steps>].json`` (no suffix at
    the scripts' 12000 steps)."""
    os.makedirs(out, exist_ok=True)
    suffix = "" if train_steps == 12000 else f"_s{train_steps}"
    path = os.path.join(out, f"{stem}{suffix}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    return path


FLAGSHIP_GATE_CONFIGS = ("unet64", "unet32")


def quality_gate_flagship(configs: Union[str, Sequence[str]] =
                          FLAGSHIP_GATE_CONFIGS, train_steps: int = 12000,
                          batch_size: int = 256, lr: float = 2e-4,
                          ema: float = 0.999, probe_steps: int = 2000,
                          n_samples: int = 256, n_steps: int = 50,
                          data_n: int = 8192, seed: int = 0,
                          baseline: Optional[str] = None, tol: float = 0.02,
                          div_frac: float = 0.5, fid_slack: float = 1.5,
                          sanity: bool = False,
                          out: Optional[str] = "outputs/quality_gate",
                          experts: Optional[dict] = None,
                          dtype: torch.dtype = torch.bfloat16,
                          device=None) -> dict:
    """The protocol of ``scripts/quality_gate_flagship.py`` for any named
    configurations (``gate.build_model``), on the device (``None``: the
    CUDA card). Returns {config: report}.

    1. The 10-class digit probe and its real-image features, as
       :func:`quality_gate` makes them (keys fold_in(seed, 1) and 2), and
       the three digit subsets ``gate.SUBSETS`` of ``data_n`` procedural
       digits each (key fold_in(seed, 3 + i)): one probe and one set of
       data for all configurations.
    2. Per configuration, three experts: the initial tree drawn with
       fold_in(seed, 10 + i), trained ``train_steps`` with fold_in(seed,
       20 + i) through the model's training forward (bf16 compute over
       float32 parameters, eps-prediction on ``VPSchedule()``, Adam at
       ``lr``, EMA ``ema``; 0: off); ``experts``: {config: EMA trees}
       already trained for this seed, to skip the training. The trees are
       cast to bf16.
    3. Each expert sampled solo and the three composed (unit weights,
       ``compose.weighted``), ``n_samples`` each, ``n_steps`` of DDIM
       through the configuration's served program (``fused_dit_block`` or
       ``groupnorm_silu``), scored by ``gate.probe_stats``.
    4. With ``baseline`` (the path of a report .json, or a name among
       ``configs``, judged in this run and labelled "BASELINE"; None:
       report only) the verdict of ``gate.judge``; a candidate decided
       within sampling noise of a threshold is scored again with 4x the
       samples and seed salt 1000 (not under ``sanity``).

    ``dtype``: the experts' compute type in training and sampling (the
    script's bf16; float32 holds the port to the JAX package in tests).
    ``sanity`` cuts every size as the script's ``--sanity`` does. With
    ``out``, each report is written there as
    ``quality_<config>[_s<train_steps>].json`` and its grids as
    ``<config>_solo<i>.png`` and ``<config>_composed.png``. A FAIL raises
    nothing: the caller reads the verdicts (the script's exit code is a
    command line's business)."""
    dev = resolve_device(device)
    configs = tuple(configs.split(",") if isinstance(configs, str)
                    else configs)
    models = {cfg: gate.build_model(cfg, dtype) for cfg in configs}
    if not (baseline is None or str(baseline).endswith(".json")
            or baseline in configs):
        raise ValueError(f"baseline {baseline!r} is neither a .json path "
                         f"nor one of {configs}")
    if sanity:
        train_steps, probe_steps = 40, 40
        n_samples, n_steps, data_n = 16, 4, 256
        batch_size = 16
    full_imgs, full_labels = data.get_mnist(fold_in(seed, 1), n=data_n,
                                            device=dev)
    probe, probe_params = ceval.train_probe(
        fold_in(seed, 2), full_imgs, (full_labels,), num_classes=(10,),
        steps=probe_steps, noise_aug=0.1)
    heldin = ceval.probe_accuracy(probe, probe_params, full_imgs[:512],
                                  (full_labels[:512],))
    real_feats = ceval.probe_features(probe, probe_params, full_imgs[:2048])
    subset_data = [data.get_mnist(fold_in(seed, 3 + i), n=data_n,
                                  classes=s, device=dev)[0]
                   for i, s in enumerate(gate.SUBSETS)]

    reports, scorers = {}, {}
    for cfg, (model, serve_fn) in models.items():
        is_unet = isinstance(model, UNet)
        trees = (experts or {}).get(cfg)
        if trees is None:
            trees = []
            for i, imgs in enumerate(subset_data):
                p0 = flax_init(model, fold_in(seed, 10 + i), dev)
                if is_unet:
                    p0 = unet_torch_layout(p0)
                p, _ = train.train_expert(
                    fold_in(seed, 20 + i), model.apply, p0, VPSchedule(),
                    imgs, steps=train_steps, batch_size=batch_size, lr=lr,
                    ema_decay=ema or None)
                trees.append(p)
        params = (load_unets if is_unet else load_experts)(trees, dev, dtype)

        def run(idx, x, serve_fn=serve_fn, params=params):
            stack = ExpertStack(serve_fn, [params[i] for i in idx])
            w = torch.ones((stack.k,), dtype=torch.float32, device=dev)

            def eps_fn(x_: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
                if stack.k == 1:  # the script's solo eps: no blend
                    return serve_fn(stack.params_list[0], x_.to(dtype),
                                    t.to(dtype)).float()
                return weighted(stack(x_.to(dtype), t.to(dtype)).float(), w)
            return ddim(eps_fn, VPSchedule(), x, n_steps)

        def score(n: int, seed_salt: int, save_png: bool = True,
                  run=run, cfg=cfg) -> dict:
            return _gate_score(run, n, seed, seed_salt, probe, probe_params,
                               real_feats, dev, cfg,
                               out if save_png else None)

        report = {"config": cfg, "train_steps": train_steps,
                  "batch_size": batch_size, "ema": ema, "n_steps": n_steps,
                  "n_samples": n_samples,
                  "subsets": [list(s) for s in gate.SUBSETS],
                  "probe_heldin": heldin, "solo": {}, "composed": None}
        report.update(score(n_samples, 0))
        reports[cfg], scorers[cfg] = report, score

    base = None
    if baseline is not None:
        base = (_read_baseline(baseline) if str(baseline).endswith(".json")
                else reports[baseline])
    for cfg, report in reports.items():
        if base is not None:
            is_base = report is base
            verdict = _judge_gate(report, base, scorers[cfg],
                                  report["n_samples"], tol, div_frac,
                                  fid_slack, escalate=not (is_base or sanity))
            if is_base:
                verdict["verdict"] = "BASELINE"
            report.update(verdict)
            report["baseline_config"] = base.get("config", str(baseline))
        if out is not None:
            _write_report(out, f"quality_{cfg}", train_steps, report)
    return reports


# ------------------------------------------------------------ shapes gate
SHAPES_GATE_CONFIGS = ("unet64", "dit_p8_d256_l8")
SHAPES_WORKLOAD = "shapes64_2expert_ddim50"


def shapes_gate_model(name: str, img: int = 64) -> Tuple[Any, Any]:
    """(training configuration, serving configuration) of a shapes-gate
    configuration name, as ``scripts/quality_gate_shapes.py`` builds them:
    ``unet<W>`` is a 3-channel UNet of base W, widths (W, 2W, 4W), one
    3-class label slot, trained and served in bf16 compute (trained with
    GroupNorm in PyTorch ops, served through the ``groupnorm_silu``
    kernel); ``dit_p<P>_d<D>_l<L>[_h<H>]`` a DiT of patch P, width D, depth
    L and H heads (8 by default) on img x img x 3, one 3-class label slot,
    trained in float32 compute through the unfolded forward with the
    einsum attention and served in bf16 through the folded path."""
    if name.startswith("unet"):
        m = UNet(in_channels=3, base_dim=int(name[4:]),
                 channel_mults=(1, 2, 4), num_classes=(3,),
                 dtype=torch.bfloat16)
        return m, dataclasses.replace(m, fused_gn=True)
    if name.startswith("dit"):
        parts = {q[0]: int(q[1:]) for q in name.split("_")[1:]}
        if img % parts["p"]:
            raise ValueError(f"img {img} not divisible by patch {parts['p']}")
        m = DiT(patch=parts["p"], dim=parts["d"], depth=parts["l"],
                n_heads=parts.get("h", 8), in_channels=3, num_classes=(3,),
                img_size=img)
        return m, dataclasses.replace(m, dtype=torch.bfloat16)
    raise ValueError(f"unknown config {name}")


def train_shapes_experts(config: str = "unet64", steps: int = 12000,
                         batch_size: int = 128, lr: float = 2e-4,
                         ema: float = 0.999, snr_gamma: float = 0.0,
                         clip_norm: float = 1.0, seed: int = 0,
                         data_n: int = 8192, img: int = 64,
                         dataset=None, device=None) -> Tuple[list, list]:
    """Trains the shapes gate's shape- and color-conditional experts of
    ``config`` (:func:`shapes_gate_model`) on ``make_shapes_dataset(data_n,
    img)`` made on the device (``dataset``: that triple, already made),
    with the script's keys: init ``fold_in(seed, 10 + i)``, training
    ``fold_in(seed, 20 + i)``. eps-prediction on ``VPSchedule()``, Adam at
    ``lr`` after the global-norm clip ``clip_norm``, EMA ``ema``, min-SNR
    weighting ``snr_gamma`` (each 0: off). Returns (trees, losses): the EMA
    trees (float32, on the device, in the layout ``apply`` reads; the
    serving entry points take them as they are) and each expert's (steps,)
    losses on the device. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    model, _ = shapes_gate_model(config, img)
    imgs, shape_labels, color_labels = (
        dataset if dataset is not None
        else data.make_shapes_dataset(data_n, img, device=dev))
    trees, losses = [], []
    for i, labels in enumerate((shape_labels, color_labels)):
        p0 = flax_init(model, fold_in(seed, 10 + i), dev)
        if isinstance(model, UNet):
            p0 = unet_torch_layout(p0)
        p, loss = train.train_expert(
            fold_in(seed, 20 + i), model.apply, p0, VPSchedule(), imgs,
            (labels,), steps=steps, batch_size=batch_size, lr=lr,
            ema_decay=ema or None, snr_gamma=snr_gamma or None,
            clip_norm=clip_norm or None)
        trees.append(p)
        losses.append(loss)
    return trees, losses


def _mean_pairwise_distance(feats: torch.Tensor) -> float:
    """Mean Euclidean distance over the pairs of rows, in float64."""
    f = feats.double()
    d = torch.sqrt(torch.clamp(((f[:, None, :] - f[None, :, :]) ** 2)
                               .sum(-1), min=0.0))
    iu = torch.triu_indices(f.shape[0], f.shape[0], offset=1,
                            device=f.device)
    return float(d[iu[0], iu[1]].mean())


def shapes_baseline(baseline: str, reports: dict) -> dict:
    """The baseline report, as the script reads ``--baseline``: a path
    ending in .json is loaded; otherwise the name of a configuration among
    ``reports``; anything else raises."""
    if baseline.endswith(".json"):
        with open(baseline) as f:
            return json.load(f)
    if baseline in reports:
        return reports[baseline]
    raise ValueError(f"baseline {baseline!r} not found: name one of "
                     f"{tuple(reports)} or a report .json")


def quality_gate_shapes(configs: Union[str, Sequence[str]] =
                        SHAPES_GATE_CONFIGS, baseline: str = "unet64",
                        train_steps: int = 12000, batch_size: int = 128,
                        lr: float = 2e-4, ema: float = 0.999,
                        snr_gamma: float = 0.0, clip_norm: float = 1.0,
                        probe_steps: int = 2000, samples_per_cell: int = 64,
                        n_steps: int = 50, img: int = 64, data_n: int = 8192,
                        tol: float = 0.02, div_frac: float = 0.5,
                        fid_slack: float = 1.5, sanity: bool = False,
                        out: Optional[str] = None, seed: int = 0,
                        experts: Optional[dict] = None,
                        device=None) -> dict:
    """The protocol of ``scripts/quality_gate_shapes.py`` on the device
    (``None``: the CUDA card). Returns {config: report}.

    1. ``make_shapes_dataset(data_n, img)``; a two-factor probe (shape,
       color) trained ``probe_steps`` with key fold_in(seed, 1), noise
       augmentation 0.1; its held-in accuracy on the first 512 images
       (``probe_heldin``, a key the script prints but does not save) and
       the features of the first 2048 as the real statistics.
    2. Per configuration, its shape and color experts
       (:func:`train_shapes_experts`; ``experts``: {config: EMA trees}
       already trained for this seed, to skip the training), cast to bf16.
    3. The 9 (shape, color) cells, ``samples_per_cell`` each, ``n_steps``
       of DDIM from noise drawn with fold_in(seed, 40 + 3 s + c), the two
       experts' eps averaged (``compose.weighted``): ``unet`` configs
       through :func:`sample_shapes` (per-sample (2, B) labels), ``dit``
       configs through :func:`sample`'s folded stack (batch-constant (2, 1)
       labels); samples clipped to [-1, 1]; per cell the probe's
       compositional scores and the mean pairwise feature distance, and
       over all cells the FID-lite against the real features.
    4. ``gate.judge`` under ``gate.SHAPES_CRITERIA`` against ``baseline``
       (a configuration run here, or the path of a report .json); a
       candidate decided within sampling noise of a threshold is scored
       again with 4x the samples and seed salt 1000. The baseline's own
       verdict is "BASELINE".

    ``sanity`` cuts every size as the script's ``--sanity`` does. With
    ``out``, each report is written there as
    ``quality_shapes_<config>[_s<train_steps>].json``, beside the script's
    grid of the first pass, ``<config>_cells.png`` (the first 4 clipped
    samples of each cell, 12 a row)."""
    dev = resolve_device(device)
    configs = tuple(configs.split(",") if isinstance(configs, str)
                    else configs)
    if sanity:
        train_steps, probe_steps = 40, 200
        samples_per_cell, n_steps = 8, 4
        data_n, batch_size, img = 512, 16, 16
    full = data.make_shapes_dataset(data_n, img, device=dev)
    full_imgs, full_s, full_c = full
    probe, probe_params = ceval.train_probe(
        fold_in(seed, 1), full_imgs, (full_s, full_c), num_classes=(3, 3),
        steps=probe_steps, noise_aug=0.1)
    heldin = ceval.probe_accuracy(probe, probe_params, full_imgs[:512],
                                  (full_s[:512], full_c[:512]))
    real_feats = ceval.probe_features(probe, probe_params, full_imgs[:2048])

    reports, scorers = {}, {}
    for cfg in configs:
        train_model, serve_model = shapes_gate_model(cfg, img)
        trees = (experts or {}).get(cfg)
        if trees is None:
            trees, _ = train_shapes_experts(
                cfg, train_steps, batch_size, lr, ema, snr_gamma, clip_norm,
                seed, data_n, img, dataset=full, device=dev)
        is_unet = isinstance(train_model, UNet)
        params = (load_unets(trees, dev) if is_unet
                  else load_experts(trees, dev))

        def score(bs: int, seed_salt: int, save_png: bool = True,
                  params=params, is_unet=is_unet, serve_model=serve_model,
                  cfg=cfg) -> dict:
            res = {"cells": {}, "composed": None}
            joint, divs, feats_all, grids = [], [], [], []
            for s_ in range(3):
                for c in range(3):
                    x = Draws(fold_in(seed, seed_salt + 40 + 3 * s_ + c),
                              dev).normal((bs, img, img, 3))
                    if is_unet:
                        labs = torch.tensor([[s_] * bs, [c] * bs], device=dev)
                        samples = sample_shapes(params, x, labs, n_steps,
                                                device=dev, model=serve_model)
                    else:
                        labs = torch.tensor([[s_], [c]], device=dev)
                        samples = sample(params, x, n_steps, device=dev,
                                         labels=(labs,), model=serve_model)
                    samples = samples.clamp(-1.0, 1.0)
                    grids.append(samples[:4])
                    scores = ceval.compositional_scores(
                        probe, probe_params, samples, (s_, c))
                    feats = ceval.probe_features(probe, probe_params, samples)
                    feats_all.append(feats)
                    divs.append(_mean_pairwise_distance(feats))
                    res["cells"][f"{s_},{c}"] = scores
                    joint.append(scores["joint_acc"])
            res["composed"] = {
                "joint_mean": float(np.mean(joint)),
                "joint_min": float(np.min(joint)),
                "diversity_mean": float(np.mean(divs)),
                "diversity_min": float(np.min(divs)),
                "fid_probe": round(ceval.frechet_probe_distance(
                    torch.cat(feats_all), real_feats), 4),
            }
            if save_png and out is not None:
                viz.save_grid(torch.cat(grids),
                              os.path.join(out, f"{cfg}_cells.png"), nrow=12)
            return res

        report = {"config": cfg, "workload": SHAPES_WORKLOAD,
                  "train_steps": train_steps, "img": img,
                  "snr_gamma": snr_gamma, "clip_norm": clip_norm,
                  "n_samples": samples_per_cell, "probe_heldin": heldin,
                  "cells": {}, "composed": None}
        report.update(score(samples_per_cell, 0))
        reports[cfg], scorers[cfg] = report, score

    base = shapes_baseline(baseline, reports)
    for cfg, report in reports.items():
        verdict = _judge_gate(report, base, scorers[cfg], samples_per_cell,
                              tol, div_frac, fid_slack,
                              escalate=not (report is base or sanity),
                              criteria=gate.SHAPES_CRITERIA,
                              scored=("cells", "composed"))
        if report is base:
            verdict["verdict"] = "BASELINE"
        report.update(verdict)
        report["baseline_config"] = base.get("config", baseline)
        if out is not None:
            _write_report(out, f"quality_shapes_{cfg}", train_steps, report)
    return reports


# -------------------------------------------------------------------- NLL
def eval_nll(params: Any, model: Any = SHAPES_UNET, dataset: str = "shapes",
             dataset_kw: Optional[dict] = None, n_data: int = 256,
             n_steps: int = 200, n_probes: int = 4, probe: str = "rademacher",
             exact: bool = False, t_max: Optional[float] = None,
             schedule: VPSchedule = VPSchedule(), predict: str = "eps",
             conditional: bool = False,
             label_slots: Optional[Sequence[int]] = None, seed: int = 42,
             probes: Optional[torch.Tensor] = None, device=None) -> dict:
    """The protocol of ``scripts/eval_nll.py`` on a parameter tree (the
    script reads a checkpoint): per-example log p(x) of ``n_data`` images of
    ``data.get_dataset(dataset, fold_in(seed, 7), n_data, **dataset_kw)``
    under the expert (``model``: a UNet or DiT configuration; a UNet's
    GroupNorm runs in PyTorch ops inside the jvps, whatever its
    ``fused_gn``), by ``samplers.log_likelihood`` over ``n_steps`` with
    ``n_probes`` Hutchinson probes drawn with fold_in(seed, 11) (``probes``:
    (n_steps, n_probes, *images.shape) in their place) or the exact trace.

    ``predict``: what the expert predicts (eps, x0 or v; v needs the
    ``stable`` kind), turned into the score -eps / sigma. ``t_max`` defaults
    to 0.99 under ``kind="rectified"`` (whose g^2 diverges at 1), else 1.
    ``conditional`` passes the dataset's labels (``label_slots``: their
    indices; by default the first as many as the model has slots).
    Returns the script's report: ``nll_nats_mean``, ``bits_per_dim_mean``
    and ``bits_per_dim_sem`` (population std / sqrt(n)) beside the
    settings. ``device=None`` is the CUDA card."""
    if predict == "v" and schedule.kind != "stable":
        raise ValueError("predict='v' identities need "
                         "VPSchedule(kind='stable') (alpha^2 + sigma^2 = 1)")
    dev = resolve_device(device)
    if isinstance(model, UNet):
        model = dataclasses.replace(model, fused_gn=False)
        tree, = load_unets([params], dev, torch.float32)
    else:
        tree, = load_experts([params], dev, torch.float32)
    images, *labels = data.get_dataset(dataset, fold_in(seed, 7), n_data,
                                       device=dev, **(dataset_kw or {}))
    if not conditional:
        labels = []
    elif label_slots is not None:
        labels = [labels[i] for i in label_slots]
    else:
        labels = labels[:len(model.num_classes)]

    def score_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        eps = model.apply(tree, x, t * torch.ones(x.shape[0], device=dev),
                          *labels)
        if predict == "x0":  # eps from the x0 estimate
            eps = (x - schedule.alpha(t) * eps) / schedule.sigma(t)
        elif predict == "v":
            eps = schedule.sigma(t) * x + schedule.alpha(t) * eps
        return -eps / schedule.sigma(t)

    if t_max is None:
        t_max = 0.99 if schedule.kind == "rectified" else 1.0
    with torch.no_grad():  # forward-mode AD: not inference_mode
        ll, _ = samplers.log_likelihood(
            score_fn, schedule, images, n_steps, key=fold_in(seed, 11),
            probe=probe, n_probes=n_probes, exact=exact, t_max=t_max,
            probes=None if probes is None else probes.to(dev))
    bpd = samplers.bits_per_dim(ll, images.shape[1:])
    return {"dataset": dataset, "n_data": n_data, "n_steps": n_steps,
            "n_probes": n_probes, "probe": probe, "exact": bool(exact),
            "t_max": t_max, "schedule_kind": schedule.kind,
            "nll_nats_mean": -float(ll.mean()),
            "bits_per_dim_mean": float(bpd.mean()),
            "bits_per_dim_sem": float(bpd.std(correction=0)
                                      / math.sqrt(bpd.shape[0]))}


# ---------------------------------------------------- config-driven paths
def _subkey(key, i: int):
    """fold_in(key, i) of an int key, or of a ``rng.Draws`` (a
    ``rng.Replay`` hands out its recording in order)."""
    return key.fold_in(i) if isinstance(key, Draws) else fold_in(key, i)


def _float_tree(tree: Any, model, dev: torch.device) -> Any:
    """A parameter tree in float32 on ``dev``; a UNet's in the layout
    ``UNet.apply`` reads."""
    tree = _cast(tree, dev, torch.float32)
    return unet_torch_layout(tree) if isinstance(model, UNet) else tree


def load_named(preset: str, names: Sequence[str], out: str = "outputs",
               overrides: Sequence[str] = (), device=None) -> list:
    """The ``params`` trees that :func:`train_image` saved under ``names``
    for ``preset`` (its ``CheckpointManager(out, cfg.name)``), in float32
    on the device (``None``: the CUDA card); UNet trees in the layout
    ``UNet.apply`` reads. ``scripts/superdiff.py`` and the sampling
    scripts load their experts so."""
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    model = build_model(cfg)
    mgr = CheckpointManager(out, cfg.name)
    return [_float_tree(mgr.load(n, device=dev)["params"], model, dev)
            for n in names]


def train_image(preset: str = "mnist_image", name: str = "expert",
                classes: Optional[Sequence[int]] = None,
                conditional: bool = False,
                label_slots: Optional[Sequence[int]] = None,
                sanity: bool = False, resumable: bool = False,
                out: str = "outputs", overrides: Sequence[str] = (),
                plot_loss: bool = False, device=None, key=None,
                init: Any = None) -> Tuple[Any, torch.Tensor, str]:
    """Trains one image expert of a preset: the path of
    ``scripts/train_image.py``. Returns (params, losses, checkpoint path):
    the trained tree (the EMA tree where the preset sets ``ema_decay``) in
    the layout its model's ``apply`` reads, on the device, and the (steps,)
    losses there.

    ``overrides``: dotted ``--key=value`` strings (``utils.config``);
    ``classes`` restricts the dataset; ``sanity`` cuts the sizes
    (``Config.apply_sanity``). The data are drawn with ``fold_in(key, 1)``,
    the initial tree with ``fold_in(key, 2)`` (``convert.flax_init``;
    ``init``: a tree in its place, e.g. a converted flax tree), the
    training with ``fold_in(key, 3)``; ``key`` defaults to the config's
    seed (an ``rng.Draws`` or ``rng.Replay`` in its place replays draws).
    ``conditional`` trains on the dataset's first label slots (as many as
    the model has), or on ``label_slots`` (indices into the dataset's
    labels); label dropout ``train.uncond_prob`` replaces both slots of a
    sample by the null labels (the class counts) together. The model trains
    without kernels (none has a backward). ``resumable`` checkpoints every
    chunk of 100 steps and resumes from the newest
    (``train.train_expert_resumable``).

    Writes, under ``CheckpointManager(out, cfg.name)``: the checkpoint
    ``{name}_final`` ({"params", "step"}), the config as
    ``logs/{name}_config.yaml``, the losses as ``results/{name}_loss.npy``
    (and ``{name}_loss.png`` with ``plot_loss``, which needs matplotlib)
    and, for an unconditional VP preset, the one-step denoise grid
    ``results/{name}_onestep.png``. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    if classes:
        cfg.data.classes = tuple(classes)
    cfg.train.sanity = cfg.train.sanity or sanity
    cfg.apply_sanity()
    key = cfg.train.seed if key is None else key
    schedule = build_schedule(cfg)
    model = build_model(cfg)
    images, labels = build_dataset(cfg, _subkey(key, 1), dev)
    if not conditional:
        train_labels = ()
    elif label_slots:
        train_labels = tuple(labels[s] for s in label_slots)
    else:
        train_labels = labels[:len(cfg.model.num_classes)]
    params = (init_params(model, _subkey(key, 2), dev) if init is None
              else _float_tree(init, model, dev))
    mgr = CheckpointManager(out, cfg.name)
    t = cfg.train
    train_kw = dict(
        steps=t.steps, batch_size=t.batch_size, lr=t.lr, predict=t.predict,
        snr_gamma=t.snr_gamma or None, uncond_prob=t.uncond_prob,
        null_labels=tuple(cfg.model.num_classes) if t.uncond_prob else None,
        steps_per_scan=min(100, t.steps), ema_decay=t.ema_decay or None)
    if resumable:
        params, losses = train.train_expert_resumable(
            _subkey(key, 3), model.apply, params, schedule, images, mgr,
            name, train_labels, **train_kw)
    else:
        params, losses = train.train_expert(
            _subkey(key, 3), model.apply, params, schedule, images,
            train_labels, **train_kw)
    path = mgr.save(name, {"params": params, "step": t.steps})
    save_yaml(cfg, os.path.join(mgr.logs_dir, f"{name}_config.yaml"))
    if losses.shape[0]:  # empty when a resumable run was already complete
        np.save(os.path.join(mgr.results_dir, f"{name}_loss.npy"),
                losses.cpu().numpy())
        if plot_loss:
            viz.plot_loss(losses,
                          os.path.join(mgr.results_dir, f"{name}_loss.png"))
    if cfg.schedule.family == "vp" and not cfg.model.num_classes:
        size, ch = cfg.data.img_size, cfg.model.in_channels
        with torch.no_grad():
            grid = train.one_step_denoise_val(
                model.apply, params, schedule, key, (16, size, size, ch),
                device=dev)
        viz.save_grid(grid, os.path.join(mgr.results_dir,
                                         f"{name}_onestep.png"), nrow=4)
    return params, losses, path


@torch.inference_mode()
def sample_image(preset: str = "mnist_image", name: str = "expert",
                 sampler: Optional[str] = None, eta: float = 0.0,
                 corrector_steps: int = 0, corrector_snr: float = 0.16,
                 seed: int = 42, out: str = "outputs",
                 overrides: Sequence[str] = (), fused_gn: bool = True,
                 x_init=None,
                 noise: Optional[torch.Tensor] = None, key=None,
                 device=None) -> torch.Tensor:
    """Samples one trained expert of a preset (the checkpoint
    :func:`train_image` saved as ``name``): the path of
    ``scripts/sample_image.py``. Returns the float32 (B, H, W, C) samples
    at the config's ``sample.batch_size`` and ``sample.n_steps``, and
    writes their grid to ``results/{name}_samples.png``.

    ``sampler`` (None: the config's ``sample.sampler``): "em"
    (Euler-Maruyama, churn ``sample.xi``), "ode" (probability flow),
    "picard" (``parallel_prob_flow``, 15 sweeps), "dpmpp"
    (DPM-Solver++(2M)); "ddim" and any other name run DDIM with ``eta``,
    the Langevin corrector (``corrector_steps``, ``corrector_snr``) and
    the config's ``train.predict``. A model that predicts x0 or v samples
    through DDIM only (ValueError otherwise). An unconditional sampler
    cannot drive a conditional model: its ``apply`` raises, as the JAX
    UNet's assertion does.

    Draws: the initial noise from ``rng.Draws(seed)`` (``x_init`` in its
    place), E-M's noise from a generator seeded with ``seed`` (``noise``:
    (n_steps, B, H, W, C) in its place), DDIM's eta and corrector draws
    from ``fold_in(seed, 1)`` (``key`` in its place). ``fused_gn=True``
    routes a UNet's GroupNorm + SiLU through the ``groupnorm_silu`` kernel
    (its cross-attention, where it has one, always goes through
    ``flash_attention``). ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    if sampler:
        cfg.sample.sampler = sampler
    sampler = cfg.sample.sampler
    if cfg.train.predict != "eps" and sampler not in (None, "", "ddim"):
        raise ValueError(f"predict={cfg.train.predict!r} models sample "
                         "through ddim only (em, ode, picard and dpmpp "
                         "take eps closures)")
    schedule = build_schedule(cfg)
    model = build_model(cfg, fused_gn=fused_gn, flash_attn=True)
    params, = load_named(preset, [name], out, overrides, dev)
    size, ch = cfg.data.img_size, cfg.model.in_channels
    shape = (cfg.sample.batch_size, size, size, ch)
    x = (Draws(seed, dev).normal(shape) if x_init is None
         else torch.as_tensor(x_init, dtype=torch.float32).to(dev))
    n = cfg.sample.n_steps

    def eps_fn(x_: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return model.apply(params, x_, t)

    if sampler == "em":
        gen = torch.Generator(device=dev).manual_seed(seed)
        out_x = samplers.euler_maruyama(
            eps_fn, schedule, gen, x, n, cfg.sample.xi,
            noise=None if noise is None else noise.to(dev))
    elif sampler == "ode":
        out_x = samplers.prob_flow_ode(
            lambda x_, t: -eps_fn(x_, t) / schedule.sigma(t), schedule, x, n)
    elif sampler == "picard":
        # the n_steps grid points folded into the batch axis, 15 sweeps
        def score_fn(x_, t):
            return -eps_fn(x_, t) / schedule.sigma(t).reshape(
                (-1,) + (1,) * (x_.dim() - 1))
        out_x, _ = samplers.parallel_prob_flow(score_fn, schedule, x, n,
                                               n_iters=15)
    elif sampler == "dpmpp":
        out_x = samplers.dpm_solver_pp_2m(eps_fn, schedule, x, n)
    else:
        stochastic = bool(eta or corrector_steps)
        out_x = ddim(eps_fn, schedule, x, n, eta=eta,
                     key=((fold_in(seed, 1) if key is None else key)
                          if stochastic else None),
                     predict=cfg.train.predict,
                     corrector_steps=corrector_steps,
                     corrector_snr=corrector_snr)
    mgr = CheckpointManager(out, cfg.name)
    viz.save_grid(out_x, os.path.join(mgr.results_dir, f"{name}_samples.png"))
    return out_x


@torch.inference_mode()
def compose_scores(preset: str = "mnist_image",
                   experts: Sequence[str] = ("expert_a", "expert_b"),
                   weights: Optional[Sequence[float]] = None,
                   sampler: str = "em", corrector_steps: int = 0,
                   corrector_snr: float = 0.16, seed: int = 42,
                   out: str = "outputs", overrides: Sequence[str] = (),
                   fused_blend: bool = True, fused_gn: bool = True,
                   x_init=None, noise: Optional[torch.Tensor] = None,
                   key=None, device=None) -> torch.Tensor:
    """Composes K trained experts of a preset (the checkpoints
    :func:`train_image` saved under ``experts``) by a weighted eps blend:
    the path of ``scripts/compose_scores.py``. Returns the float32 (B, H,
    W, C) samples and writes their grid to
    ``results/composed_{names}.png``.

    ``weights``: (K,) blend weights, ones by default. ``fused_blend=True``
    blends through the ``blend_eps`` kernel, ``False`` through
    ``compose.weighted``; ``fused_gn`` as in :func:`sample_image`.
    ``sampler``: "em" (Euler-Maruyama, churn ``sample.xi``), "ddim" (with
    the Langevin corrector: ``corrector_steps``, ``corrector_snr``) or
    "dpmpp". Draws as in :func:`sample_image` (``x_init``, ``noise``,
    ``key``). ``device=None`` is the CUDA card."""
    if sampler not in ("em", "ddim", "dpmpp"):
        raise ValueError(f"sampler must be 'em', 'ddim' or 'dpmpp', got "
                         f"{sampler!r}")
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    schedule = build_schedule(cfg)
    model = build_model(cfg, fused_gn=fused_gn, flash_attn=True)
    names = list(experts)
    stack = ExpertStack(model.apply,
                        load_named(preset, names, out, overrides, dev))
    w = compose.constant([1.0] * len(names) if weights is None else weights,
                         torch.float32, dev)
    blend = blend_eps if fused_blend else weighted

    def eps_fn(x_: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return blend(stack(x_, t), w)

    size, ch = cfg.data.img_size, cfg.model.in_channels
    shape = (cfg.sample.batch_size, size, size, ch)
    x = (Draws(seed, dev).normal(shape) if x_init is None
         else torch.as_tensor(x_init, dtype=torch.float32).to(dev))
    n = cfg.sample.n_steps
    if sampler == "dpmpp":
        out_x = samplers.dpm_solver_pp_2m(eps_fn, schedule, x, n)
    elif sampler == "ddim":
        out_x = ddim(eps_fn, schedule, x, n,
                     key=((fold_in(seed, 1) if key is None else key)
                          if corrector_steps else None),
                     corrector_steps=corrector_steps,
                     corrector_snr=corrector_snr)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        out_x = samplers.euler_maruyama(
            eps_fn, schedule, gen, x, n, cfg.sample.xi,
            noise=None if noise is None else noise.to(dev))
    mgr = CheckpointManager(out, cfg.name)
    viz.save_grid(out_x, os.path.join(mgr.results_dir,
                                      f"composed_{'_'.join(names)}.png"))
    return out_x


# the latent expert of the VAE path: z, the time embedding and one digit
# slot with the null token (10)
@torch.inference_mode()
def compose_cfg(preset: str = "colored_mnist_guided", name: str = "guided",
                digit: int = 3, color: int = 6,
                guidance: Sequence[float] = (2.0, 2.0),
                sampler: str = "ddim", out: str = "outputs", seed: int = 42,
                overrides: Sequence[str] = (), fused_gn: bool = True,
                flash_attn: bool = True, x_init=None,
                noise: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """Classifier-free-guidance composition of (digit, color) with one
    trained dual-conditioned expert of a preset (the checkpoint
    :func:`train_image` saved as ``name``): the path of
    ``scripts/compose_cfg.py``. Returns the float32 (B, H, W, C) samples at
    the config's ``sample.batch_size`` and writes their grid to
    ``results/cfg_d<digit>_c<color>.png``.

    The two single-condition slots (digit with the null color, the null
    digit with color) and the uncond slot (both null tokens, the class
    counts) run as one forward of 3B rows, weighed by ``guidance``
    (``samplers.make_cfg_eps_fn``). A ``vp`` preset samples by ``sampler``:
    "ddim" or "em" (Euler-Maruyama), ``sample.n_steps`` steps; a ``ddpm``
    preset by ancestral DDPM over its ``schedule.num_timesteps``, the
    expert taking the integer timestep as a float. Draws: the initial noise
    from ``rng.Draws(seed)`` (``x_init`` in its place), E-M's and the
    ancestral sampler's from a generator seeded with ``seed`` (``noise``:
    the (n_steps or T, B, H, W, C) draws in its place).

    ``fused_gn=True`` runs the UNet's GroupNorm + SiLU through the
    ``groupnorm_silu`` kernel; ``flash_attn=True`` its cross-attention,
    where the preset has one (``ito_cross_attention``), through
    ``flash_attention``. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    if sampler not in ("ddim", "em"):
        raise ValueError(f"sampler must be 'ddim' or 'em', got {sampler!r}")
    cfg = get_config(preset, overrides)
    schedule = build_schedule(cfg)
    model = build_model(cfg, fused_gn=fused_gn,
                        flash_attn=flash_attn and cfg.model.cross_attn)
    params, = load_named(preset, [name], out, overrides, dev)
    n1, n2 = cfg.model.num_classes  # the null token is the vocabulary size
    eps_fn = make_cfg_eps_fn(
        lambda x, t, *labs: model.apply(params, x, t, *labs),
        [(digit, n2), (n1, color)], (n1, n2),
        torch.tensor(list(guidance), dtype=torch.float32, device=dev))
    size, ch = cfg.data.img_size, cfg.model.in_channels
    shape = (cfg.sample.batch_size, size, size, ch)
    x = (Draws(seed, dev).normal(shape) if x_init is None
         else torch.as_tensor(x_init, dtype=torch.float32).to(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = None if noise is None else noise.to(dev)
    if cfg.schedule.family == "vp":
        if sampler == "em":
            out_x = samplers.euler_maruyama(eps_fn, schedule, gen, x,
                                            cfg.sample.n_steps, noise=noise)
        else:
            out_x = ddim(eps_fn, schedule, x, cfg.sample.n_steps)
    else:
        t_col = torch.arange(schedule.num_timesteps, dtype=torch.float32,
                             device=dev)
        out_x = samplers.ddpm_ancestral(
            lambda x_, ti: eps_fn(x_, t_col[ti]), schedule, gen, x,
            noise=noise)
    mgr = CheckpointManager(out, cfg.name)
    viz.save_grid(out_x, os.path.join(mgr.results_dir,
                                      f"cfg_d{digit}_c{color}.png"))
    return out_x


VAE_LATENT_T = 300


def vae_latent_mlp(latent_dim: int = 10) -> LatentDiffusionMLP:
    return LatentDiffusionMLP(latent_dim=latent_dim, hidden=256, depth=3,
                              num_classes=(10,), null_token=True)


def train_vae(preset: str = "mnist_image", latent_dim: int = 10,
              beta: float = 1.0, vae_steps: int = 2000,
              diff_steps: int = 2000, name: str = "vae",
              sanity: bool = False, out: str = "outputs",
              overrides: Sequence[str] = (), device=None, key=None,
              init: Optional[dict] = None) -> dict:
    """Trains the beta-VAE codec and a digit-conditional latent diffusion
    expert on its mean encodings: the path of ``scripts/train_vae.py``.

    1. The preset's dataset (``rng.Draws(key)``), mapped to [0, 1].
    2. ``BetaVAE(img_size, in_channels, latent_dim)`` initialised from
       ``key`` (``init["vae"]``: a tree in its place), ``vae_steps`` steps
       of Adam at 1e-3 on the BCE + ``beta`` KL loss (``vae_loss``), each
       on 128 images drawn with replacement: step i's key ``fold_in(key,
       i)`` split in two, for the indices and the reparameterisation noise.
    3. The mean encodings mu of every image, cached.
    4. ``vae_latent_mlp(latent_dim)`` initialised from ``key``
       (``init["mlp"]``) and trained ``diff_steps`` on (mu, digit) under
       ``DDPMSchedule(300)`` (``train.train_expert``: batch 256, lr 1e-3,
       label dropout 0.1 to the null label 10, t first), key ``fold_in(key,
       1)``.

    ``sanity`` cuts both trainings to 30 steps and the data to 256 images;
    ``key`` defaults to the config's seed (a ``rng.Replay`` replays the
    draws). Saves {"vae", "mlp", "latent_dim"} as ``{name}_final`` under
    ``CheckpointManager(out, f"{cfg.name}_vae")``. Returns {"vae", "mlp":
    the trees, "vae_losses", "diff_losses": (steps,) on the device,
    "path"}. No kernel runs in training. ``device=None`` is the CUDA
    card."""
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    if sanity:
        vae_steps, diff_steps = 30, 30
        cfg.data.n = 256
    key = cfg.train.seed if key is None else key
    images, (labels, *_) = build_dataset(cfg, key, dev)
    images01 = (images + 1.0) / 2.0  # BCE wants [0, 1]
    vae = BetaVAE(img_size=cfg.data.img_size,
                  in_channels=cfg.model.in_channels, latent_dim=latent_dim)
    vparams = (flax_init(vae, key, dev) if init is None
               else _cast(init["vae"], dev, torch.float32))
    tx = train.Adam(1e-3)
    opt_state = tx.init(vparams)
    n = images01.shape[0]

    def loss_fn(p, batch, noise):
        recon, mu, logvar = vae.apply(p, batch, noise=noise)
        return vae_loss(recon, batch, mu, logvar, beta)

    draws = as_draws(key, dev)
    vae_losses = []
    for i in range(vae_steps):
        kb, kr = draws.fold_in(i).split(2)
        batch = images01[kb.randint((128,), n)]
        loss, grads = train.value_and_grad(
            loss_fn, vparams, batch, kr.normal((128, latent_dim)))
        vparams, opt_state = tx.update(grads, opt_state, vparams)
        vae_losses.append(loss)
    with torch.no_grad():
        mu, _ = vae.encode(vparams, images01)
    mlp = vae_latent_mlp(latent_dim)
    mparams = (flax_init(mlp, key, dev) if init is None
               else _cast(init["mlp"], dev, torch.float32))
    mparams, diff_losses = train.train_expert(
        _subkey(key, 1), mlp.apply, mparams,
        DDPMSchedule(num_timesteps=VAE_LATENT_T), mu, (labels,),
        steps=diff_steps, batch_size=256, lr=1e-3, uncond_prob=0.1,
        null_labels=(10,), time_first=True,
        steps_per_scan=min(100, diff_steps))
    mgr = CheckpointManager(out, f"{cfg.name}_vae")
    path = mgr.save(name, {"vae": vparams, "mlp": mparams,
                           "latent_dim": latent_dim})
    return {"vae": vparams, "mlp": mparams,
            "vae_losses": torch.stack(vae_losses)
            if vae_losses else torch.zeros((0,), device=dev),
            "diff_losses": diff_losses, "path": path}


VAE_MODES = ("cfg", "weighted")


@torch.inference_mode()
def compose_latent_vae(preset: str = "mnist_image", name: str = "vae",
                       digits: Sequence[int] = (3, 5), mode: str = "cfg",
                       guidance: float = 2.0, bs: int = 16,
                       latent_dim: int = 10, seed: int = 42,
                       out: str = "outputs", overrides: Sequence[str] = (),
                       fused_blend: bool = True, z_init=None,
                       noise: Optional[torch.Tensor] = None,
                       device=None) -> torch.Tensor:
    """Composes the VAE's latent expert over ``digits`` and decodes: the
    path of ``scripts/compose_latent_vae.py`` on the checkpoint
    :func:`train_vae` saved as ``name``. Returns the float32 (bs, H, W, C)
    decoded images in (0, 1) and writes their grid (4 a row) to
    ``results/vae_composed_{mode}.png``.

    ``mode``: "cfg", classifier-free guidance of the one expert over the
    digit conditions against the null label 10, each weighted
    ``guidance`` (``samplers.make_cfg_eps_fn``: one forward of (K + 1) bs
    rows a step); "weighted", the K conditional forwards blended with unit
    weights, through the ``blend_eps`` kernel (``fused_blend=True``) or
    ``compose.weighted``. Then ancestral DDPM over ``DDPMSchedule(300)``
    without the clip, the integer timestep given to the expert as a
    float, and ``BetaVAE.decode``. The initial latents come from
    ``rng.Draws(seed)`` (``z_init`` in their place), the sampler's noise
    from a generator seeded with ``seed`` (``noise``: (300, bs,
    latent_dim)). ``device=None`` is the CUDA card."""
    if mode not in VAE_MODES:
        raise ValueError(f"mode must be one of {VAE_MODES}, got {mode!r}")
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    vae = BetaVAE(img_size=cfg.data.img_size,
                  in_channels=cfg.model.in_channels, latent_dim=latent_dim)
    mlp = vae_latent_mlp(latent_dim)
    mgr = CheckpointManager(out, f"{cfg.name}_vae")
    state = mgr.load(name, device=dev)
    vparams, mparams = (_cast(state[k], dev, torch.float32)
                        for k in ("vae", "mlp"))
    sde = DDPMSchedule(num_timesteps=VAE_LATENT_T)
    t_col = torch.arange(VAE_LATENT_T, dtype=torch.float32, device=dev)
    k = len(digits)
    if mode == "cfg":
        cfg_fn = make_cfg_eps_fn(
            lambda z, t, lab: mlp.apply(mparams, t, z, lab),
            [(d,) for d in digits], (10,),
            compose.constant([guidance] * k, torch.float32, dev))

        def eps_fn(z: torch.Tensor, ti: int) -> torch.Tensor:
            return cfg_fn(z, t_col[ti])
    else:
        labels = [torch.full((bs,), d, dtype=torch.long, device=dev)
                  for d in digits]
        w = compose.constant([1.0] * k, torch.float32, dev)
        blend = blend_eps if fused_blend else weighted

        def eps_fn(z: torch.Tensor, ti: int) -> torch.Tensor:
            return blend(torch.stack([mlp.apply(mparams, t_col[ti], z, lab)
                                      for lab in labels]), w)
    z = (Draws(seed, dev).normal((bs, latent_dim)) if z_init is None
         else torch.as_tensor(z_init, dtype=torch.float32).to(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = samplers.ddpm_ancestral(eps_fn, sde, gen, z, clip=None,
                                noise=None if noise is None
                                else noise.to(dev))
    imgs = vae.decode(vparams, z)
    viz.save_grid(imgs, os.path.join(mgr.results_dir,
                                     f"vae_composed_{mode}.png"), nrow=4)
    return imgs


# ------------------------------------------- the latent and 2-D experts
def fit_pca(preset: str = "mnist_latent2d", components: int = 2,
            out: str = "outputs", name: str = "pca",
            overrides: Sequence[str] = (), key=None,
            device=None) -> pca_codec.PCA:
    """Fits the PCA latent codec on a preset's dataset: the path of
    ``scripts/fit_pca.py``. The dataset comes from
    ``builders.build_dataset`` with the config's seed (``key``: an int or a
    ``rng.Draws`` in its place), the fit is ``ops.pca.fit_pca`` on the
    device, and ``ops.pca.save_pca`` writes ``<out>/<name>_mean.npy``,
    ``_components.npy`` and ``_explained_variance.npy``. Prints the
    explained variance as the script does and returns the codec on the
    device. ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    key = cfg.train.seed if key is None else key
    images, _ = build_dataset(cfg, key, dev)
    pca = pca_codec.fit_pca(images, components)
    os.makedirs(out, exist_ok=True)
    prefix = os.path.join(out, name)
    pca_codec.save_pca(prefix, pca)
    ev = [float(v) for v in pca.explained_variance]
    print(f"PCA({components}) fit on {images.shape[0]} examples; "
          f"explained variance {ev}; saved to {prefix}_*.npy")
    return pca


def train_latent_2d(preset: str = "mnist_latent2d",
                    pca: Union[pca_codec.PCA, str, None] = None,
                    classes: Optional[Sequence[int]] = None,
                    name: str = "latent_expert", out: str = "outputs",
                    overrides: Sequence[str] = (), key=None, init: Any = None,
                    device=None) -> Tuple[Any, torch.Tensor, str]:
    """Trains a 2-D PCA-latent ``ScoreMLP`` expert: the path of
    ``scripts/train_latent_2d.py``. The preset's dataset (``classes``
    restricts it where the dataset takes classes) is encoded by the codec
    (``pca``: a :class:`ops.pca.PCA` or the prefix of its files, default
    ``<out>/pca``), one ``matmul`` launch; the MLP is trained on the
    latents with ``train.train_expert`` (t first, chunks of min(200,
    steps)) under ``VPSchedule(kind=cfg.schedule.kind)``. Keys as the
    script's: the data and the initial tree from the config's seed
    (``key`` in its place; ``init``: a tree in place of the initial one),
    the training from ``fold_in(key, 1)``.

    Saves ``{name}_final`` ({"params", "step"}) under
    ``CheckpointManager(out, cfg.name)`` and the losses as
    ``results/{name}_loss.npy``; the script's latent scatter and loss plot
    need matplotlib and are not drawn. Returns (params, losses, checkpoint
    path), the tree on the device. No kernel runs in training.
    ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    if classes:
        cfg.data.classes = tuple(classes)
    key = cfg.train.seed if key is None else key
    schedule = VPSchedule(kind=cfg.schedule.kind)
    model = build_model(cfg)
    images, _ = build_dataset(cfg, key, dev)
    codec = load_pca(os.path.join(out, "pca") if pca is None else pca, dev)
    z = codec.encode(images)
    params = (init_params(model, key, dev) if init is None
              else _float_tree(init, model, dev))
    t = cfg.train
    params, losses = train.train_expert(
        _subkey(key, 1), model.apply, params, schedule, z, steps=t.steps,
        batch_size=t.batch_size, lr=t.lr, time_first=True,
        steps_per_scan=min(200, t.steps))
    mgr = CheckpointManager(out, cfg.name)
    path = mgr.save(name, {"params": params, "step": t.steps})
    np.save(os.path.join(mgr.results_dir, f"{name}_loss.npy"),
            losses.cpu().numpy())
    print(f"saved {path}  final_loss={float(losses[-1]):.4f}")
    return params, losses, path


def superposition_2d(steps: int = 20000, hidden: int = 512, bs: int = 512,
                     n_sample_steps: int = 1000,
                     out: str = "outputs/superposition_2d", seed: int = 0,
                     sanity: bool = False, key=None,
                     init: Optional[Sequence[Any]] = None,
                     probes: Optional[torch.Tensor] = None,
                     device=None) -> dict:
    """The 2-D SUPERDIFF teaching example end to end: the path of
    ``scripts/superposition_2d.py``. Two ``ScoreMLP(hidden, depth 4, 2)``
    experts trained on the up and down halves of the 4-Gaussian grid
    (``data.toy2d``, 65536 points each) under ``VPSchedule(kind=
    "jax_faithful")``, each with the script's negated closure (the net
    learns -eps) at batch ``bs``, lr 2e-4, t first, chunks of min(500,
    steps); then 512 points composed by ``samplers.superposition_2d`` over
    ``n_sample_steps`` with the per-expert log-likelihoods tracked.
    ``sanity`` cuts to the script's 500 training and 100 sampling steps.

    Keys as the script's: expert i's data, initial tree and training all
    from ``fold_in(seed, i)`` (i = 1 up, 2 down), the initial points and
    the sampler's probes from ``seed`` (``key`` in its place; ``init``: the
    two initial trees; ``probes``: (n_sample_steps, 512, 2) in place of the
    sampler's draws). Prints ``|ll1 - ll2|`` mean as the script does and
    writes the samples and log-likelihoods as ``.npy`` under ``out`` (the
    script's scatter plots need matplotlib). Returns {"samples": (512, 2),
    "ll": (2, 512), "experts": the two trees, "losses": theirs}; no kernel
    runs (``F.linear`` MLPs). ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    if sanity:
        steps, n_sample_steps = 500, 100
    key = seed if key is None else key
    sch = VPSchedule(kind="jax_faithful")
    m = ScoreMLP(hidden=hidden, depth=4, out_dim=2)
    os.makedirs(out, exist_ok=True)

    def train_one(k, up: bool, p0):
        pts = data.toy2d(k, 65536, up=up, device=dev)
        p = (flax_init(m, k, dev) if p0 is None
             else _cast(p0, dev, torch.float32))
        # the net learns sdlogqdx = -eps (the notebook's (eps + net)^2)
        return train.train_expert(
            k, lambda pp, t, x: -m.apply(pp, t, x), p, sch, pts,
            steps=steps, batch_size=bs, lr=2e-4, time_first=True,
            steps_per_scan=min(500, steps))

    trained = [train_one(_subkey(key, 1 + i), up,
                         None if init is None else init[i])
               for i, up in enumerate((True, False))]
    fns = tuple((lambda x, t, p=p: m.apply(p, t.expand(x.shape[0]), x))
                for p, _ in trained)
    draws = as_draws(key, dev)
    x_init = draws.normal((512, 2))
    with torch.no_grad():  # forward-mode AD: not inference_mode
        x, ll = samplers.superposition_2d(
            fns, sch, None if probes is not None else draws.generator(),
            x_init, n_sample_steps,
            probes=None if probes is None else probes.to(dev))
    np.save(os.path.join(out, "composed_and.npy"), x.cpu().numpy())
    np.save(os.path.join(out, "log_likelihoods.npy"), ll.cpu().numpy())
    print(f"2D superposition artifacts in {out}; |ll1 - ll2| mean = "
          f"{float((ll[0] - ll[1]).abs().mean()):.3f}")
    return {"samples": x, "ll": ll, "experts": [p for p, _ in trained],
            "losses": [loss for _, loss in trained]}


@torch.no_grad()  # not inference_mode: ito_kappa_ode runs forward-mode AD
def compose_images_ito(preset: str = "shapes_ddim",
                       shape_expert: str = "shape_expert",
                       color_expert: str = "color_expert",
                       n_steps: int = 1000, bs: int = 1,
                       probe: str = "gaussian", gray_protocol: str = "white",
                       out: str = "outputs", seed: int = 42,
                       overrides: Sequence[str] = (), x_init=None,
                       probes: Optional[torch.Tensor] = None,
                       device=None) -> torch.Tensor:
    """Ito-kappa (equal-density AND) composition of a 1-channel shape
    expert and a 3-channel color expert over the 3 x 3 label grid: the
    path of ``scripts/compose_images_ito.py``. The two class-conditional
    UNets (the preset's base and widths, 3 classes each, no null token) are
    read by name from ``CheckpointManager(out, cfg.name)``; the shape
    expert sees ``experts.rgb_to_gray(x)`` and its eps is lifted by
    ``gray_to_rgb`` (the unit-norm projection and its adjoint under
    ``gray_protocol="luma_norm"``, else plain luma and the channel
    broadcast); ``samplers.ito_kappa_ode`` on their sigma-scaled scores
    -eps over ``VPSchedule(kind=cfg.schedule.kind)``, ``n_steps`` steps,
    ``probe`` Hutchinson probes.

    Both experts run their GroupNorm in PyTorch ops (``fused_gn=False``)
    and no cross-attention: the divergence is a ``torch.func.jvp``
    through them, and the kernels have no forward-mode rule. Draws as the
    script's: combo (s, c)'s initial noise from ``fold_in(seed, 3 s + c)``
    and its probes from ``fold_in(seed, 100 + 3 s + c)`` (``x_init``: (9,
    bs, H, W, 3) and ``probes``: (9, n_steps, 2, bs, H, W, 3) in their
    place). Writes ``results/ito_composition_grid.png`` (3 bs a row) and
    returns the (9 bs, H, W, 3) float32 samples, combos in row-major
    order. ``device=None`` is the CUDA card."""
    if gray_protocol not in GRAY_PROTOCOLS:
        raise ValueError(f"gray_protocol must be one of {GRAY_PROTOCOLS}, "
                         f"got {gray_protocol!r}")
    dev = resolve_device(device)
    cfg = get_config(preset, overrides)
    schedule = VPSchedule(kind=cfg.schedule.kind)
    size = cfg.data.img_size
    mgr = CheckpointManager(out, cfg.name)
    shape_model, color_model = (
        UNet(in_channels=ch, base_dim=cfg.model.base_dim,
             channel_mults=tuple(cfg.model.channel_mults), num_classes=(3,))
        for ch in (1, 3))
    sp, cp = (_float_tree(mgr.load(n, device=dev)["params"], shape_model,
                          dev) for n in (shape_expert, color_expert))
    normalized = gray_protocol == "luma_norm"
    grids = []
    for s_lab in range(3):
        for c_lab in range(3):
            i = 3 * s_lab + c_lab
            sl = torch.full((bs,), s_lab, dtype=torch.long, device=dev)
            cl = torch.full((bs,), c_lab, dtype=torch.long, device=dev)

            def shape_score(x, t, sl=sl):
                return -gray_to_rgb(shape_model.apply(
                    sp, rgb_to_gray(x, normalized), t, sl), normalized)

            def color_score(x, t, cl=cl):
                return -color_model.apply(cp, x, t, cl)

            x = (Draws(fold_in(seed, i), dev).normal((bs, size, size, 3))
                 if x_init is None else torch.as_tensor(
                     x_init[i], dtype=torch.float32).to(dev))
            gen = (Draws(fold_in(seed, 100 + i), dev).generator()
                   if probes is None else None)
            grids.append(samplers.ito_kappa_ode(
                (shape_score, color_score), schedule, gen, x, n_steps,
                probe=probe,
                probes=None if probes is None else probes[i].to(dev)))
    samples = torch.cat(grids)
    path = os.path.join(mgr.results_dir, "ito_composition_grid.png")
    viz.save_grid(samples, path, nrow=3 * bs)
    print(f"Ito-kappa composition grid saved to {path}")
    return samples


# ------------------------------------------------------------ CIFAR split
CIFAR_SPLITS = (tuple(range(5)), tuple(range(5, 10)))


def _cifar_stats(probe, probe_params, samples: torch.Tensor) -> dict:
    """The script's ``probe_stats``: the 10-class histogram, the share on
    the first split (classes 0-4) and the mean top probability."""
    with torch.no_grad():
        probs = torch.softmax(probe.apply(probe_params, samples)[0], dim=-1)
    maxp, preds = probs.max(dim=-1)
    hist = torch.bincount(preds, minlength=10).float() / preds.shape[0]
    return {"class_hist": [round(float(h), 4) for h in hist],
            "frac_split_a": float((preds < 5).float().mean()),
            "mean_max_prob": float(maxp.mean())}


def compose_cifar(T: int = 1000, train_steps: int = 12000,
                  batch_size: int = 256, lr: float = 2e-4, ema: float = 0.999,
                  base_dim: int = 64, temp: float = 1.0,
                  probe_steps: int = 2000, n_samples: int = 64,
                  data_n: int = 8192, data_dir: Optional[str] = None,
                  sanity: bool = False, out: str = "outputs/cifar_split",
                  seed: int = 0, experts: Optional[Sequence[Any]] = None,
                  key=None, device=None) -> dict:
    """The CIFAR-10 class-split SUPERDIFF composition of
    ``scripts/compose_cifar.py``, on the device (``None``: the CUDA card).
    Returns the report it writes to ``out/cifar_split_composition.json``.

    1. CIFAR-10's binary batches from ``data_dir`` (or where
       ``data.load_cifar10`` finds them); where there are none, the
       procedural stand-in (``data.synthetic_cifar10``, key fold_in(key,
       1), ``data_n`` images) written as binary batches under
       ``out/cifar-10-batches-bin`` and read back through the same reader.
    2. A 10-class probe (bf16, noise-augmented at 0.1) trained
       ``probe_steps`` with fold_in(key, 2).
    3. Two unconditional 3-channel UNets of base ``base_dim``, widths
       (1, 2, 4) x base, float32, on the classes {0-4} and {5-9}: the tree
       drawn with fold_in(key, 10 + i), trained with fold_in(key, 20 + i)
       on ``DDPMSchedule(T)`` (Adam at ``lr``, EMA ``ema``; 0: off);
       ``experts``: the two trees, to skip the training.
    4. ``n_samples`` of each expert solo by ancestral DDPM and of the pair
       by SUPERDIFF OR at ``temp``, each job keyed fold_in(key, 50) (its
       initial noise from fold_in of that key with 1, its steps' draws from
       a generator seeded from it); samples clipped to [-1, 1]; per set the
       probe's class histogram, the share on the first split and the mean
       top probability; ``or_mixture_balance_error`` = |0.5 - the OR
       share|.
    5. The grids ``cifar_solo_A.png``, ``cifar_solo_B.png``,
       ``cifar_superdiff_OR.png`` (64 samples, 8 a row) and
       ``cifar_comparison.png`` (the first 16 of each, 16 a row).

    ``key`` defaults to ``seed``; a ``rng.Replay`` replays the draws.
    ``sanity`` cuts the sizes as the script's ``--sanity`` does. The
    experts sample with their GroupNorm + SiLU through the
    ``groupnorm_silu`` kernel (training runs none)."""
    dev = resolve_device(device)
    from .eval_superdiff import start  # it imports this module
    if sanity:
        train_steps, probe_steps, T = 40, 40, 8
        n_samples, data_n, base_dim = 8, 320, 8
        batch_size = 16
    key = seed if key is None else key
    os.makedirs(out, exist_ok=True)
    loaded = data.load_cifar10(data_dir, device=dev)
    standin = loaded is None
    if standin:
        raw, lab = data.synthetic_cifar10(_subkey(key, 1), data_n, device=dev)
        bin_dir = data.write_cifar10_binaries(
            raw, lab, os.path.join(out, "cifar-10-batches-bin"))
        loaded = data.load_cifar10(bin_dir, device=dev)
    imgs, labels = loaded
    imgs, labels = imgs[:data_n], labels[:data_n]
    probe, probe_params = ceval.train_probe(
        _subkey(key, 2), imgs, (labels,), num_classes=(10,),
        steps=probe_steps, noise_aug=0.1)
    schedule = DDPMSchedule(num_timesteps=T)
    model = UNet(in_channels=3, base_dim=base_dim, channel_mults=(1, 2, 4))
    if experts is None:
        experts = []
        for i, split in enumerate(CIFAR_SPLITS):
            mask = torch.isin(labels, torch.tensor(split, device=dev))
            p, _ = train.train_expert(
                _subkey(key, 20 + i), model.apply,
                init_params(model, _subkey(key, 10 + i), dev), schedule,
                imgs[mask], steps=train_steps, batch_size=batch_size, lr=lr,
                ema_decay=ema or None)
            experts.append(p)
    params = [_float_tree(p, model, dev) for p in experts]
    served = dataclasses.replace(model, fused_gn=True)
    stacks = [_ddpm_stack_fn(ExpertStack(served.apply, ps), T, [], dev,
                             torch.float32)
              for ps in ([params[0]], [params[1]], params)]
    shape = (n_samples,) + tuple(imgs.shape[1:])

    def solo(stack):
        def job(k):
            x, gen, noise = start(k, shape, (T,) + shape, dev)
            return samplers.ddpm_ancestral(lambda x_, ti: stack(x_, ti)[0],
                                           schedule, gen, x, noise=noise)
        return job

    def superdiff_or(k):
        x, gen, noise = start(k, shape, (T,) + shape, dev)
        return samplers.superdiff(stacks[2], schedule, gen, x,
                                  operation="OR", temp=temp, noise=noise)

    report = {"dataset": ("procedural stand-in (synthetic_cifar10, via the "
                          "binary-batch parse path)" if standin
                          else "real CIFAR-10 binaries"),
              "splits": [list(s) for s in CIFAR_SPLITS], "T": T,
              "train_steps": train_steps, "sets": {}}
    grids = []
    for name, job in (("solo_A", solo(stacks[0])), ("solo_B", solo(stacks[1])),
                      ("superdiff_OR", superdiff_or)):
        with torch.inference_mode():
            samples = job(_subkey(key, 50)).clamp(-1.0, 1.0)
        report["sets"][name] = _cifar_stats(probe, probe_params, samples)
        grids.append(samples[:16])
        viz.save_grid(samples[:64], os.path.join(out, f"cifar_{name}.png"),
                      nrow=8)
    viz.save_grid(torch.cat(grids), os.path.join(out, "cifar_comparison.png"),
                  nrow=16)
    report["or_mixture_balance_error"] = abs(
        0.5 - report["sets"]["superdiff_OR"]["frac_split_a"])
    with open(os.path.join(out, "cifar_split_composition.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report
