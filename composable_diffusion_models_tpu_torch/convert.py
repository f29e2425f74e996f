"""Weight bridge: flax parameter trees <-> torch tensors, random trees for
parity tests (``init_params``), the flax modules' own init distribution for
training (``flax_init``), and optax's Adam state (``adam_from_optax``).

A flax tree is a nested dict of arrays. ``from_flax`` keeps every key path
and every shape as flax stores it: Dense kernels (in, out), Conv kernels
HWIO, the stock attention's per-head (D, H, hd) kernels. The DiT code
reshapes them where the JAX package does (``models/dit.py``), so one
converted tree serves both attention layouts. The UNet's convolutions want
OIHW weights: ``unet_torch_layout`` transposes them once, at load.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .models.dit import DiT
from .models.mlp import LatentDiffusionMLP, ScoreMLP
from .models.probe import ProbeClassifier
from .models.unet import UNet
from .models.vae import BetaVAE
from .ops.pca import PCA
from .rng import as_draws

Shapes = Dict[Tuple[str, ...], Tuple[Tuple[int, ...], int]]


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16 (ml_dtypes supplies it); widening to fp32
        # and narrowing back is exact
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)  # a copy: the tree's arrays may be read-only


def from_flax(tree: Any) -> Any:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) ->
    the same nested dict of CPU torch tensors, same keys, shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: from_flax(v) for k, v in tree.items()}
    return _to_tensor(tree)


def unet_torch_layout(tree: Any) -> Any:
    """A UNet tree of torch tensors with every convolution kernel (a 4-D
    ``kernel`` leaf, HWIO) replaced by a ``weight`` leaf in ``F.conv2d``'s
    OIHW order, channels-last in memory. Everything else is kept. Done once
    at load; applying it to its own result changes nothing."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for key, val in tree.items():
        if key == "kernel" and not isinstance(val, dict) and val.dim() == 4:
            out["weight"] = val.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        else:
            out[key] = unet_torch_layout(val)
    return out


def param_shapes(cfg) -> Shapes:
    """{key path: (shape, fan_in)} of the flax module's ``init`` tree under
    "params", for a :class:`DiT`, :class:`UNet`, :class:`ScoreMLP`,
    :class:`LatentDiffusionMLP`, :class:`ProbeClassifier` or
    :class:`BetaVAE` configuration."""
    if isinstance(cfg, UNet):
        return _unet_shapes(cfg)
    if isinstance(cfg, BetaVAE):
        return _vae_shapes(cfg)
    if isinstance(cfg, (ScoreMLP, LatentDiffusionMLP)):
        return _mlp_shapes(cfg)
    if isinstance(cfg, ProbeClassifier):
        return _probe_shapes(cfg)
    return _dit_shapes(cfg)


def _probe_shapes(cfg: ProbeClassifier) -> Shapes:
    out: Shapes = {}
    cin = cfg.in_channels
    for i, mult in enumerate((1, 2, 4)):
        cout = cfg.base_dim * mult
        out[(f"conv_{i}", "kernel")] = ((3, 3, cin, cout), 9 * cin)
        out[(f"conv_{i}", "bias")] = ((cout,), 0)
        cin = cout
    out[("Dense_0", "kernel")] = ((cin, 128), cin)
    out[("Dense_0", "bias")] = ((128,), 0)
    for i, n in enumerate(cfg.num_classes):
        out[(f"head_{i}", "kernel")] = ((128, n), 128)
        out[(f"head_{i}", "bias")] = ((n,), 0)
    return out


def _vae_shapes(cfg: BetaVAE) -> Shapes:
    """``enc_convs_i`` (stride 2), ``fc_mu`` / ``fc_logvar`` over the
    flattened s x s x C features, ``dec_dense`` back to them,
    ``dec_convs_i`` over the reversed widths, ``dec_out``."""
    out: Shapes = {}

    def layer(name, shape, fan_in):
        out[(name, "kernel")] = (shape, fan_in)
        out[(name, "bias")] = ((shape[-1],), 0)

    cin = cfg.in_channels
    for i, m in enumerate(cfg.channel_mults):
        layer(f"enc_convs_{i}", (3, 3, cin, cfg.base_dim * m), 9 * cin)
        cin = cfg.base_dim * m
    feat = cfg.feat_size ** 2 * cfg.feat_channels
    layer("fc_mu", (feat, cfg.latent_dim), feat)
    layer("fc_logvar", (feat, cfg.latent_dim), feat)
    layer("dec_dense", (cfg.latent_dim, feat), cfg.latent_dim)
    cin = cfg.feat_channels
    for i, m in enumerate(reversed(cfg.channel_mults)):
        layer(f"dec_convs_{i}", (3, 3, cin, cfg.base_dim * m), 9 * cin)
        cin = cfg.base_dim * m
    layer("dec_out", (3, 3, cin, cfg.in_channels), 9 * cin)
    return out


def _mlp_shapes(cfg) -> Shapes:
    """``Dense_0..Dense_depth`` and, for the latent MLP, one
    ``label_emb_i/embedding`` per slot (one more row with the null token).
    The ScoreMLP's input is concat(t, x) with x as wide as the output; the
    latent MLP's is concat(z, t embedding, label embeddings)."""
    out: Shapes = {}
    if isinstance(cfg, ScoreMLP):
        fin, fout = 1 + cfg.out_dim, cfg.out_dim
    else:
        fin = cfg.latent_dim + cfg.time_emb_dim * (1 + len(cfg.num_classes))
        fout = cfg.latent_dim
        for i, n in enumerate(cfg.num_classes):
            out[(f"label_emb_{i}", "embedding")] = (
                (n + (1 if cfg.null_token else 0), cfg.time_emb_dim), 1)
    for i in range(cfg.depth + 1):
        width = fout if i == cfg.depth else cfg.hidden
        out[(f"Dense_{i}", "kernel")] = ((fin, width), fin)
        out[(f"Dense_{i}", "bias")] = ((width,), 0)
        fin = width
    return out


def _unet_shapes(cfg: UNet) -> Shapes:
    """flax's auto-names: ``TimeEmbedding_0/Dense_{0,1}``,
    ``label_emb_i/embedding``, ``init_conv``, ``down_i|bottleneck|up_i/
    {gn1, gn2, Conv_0, Conv_1, Conv_2, Dense_0}``, ``*_attn*/{LayerNorm_0,
    Dense_0..3}``, ``out_conv``."""
    out: Shapes = {}
    emb = cfg.time_emb_dim

    def dense(path, fin, fout, bias=True):
        out[path + ("kernel",)] = ((fin, fout), fin)
        if bias:
            out[path + ("bias",)] = ((fout,), 0)

    def conv(path, k, cin, cout):
        out[path + ("kernel",)] = ((k, k, cin, cout), k * k * cin)
        out[path + ("bias",)] = ((cout,), 0)

    def norm(path, c):
        out[path + ("scale",)] = ((c,), 0)
        out[path + ("bias",)] = ((c,), 0)

    def res_block(name, cin, cout):
        norm((name, "gn1"), cin)
        conv((name, "Conv_0"), 3, cin, cout)
        dense((name, "Dense_0"), emb, cout)
        norm((name, "gn2"), cout)
        conv((name, "Conv_1"), 3, cout, cout)
        if cin != cout:
            conv((name, "Conv_2"), 1, cin, cout)

    def attention(name, c):
        if not (cfg.cross_attn and cfg.num_classes):
            return
        norm((name, "LayerNorm_0"), c)
        dense((name, "Dense_0"), c, c, bias=False)
        dense((name, "Dense_1"), emb, c, bias=False)
        dense((name, "Dense_2"), emb, c, bias=False)
        dense((name, "Dense_3"), c, c)

    dense(("TimeEmbedding_0", "Dense_0"), cfg.base_dim, emb)
    dense(("TimeEmbedding_0", "Dense_1"), emb, emb)
    vocab_extra = 1 if cfg.null_token else 0
    for i, n in enumerate(cfg.num_classes):
        out[(f"label_emb_{i}", "embedding")] = ((n + vocab_extra, emb), 1)
    widths = [cfg.base_dim * m for m in cfg.channel_mults]
    n_levels = len(widths) - 1
    conv(("init_conv",), 3, cfg.in_channels, widths[0])
    ch = widths[0]
    for i in range(n_levels):
        res_block(f"down_{i}", ch, widths[i])
        attention(f"down_attn_{i}", widths[i])
        ch = widths[i]
    res_block("bottleneck", ch, widths[-1])
    attention("bot_attn", widths[-1])
    ch = widths[-1]
    for i in reversed(range(n_levels)):
        res_block(f"up_{i}", ch + widths[i], widths[i])
        attention(f"up_attn_{i}", widths[i])
        ch = widths[i]
    conv(("out_conv",), 1, ch, cfg.out_channels or cfg.in_channels)
    return out


def _dit_shapes(cfg: DiT) -> Shapes:
    d, p, c = cfg.dim, cfg.patch, cfg.in_channels
    hd = d // cfg.n_heads
    mlp = 4 * d
    out: Shapes = {}

    def dense(path, fin, fout):
        out[path + ("kernel",)] = ((fin, fout), fin)
        out[path + ("bias",)] = ((fout,), 0)

    dense(("TimeEmbedding_0", "Dense_0"), d, d)
    dense(("TimeEmbedding_0", "Dense_1"), d, d)
    vocab_extra = 1 if cfg.null_token else 0
    for i, n in enumerate(cfg.num_classes):
        out[(f"label_emb_{i}", "embedding")] = ((n + vocab_extra, d), 1)
    out[("patchify", "kernel")] = ((p, p, c, d), p * p * c)
    out[("patchify", "bias")] = ((d,), 0)
    out[("pos_emb",)] = ((1, cfg.n_tokens, d), 0)
    for b in range(cfg.depth):
        blk = (f"block_{b}",)
        dense(blk + ("Dense_0",), d, 6 * d)
        dense(blk + ("Dense_1",), d, mlp)
        dense(blk + ("Dense_2",), mlp, d)
        if cfg.qkv_fused:
            dense(blk + ("FusedQKVAttention_0", "qkv"), d, 3 * d)
            dense(blk + ("FusedQKVAttention_0", "proj"), d, d)
        else:
            a = blk + ("MultiHeadDotProductAttention_0",)
            for k in ("query", "key", "value"):
                out[a + (k, "kernel")] = ((d, cfg.n_heads, hd), d)
                out[a + (k, "bias")] = ((cfg.n_heads, hd), 0)
            out[a + ("out", "kernel")] = ((cfg.n_heads, hd, d), d)
            out[a + ("out", "bias")] = ((d,), 0)
    dense(("final_mod",), d, 2 * d)
    dense(("unpatchify",), d, p * p * c)
    return out


def init_params(cfg, seed: int) -> Dict[str, Any]:
    """Random float32 numpy tree with the key paths and shapes of the flax
    module's ``init`` (any configuration :func:`param_shapes` takes).

    Kernels are N(0, 1/fan_in); biases and the positional embedding
    N(0, 0.02^2); label embeddings N(0, 1); norm scales 1 + N(0, 0.1^2).
    Nothing is zero: the flax init zeroes every bias and the DiT's adaLN
    and head weights, which makes an untrained DiT the zero function and a
    parity check between two ports blind to a dropped bias."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    for path, (shape, fan_in) in param_shapes(cfg).items():
        noise = rng.standard_normal(shape)
        if path[-1] == "scale":
            val = 1.0 + 0.1 * noise
        else:
            val = noise * (1.0 / math.sqrt(fan_in) if fan_in else 0.02)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val.astype(np.float32)
    return {"params": params}


# the DiT's adaLN-Zero leaves: zero at init, so the network is the zero
# function (the flax module's kernel_init=zeros)
_ZERO_KERNELS = {"Dense_0", "final_mod", "unpatchify"}


def flax_init(cfg, key, device="cpu") -> Dict[str, Any]:
    """A float32 tree distributed as the flax module's ``init`` makes it, for
    any configuration :func:`param_shapes` takes, drawn through
    ``rng.Draws(key, device)`` (``key`` an int, or a ``rng.Draws`` itself)
    one leaf at a time in sorted key-path order: kernels lecun-normal
    (N(0, 1/fan_in) truncated at two of its standard deviations, rescaled
    as flax's ``variance_scaling`` does), biases zero, norm scales one (no
    draw for either), label embeddings N(0, 1/width), the DiT's positions
    N(0, 0.02^2) and its adaLN modulation and unpatchify kernels zero. The
    bits are not flax's: the two frameworks draw differently. UNet
    convolution kernels come out HWIO, as flax stores them
    (``unet_torch_layout`` turns them for ``UNet.apply``). The tree lies on
    the draws' device."""
    if not isinstance(cfg, (DiT, UNet, ProbeClassifier, ScoreMLP,
                            LatentDiffusionMLP, BetaVAE)):
        raise TypeError(f"flax_init covers DiT, UNet, ProbeClassifier, the "
                        f"MLPs and BetaVAE, got {type(cfg).__name__}")
    draws = as_draws(key, device)
    device = draws.device
    params: Dict[str, Any] = {}
    for path, (shape, fan_in) in sorted(param_shapes(cfg).items()):
        zero = path[-1] == "bias" or (
            isinstance(cfg, DiT) and path[-1] == "kernel"
            and path[-2] in _ZERO_KERNELS)
        if zero:
            val = torch.zeros(shape, device=device)
        elif path[-1] == "scale":
            val = torch.ones(shape, device=device)
        elif path[-1] == "embedding":
            val = draws.normal(shape) / math.sqrt(shape[-1])
        elif path[-1] == "pos_emb":
            val = draws.normal(shape) * 0.02
        else:
            # jax.random.truncated_normal(-2, 2) by the inverse CDF, times
            # sqrt(1/fan_in) / 0.8796 (the truncated unit normal's std)
            lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
            z = math.sqrt(2) * torch.erfinv(draws.uniform(shape, lo, hi))
            val = z.clamp(-2.0, 2.0) * (
                math.sqrt(1.0 / fan_in) / 0.87962566103423978)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return {"params": params}


def adam_from_optax(count, mu, nu) -> Dict[str, Any]:
    """The port's Adam state (``train.adam_init``'s form) from an optax
    ``ScaleByAdamState``'s fields as numpy: the step ``count`` and the two
    moment trees, which keep the parameters' key paths."""
    return {"count": torch.tensor(int(np.asarray(count)), dtype=torch.int32),
            "mu": from_flax(mu), "nu": from_flax(nu)}


def pca_from_numpy(mean, components, explained_variance):
    """The PCA codec (``ops.pca.PCA``) of three arrays as the JAX package's
    ``PCA`` holds them (or as ``save_pca`` wrote them): mean (D,),
    components (k, D), explained variance (k,), as float32 CPU tensors."""
    return PCA(*(_to_tensor(np.asarray(a, dtype=np.float32))
                 for a in (mean, components, explained_variance)))
