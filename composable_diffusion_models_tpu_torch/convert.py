"""Weight bridge: flax parameter trees <-> torch tensors, and numpy init.

A flax tree is a nested dict of arrays. ``from_flax`` keeps every key path
and every shape as flax stores it: Dense kernels (in, out), the patchify
Conv kernel HWIO, the stock attention's per-head (D, H, hd) kernels. The
model code reshapes them where the JAX package does (``models/dit.py``), so
one converted tree serves both attention layouts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .models.dit import DiT


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


def param_shapes(cfg: DiT) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], int]]:
    """{key path: (shape, fan_in)} of ``DiT.init``'s tree under "params"."""
    d, p, c = cfg.dim, cfg.patch, cfg.in_channels
    hd = d // cfg.n_heads
    mlp = 4 * d
    out: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], int]] = {}

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


def init_params(cfg: DiT, seed: int) -> Dict[str, Any]:
    """Random float32 numpy tree with ``DiT.init``'s key paths and shapes.

    Kernels are N(0, 1/fan_in); biases and the positional embedding
    N(0, 0.02^2); label embeddings N(0, 1). Nothing is zero: the flax init
    zeroes the adaLN and head weights, which makes an untrained DiT the zero
    function and every parity check between two ports trivially true."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {}
    for path, (shape, fan_in) in param_shapes(cfg).items():
        std = 1.0 / math.sqrt(fan_in) if fan_in else 0.02
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (rng.standard_normal(shape) * std).astype(np.float32)
    return {"params": params}
