"""The experts' weights, made from the seed on the device.

The tree has the layout of the flax ``DiT``'s parameters, the layout that
the port's ``entry.sample`` and the plain reference both read: nested
dicts under ``"params"``, kernels stored (fan_in, ...) as flax stores them.
Every leaf is random: kernels N(0, 1/fan_in), biases and the positional
embedding N(0, 0.02^2), label embeddings N(0, 1). The DiT's own init zeroes
the adaLN modulation and the head, which makes an untrained DiT the zero
function and any comparison of two implementations blind.

All experts' leaves come from one ``torch.randn`` over one flat buffer, on
a generator on the target device, scaled by one per-element product and
cast once to the served dtype; each leaf is a view of that buffer, its
offset a multiple of 8 elements (16 bytes in bfloat16).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_ALIGN = 8


def leaf_specs(model: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...],
                                          float]]:
    """(path, shape, std) of every leaf of one expert's tree, for a model
    section of a configuration file (``patch``, ``dim``, ``depth``,
    ``n_heads``, ``mlp_ratio``, ``in_channels``, ``img_size``,
    ``num_classes``, ``null_token``, ``qkv_fused``)."""
    d, p, c = model["dim"], model["patch"], model["in_channels"]
    h = model["n_heads"]
    hd = d // h
    f = model["mlp_ratio"] * d
    n_tok = (model["img_size"] // p) ** 2
    specs = []

    def dense(prefix, fan_in, fan_out):
        specs.append((prefix + ("kernel",), (fan_in, fan_out),
                      1.0 / math.sqrt(fan_in)))
        specs.append((prefix + ("bias",), (fan_out,), 0.02))

    dense(("TimeEmbedding_0", "Dense_0"), d, d)
    dense(("TimeEmbedding_0", "Dense_1"), d, d)
    for i, n in enumerate(model["num_classes"]):
        rows = n + (1 if model["null_token"] else 0)
        specs.append(((f"label_emb_{i}", "embedding"), (rows, d), 1.0))
    specs.append((("patchify", "kernel"), (p, p, c, d),
                  1.0 / math.sqrt(p * p * c)))
    specs.append((("patchify", "bias"), (d,), 0.02))
    specs.append((("pos_emb",), (1, n_tok, d), 0.02))
    for i in range(model["depth"]):
        b = f"block_{i}"
        dense((b, "Dense_0"), d, 6 * d)
        dense((b, "Dense_1"), d, f)
        dense((b, "Dense_2"), f, d)
        if model["qkv_fused"]:
            a = (b, "FusedQKVAttention_0")
            dense(a + ("qkv",), d, 3 * d)
            dense(a + ("proj",), d, d)
        else:
            a = (b, "MultiHeadDotProductAttention_0")
            for name in ("query", "key", "value"):
                specs.append((a + (name, "kernel"), (d, h, hd),
                              1.0 / math.sqrt(d)))
                specs.append((a + (name, "bias"), (h, hd), 0.02))
            specs.append((a + ("out", "kernel"), (h, hd, d),
                          1.0 / math.sqrt(d)))
            specs.append((a + ("out", "bias"), (d,), 0.02))
    dense(("final_mod",), d, 2 * d)
    dense(("unpatchify",), d, p * p * c)
    return specs


def make_experts(model: dict, n_experts: int, seed: int, device,
                 dtype: torch.dtype) -> List[Dict]:
    """``n_experts`` parameter trees ``{"params": {...}}`` on ``device`` in
    ``dtype``, drawn from ``seed`` (the same seed gives the same bits on
    the same kind of device)."""
    specs = leaf_specs(model)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    padded = [-(-n // _ALIGN) * _ALIGN for n in sizes]
    per_expert = sum(padded)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    std = torch.repeat_interleave(
        torch.tensor([s for _, _, s in specs] * n_experts, dtype=torch.float32,
                     device=dev),
        torch.tensor(padded * n_experts, device=dev))
    flat = (torch.randn(per_expert * n_experts, generator=gen, device=dev,
                        dtype=torch.float32) * std).to(dtype)
    trees = []
    for e in range(n_experts):
        tree: Dict = {}
        offset = e * per_expert
        for (path, shape, _), n, n_pad in zip(specs, sizes, padded):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = flat[offset:offset + n].view(shape)
            offset += n_pad
        trees.append({"params": tree})
    return trees

