"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes of the fused DiT block kernel (K1), and the model FLOPs of a
composed-DiT sampler call as the folded serving path computes them.

Frozen copies: later changes to the program do not move them.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates without sparsity, at the full 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def k1_flops(b: int, t: int, d: int) -> float:
    """One fused DiT block over (B, T, D): the q, k, v and out projections
    (4 T D^2 MACs an image), the MLP of width 4D (8 T D^2), and the two
    attention products (2 T^2 D); MACs x 2."""
    return 2.0 * b * t * 12 * d * d + 4.0 * b * t * t * d


def k1_bytes(b: int, t: int, d: int) -> float:
    """The block's least traffic to memory in bf16: the (B, T, D) stream
    read once and written once, the four folded weights (12 D^2) and their
    nine D of biases read once, 2 bytes an element."""
    return 2.0 * (2.0 * b * t * d + 12.0 * d * d + 9.0 * d)


def k1_bound_s(b: int, t: int, d: int) -> float:
    """The least time one bf16 launch could take on the card: the larger
    of its operations at the bf16 peak and its bytes at the HBM rate."""
    return max(k1_flops(b, t, d) / PEAK_BF16_FLOPS,
               k1_bytes(b, t, d) / HBM_BYTES_PER_S)


def n_tokens(model: dict) -> int:
    return (model["img_size"] // model["patch"]) ** 2


def dit_image_macs(model: dict) -> float:
    """MACs of one DiT forward per image with N tokens of width D: per
    block 12 N D^2 (projections and an MLP of width 4D) + 2 N^2 D
    (attention), and 2 N D P^2 C for patchify and the head. The time and
    label towers and the elementwise work are left out."""
    n, d = n_tokens(model), model["dim"]
    mlp = model["mlp_ratio"]
    per_block = (4 + 2 * mlp) * n * d * d + 2 * n * n * d
    patch = n * d * model["patch"] ** 2 * model["in_channels"]
    return model["depth"] * per_block + 2 * patch


def dit_step_macs(model: dict) -> float:
    """MACs of an expert's adaLN modulation a step: the folded path
    computes each block's six D-vectors once for the whole batch (6 D^2
    a block), not once an image."""
    return model["depth"] * 6.0 * model["dim"] ** 2


def sample_flops(model: dict, n_experts: int, batch: int,
                 n_steps: int) -> float:
    """Model FLOPs of one composed sampler call: every expert's forward
    over the batch at every step, and its modulation once a step."""
    return 2.0 * n_steps * n_experts * (batch * dit_image_macs(model)
                                        + dit_step_macs(model))
