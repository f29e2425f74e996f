"""Sequence/context parallelism: ring attention over a sharded token axis.

Port of ``composable_diffusion_models_tpu.parallel.sp``. The token axis of
(B, H, N, D) attention is sharded over a 'seq' mesh axis; exact softmax
attention comes from K/V shards rotating around the ring
(:func:`mesh.ppermute_grad`), each hop merged into a running float32
online-softmax state (max m, denominator l, accumulator acc): the
recurrence of the flash kernel, lifted one level. Memory per rank is
O(N / S x D); no rank holds the whole logits or K/V. Plain PyTorch ops, as
the JAX module is plain ``jnp``; the rotation's backward sends the
gradients back, so the ring works under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import axis_size, ppermute_grad


def make_ring_attention(mesh, axis: str = "seq",
                        scale: Optional[float] = None):
    """Build ``fn(q, k, v) -> out``: q, k, v are this rank's (B, H, N / S, D)
    shards of the token axis over ``axis`` (queries stay; K/V take S - 1
    hops); the output is this rank's shard, in q's dtype."""
    s = axis_size(mesh, axis)

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        sc = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
        qf = q.float() * sc
        b, h, nq, d = q.shape
        m = torch.full((b, h, nq, 1), -torch.inf, device=q.device)
        l = torch.zeros((b, h, nq, 1), device=q.device)
        acc = torch.zeros((b, h, nq, d), device=q.device)
        for hop in range(s):
            logits = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v.float())
            m = m_new
            if hop < s - 1:  # the last hop's rotation feeds nothing
                k, v = ppermute_grad([k, v], mesh, axis)
        return (acc / l).to(q.dtype)

    return fn
