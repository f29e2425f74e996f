"""Kernels of the serving path and their plain versions."""

from .kernels import (fused_dit_block, fused_dit_block_ref,
                      short_seq_attention, short_seq_attention_ref)

__all__ = ["fused_dit_block", "fused_dit_block_ref", "short_seq_attention",
           "short_seq_attention_ref"]
