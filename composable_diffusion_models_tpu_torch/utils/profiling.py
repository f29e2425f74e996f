"""Profiling hooks: a trace of a block and named regions inside it.

Port of ``composable_diffusion_models_tpu.utils.profiling``:
:func:`maybe_profile` runs ``torch.profiler.profile`` over the block (CPU
activity, and CUDA where a card is present) and exports a Chrome trace
into ``out_dir``; :func:`annotate` is ``torch.profiler.record_function``.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def maybe_profile(enabled: bool, out_dir: str = "outputs/profile"):
    """Trace the enclosed block into ``out_dir/trace.json`` when enabled;
    yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def annotate(name: str):
    """A named region inside a profile."""
    return torch.profiler.record_function(name)
