"""Profiling hooks: a trace of a block and named regions inside it.

Port of ``composable_diffusion_models_tpu.utils.profiling``:
:func:`maybe_profile` runs ``torch.profiler.profile`` over the block (CPU
activity, and CUDA where a card is present) and exports a Chrome trace
into ``out_dir``; :func:`annotate` opens a named range while a profiler
records, and costs one check while none does.

The spans the DiT sampling path opens, named ``cdm.<layer>`` (a name never
holds ``cdm::``, the prefix of the port's kernels), each a range of the
kineto trace on the device records' clock:

* ``cdm.sample``: ``entry.sample``, the whole call; its self time is the
  call's prelude (the casts of ``load_experts``, the stack, the schedule's
  table) and epilogue;
* ``cdm.ddim.step``: one step of ``samplers.ddim``; its self time holds
  the closure's casts and the expert stack's ``torch.stack`` / ``.float()``;
* ``cdm.ddim.update``: the step's x0, clamp and update (and corrector);
* ``cdm.blend``: ``compose.weighted``;
* ``cdm.dit.embed``, ``cdm.dit.fold``, ``cdm.dit.block``, ``cdm.dit.head``:
  ``models.dit.make_folded_apply``'s time and label embedding with the
  patchify, one block's adaLN fold (its modulation GEMV and scaled weights
  and biases), the block itself (K1, or the unfused route's ops), and the
  final adaLN with the float32 head.

A sampler whose steps were captured into a CUDA graph (ROADMAP item B)
could keep ``cdm.sample`` and ``cdm.ddim.step``, which the host still runs
around each replay; a replay records none of the spans inside a step
(``cdm.dit.*``, ``cdm.blend``, ``cdm.ddim.update``), as it
adds nothing to the kernel wrappers' ``launches`` counters.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


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
    """A named region of a running profile; with no profiler running, one
    shared null context and nothing recorded. The region is the C++
    ``RecordFunction`` that ``torch.profiler.record_function`` also opens,
    without its dispatcher op: a few times cheaper while a profiler runs,
    so the spans bend the traced timings less."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
