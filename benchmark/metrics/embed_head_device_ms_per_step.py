"""embed_head_device_ms_per_step (device trace): device milliseconds a
sampler step of the ops the port's ``cdm.dit.embed`` and ``cdm.dit.head``
spans launched (the time and label embedding, the patchify and positions;
the final adaLN and the float32 head), every expert, from one call traced
with the host's ops (``spantrace``). None where the program opens no
span."""

import spantrace


def read(run):
    t = spantrace.of(run)
    if t is None or not t.steps:
        return None
    return 1e3 * t.device_s("cdm.dit.embed", "cdm.dit.head") / t.steps
