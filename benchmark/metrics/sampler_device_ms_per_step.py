"""sampler_device_ms_per_step (device trace): device milliseconds a sampler
step of the ops the port's ``cdm.ddim.step`` (its own: the closure's casts,
the expert stack), ``cdm.blend`` and ``cdm.ddim.update`` spans launched,
from one call traced with the host's ops (``spantrace``). None where the
program opens no span."""

import spantrace


def read(run):
    t = spantrace.of(run)
    if t is None or not t.steps:
        return None
    return 1e3 * t.device_s(spantrace.STEP, "cdm.blend",
                            "cdm.ddim.update") / t.steps
