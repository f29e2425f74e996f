"""fold_device_ms_per_step (device trace): device milliseconds a sampler
step of the ops the port's ``cdm.dit.fold`` spans launched (each block's
adaLN modulation GEMV and its scaled weights and biases, every expert),
from one call traced with the host's ops (``spantrace``). None where the
program opens no span."""

import spantrace


def read(run):
    t = spantrace.of(run)
    if t is None or not t.steps:
        return None
    return 1e3 * t.device_s("cdm.dit.fold") / t.steps
