"""host_issue_ms_per_step (device trace): the host's milliseconds a sampler
step spent issuing work, from the port's spans in one call traced with the
host's ops (``spantrace``): the ``cdm.ddim.step`` spans' time less what
the host stood blocked on the card's full launch queue (each CUDA API
call in a step beyond its name's median), over the steps. The
profiler's own cost on each host op is in it. None where the program
opens no span.

It moves ``images_per_s`` only where the host paces the card. In a cell
the card paces, the host's issue time hides under the card's time a step,
and the queue stands full: each name's median call is then partly a wait
of its own, so the blocked time reads low and this reading high."""

import spantrace


def read(run):
    t = spantrace.of(run)
    if t is None or not t.steps:
        return None
    return 1e3 * (t.host_s(spantrace.STEP) - t.blocked_s) / t.steps
