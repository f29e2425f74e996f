"""launches_per_step (device trace): device ops (kernels, copies, fills)
the traced calls ran, per sampler step."""


def read(run):
    t, steps = run.trace, run.cell.traffic["n_steps"]
    if t is None or not t.ops:
        return None
    return len(t.ops) / (t.calls * steps)
