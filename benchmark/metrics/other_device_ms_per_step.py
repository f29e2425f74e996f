"""other_device_ms_per_step (device trace): device milliseconds per sampler
step of every op that is not K1 (``fused_dit_block``): the fold, the
patchify and head, the embeddings, the blend and the DDIM update."""

K1 = "fused_dit_block"


def read(run):
    t, steps = run.trace, run.cell.traffic["n_steps"]
    if t is None or not t.ops:
        return None
    other = sum(sec for name, sec in t.ops if K1 not in name)
    return 1e3 * other / (t.calls * steps)
