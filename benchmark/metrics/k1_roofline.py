"""k1_roofline (device trace, %): the least time K1's launches could take
(each the larger of its operations at the bf16 peak and its bytes at the
HBM rate, ``counts.k1_bound_s`` at the cell's (B, T, D): every launch of
``entry.sample`` runs one block over the whole batch) over their device
time. None where the trace holds no K1 launch."""

import counts

K1 = "fused_dit_block"


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = [sec for name, sec in t.ops if K1 in name]
    if not secs:
        return None
    m = run.cell.config["model"]
    bound = counts.k1_bound_s(run.cell.traffic["batch"], counts.n_tokens(m),
                              m["dim"])
    return 100.0 * len(secs) * bound / sum(secs)
