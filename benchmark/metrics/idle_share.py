"""idle_share (device trace, %): the share of the traced calls' wall time
(first call's start to the last call's synchronise) in which no op ran on
the device: 1 - the union of the device-op intervals over that time."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
