"""mfu (host clock, %): the model FLOPs of the calls the traced run's
window completed unprofiled (the cell's program's ``model_flops``; for
``dit_sample`` ``counts.sample_flops``: each expert's forward an image, its
adaLN modulation once a step), over those calls' seconds, as a share of
the card's bf16 peak."""

import counts


def read(run):
    if run.trace is None or run.seconds <= 0:
        return None
    flops = run.calls * run.cell.program.model_flops(run.cell)
    return 100.0 * flops / run.seconds / counts.PEAK_BF16_FLOPS
