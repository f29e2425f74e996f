"""setup_s (host clock): process start to the first timed call: imports,
the CUDA context, the kernel library (built on a checkout's first run),
the weights made on the card and one warm call at the cell's shapes."""


def read(run):
    return run.setup_s
