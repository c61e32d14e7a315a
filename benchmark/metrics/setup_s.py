"""Process start to the first timed request: imports, the CUDA context, the
kernels' libraries, the cold and warm proves."""


def read(run):
    return run.setup_s
