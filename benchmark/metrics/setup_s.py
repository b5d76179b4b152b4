"""Seconds from the process's start to the first timed step: imports, the CUDA
context, the kernels (built or loaded from the checkout's build directory), the
weights and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
