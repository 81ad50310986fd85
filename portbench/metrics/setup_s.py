"""Seconds from the process's start to the measured window: imports, CUDA
set-up, the kernels loaded (built, in a checkout's first run), the
problem, its plans and the warm-up on the cell's own shapes."""


def read(rec):
    return rec.setup_s
