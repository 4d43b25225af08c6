"""Everything before the window: process start, CUDA context, kernel load
or build, design load, input pool, warm-up or capture."""


def read(run):
    return run.setup_s
