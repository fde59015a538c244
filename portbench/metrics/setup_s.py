"""setup_s: process start to the window's first instant (fleet and pods
built from the seed, kernels loaded or built, the cell's warm traffic)."""


def read(run):
    return run.setup_s
