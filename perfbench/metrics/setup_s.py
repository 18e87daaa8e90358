"""setup_s: seconds from the process's start to the window's: importing,
drawing the pools and weights, building (a checkout's first run) and
loading the kernels, and the mega-batches that warm every shape."""


def read(run):
    return run.setup_s
