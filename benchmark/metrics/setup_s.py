"""Seconds from process start to the window's start: CUDA initialisation,
the kernel libraries, the code, the DEM and the engine, and one warm batch."""


def read(run):
    return run["setup_s"]
