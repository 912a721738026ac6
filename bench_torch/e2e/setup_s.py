"""setup_s: seconds from the start of the process to the window: imports,
the CUDA context, the kernel library's load (or build), the scene and its
tables, and one warm job of the cell's own shape."""


def read(run: dict):
    return run["setup_s"]
