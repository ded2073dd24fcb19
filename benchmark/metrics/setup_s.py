"""setup_s: seconds from the process's start to the window's: imports,
the seeded weights, the kernels' build or load, warm-up and graph
captures (host clock)."""


def read(run):
    return run["setup_s"]
