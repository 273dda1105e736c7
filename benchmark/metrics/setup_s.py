"""Process start to the first timed step: imports, the kernels' build or
load, the model and its weights, the host pool and the checked steps (or
warm-up calls)."""


def read(out):
    return out['setup_s']
