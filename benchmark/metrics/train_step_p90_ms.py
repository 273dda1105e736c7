"""The 90th percentile of every step of the train window, host clock, the
batch in host memory to the loss read on the host."""


def read(out):
    return out['stats']['p90_ms'] if out['loop'] == 'train' and 'stats' in out else None
