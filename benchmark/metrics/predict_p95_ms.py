"""The 95th percentile of every call of the predict window, host clock, the
batch in host memory to boxes, scores, labels and valid on the host."""


def read(out):
    return out['stats']['p95_ms'] if out['loop'] == 'predict' and 'stats' in out else None
