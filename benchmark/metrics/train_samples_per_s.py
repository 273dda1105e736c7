"""Samples a second of the train window: every step's samples over the
window's whole length."""


def read(out):
    return out['stats']['rate'] if out['loop'] == 'train' and 'stats' in out else None
