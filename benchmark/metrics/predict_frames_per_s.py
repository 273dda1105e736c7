"""Frames a second of the predict window: every call's frames over the
window's whole length."""


def read(out):
    return out['stats']['rate'] if out['loop'] == 'predict' and 'stats' in out else None
