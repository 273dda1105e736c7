from .fake_batch import make_fake_batch

__all__ = ['make_fake_batch']
