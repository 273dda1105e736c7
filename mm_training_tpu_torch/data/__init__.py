from .fake_batch import make_fake_batch, random_bda_matrices

__all__ = ['make_fake_batch', 'random_bda_matrices']
