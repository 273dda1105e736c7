from .train_step import cast_floating, make_predict_step

__all__ = ['cast_floating', 'make_predict_step']
