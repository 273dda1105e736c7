from .optim import AdamW, make_optimizer, multistep_schedule
from .train_step import (TrainState, cast_floating, create_train_state, loss_and_grads,
                         make_eval_step, make_predict_step, make_train_step)

__all__ = ['AdamW', 'make_optimizer', 'multistep_schedule', 'TrainState', 'cast_floating',
           'create_train_state', 'loss_and_grads', 'make_eval_step', 'make_predict_step',
           'make_train_step']
