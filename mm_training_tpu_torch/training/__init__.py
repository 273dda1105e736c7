from .optim import AdamW, make_optimizer, multistep_schedule
from .train_step import (TrainState, camera_inputs, camera_train_inputs, cast_floating,
                         create_train_state, depth_loss_fn, draw_train_randoms,
                         loss_and_grads, make_eval_step, make_predict_step, make_train_step,
                         normalize_images)

__all__ = ['AdamW', 'make_optimizer', 'multistep_schedule', 'TrainState', 'camera_inputs',
           'camera_train_inputs', 'cast_floating', 'create_train_state', 'depth_loss_fn',
           'draw_train_randoms', 'loss_and_grads', 'make_eval_step', 'make_predict_step',
           'make_train_step', 'normalize_images']
