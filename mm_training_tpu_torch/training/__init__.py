from .optim import AdamW, make_optimizer, multistep_schedule
from .train_step import (HOST_FIELDS, TrainState, camera_inputs, camera_train_inputs,
                         cast_floating, create_train_state, depth_loss_fn, draw_train_randoms,
                         loss_and_grads, make_eval_step, make_predict_step,
                         make_state_predict_step, make_train_step, make_train_step_multi,
                         normalize_images)

__all__ = ['AdamW', 'make_optimizer', 'multistep_schedule', 'HOST_FIELDS', 'TrainState',
           'camera_inputs', 'camera_train_inputs', 'cast_floating', 'create_train_state',
           'depth_loss_fn', 'draw_train_randoms', 'loss_and_grads', 'make_eval_step',
           'make_predict_step', 'make_state_predict_step', 'make_train_step',
           'make_train_step_multi', 'normalize_images']
