from .state import TrainState, create_train_state, make_optimizer
from .steps import (make_cached_train_step, make_sample_fn, make_train_step,
                    pad_batch_with_keys, step_generator)

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "make_cached_train_step", "make_sample_fn", "make_train_step",
           "pad_batch_with_keys", "step_generator"]
