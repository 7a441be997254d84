from .data_parallel import (TrainState, create_train_state, make_eval_step,
                            make_train_step)
from .prefetch import BATCH_KEYS, prefetch_to_device

__all__ = ["TrainState", "create_train_state", "make_train_step", "make_eval_step",
           "BATCH_KEYS",
           "prefetch_to_device"]
