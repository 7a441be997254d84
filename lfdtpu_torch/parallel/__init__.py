from .data_parallel import TrainState, create_train_state, make_train_step

__all__ = ["TrainState", "create_train_state", "make_train_step"]
