from .jax_convert import jax_train_state_to_port, jax_variables_to_state_dict
from .optim import SGD, GroupedSGD, clip_by_global_norm, global_norm, set_lr
from .schedules import (ConstantLRSchedule, CosineLRSchedule, MultiStepLRSchedule,
                        WarmupSetting)

__all__ = [
    "jax_train_state_to_port", "jax_variables_to_state_dict",
    "SGD", "GroupedSGD", "clip_by_global_norm", "global_norm", "set_lr",
    "ConstantLRSchedule", "CosineLRSchedule", "MultiStepLRSchedule", "WarmupSetting",
]
