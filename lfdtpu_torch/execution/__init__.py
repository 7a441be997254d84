from .executor import Executor
from .hooks import (CheckpointHook, EvaluationHook, Hook, LoggerHook, LrSchedulerHook,
                    OptimizerHook, Priority, ProfilerHook, SpeedHook, get_priority)
from .jax_convert import jax_amax_to_port, jax_train_state_to_port, jax_variables_to_state_dict
from .optim import (SGD, GroupedSGD, bias_param_labels, clip_by_global_norm, global_norm,
                    set_lr)
from .torch_convert import convert_torchvision_resnet
from .schedules import (ConstantLRSchedule, CosineLRSchedule, MultiStepLRSchedule,
                        WarmupSetting)
from .utils import (AverageMeter, collect_envs, customize_exception_hook, get_root_logger,
                    load_backbone_weights, load_checkpoint, save_checkpoint, set_random_seed)

__all__ = [
    "Executor",
    "Hook", "Priority", "get_priority", "LrSchedulerHook", "OptimizerHook", "SpeedHook",
    "CheckpointHook", "EvaluationHook", "LoggerHook", "ProfilerHook",
    "jax_amax_to_port", "jax_train_state_to_port", "jax_variables_to_state_dict",
    "convert_torchvision_resnet",
    "SGD", "GroupedSGD", "bias_param_labels", "clip_by_global_norm", "global_norm", "set_lr",
    "ConstantLRSchedule", "CosineLRSchedule", "MultiStepLRSchedule", "WarmupSetting",
    "AverageMeter", "collect_envs", "customize_exception_hook", "get_root_logger",
    "load_backbone_weights", "load_checkpoint", "save_checkpoint", "set_random_seed",
]
