# Learning-rate schedules (a copy of `lfdtpu/execution/schedules.py`, pure
# Python; the port cannot import lfdtpu, whose __init__ imports jax),
# reproducing the reference's MultiStepLR + warmup-with-deferred-replay
# semantics (`lfd/execution/hooks/lr_scheduler_hook.py:36-99`,
# `WIDERFACE_LFD_S.py:227-243`).
#
# The schedule is evaluated on the host each step and its float goes into
# the optimizer's param groups (optim.set_lr): no device work, no sync.
#
# Semantics:
#   - warmup (by iter or by epoch) for the first `warmup_loops` loops:
#       constant: lr = base * ratio
#       linear:   lr = base * (1 - (1 - loop/loops) * (1 - ratio))
#       exp:      lr = base * ratio^(1 - loop/loops)
#   - after warmup, MultiStep decay by `gamma` at epoch milestones; epoch
#     steps skipped during warmup are replayed, so the decay count is simply
#     |{m in milestones : m <= epoch}| regardless of warmup length.

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WarmupSetting:
    by_epoch: bool = False
    warmup_mode: Optional[str] = "linear"  # None | constant | linear | exp
    warmup_loops: int = 0
    warmup_ratio: float = 0.1

    def __post_init__(self):
        if self.warmup_mode is not None:
            assert self.warmup_mode in ("constant", "linear", "exp")
            assert self.warmup_loops >= 0
            assert 0 < self.warmup_ratio <= 1.0


@dataclasses.dataclass(frozen=True)
class MultiStepLRSchedule:
    base_lr: float
    milestones: Tuple[int, ...] = ()
    gamma: float = 0.1
    warmup: WarmupSetting = WarmupSetting(warmup_mode=None)

    def _warmup_lr(self, current_loop: int) -> float:
        w = self.warmup
        if w.warmup_mode == "constant":
            return self.base_lr * w.warmup_ratio
        if w.warmup_mode == "linear":
            k = (1 - current_loop / w.warmup_loops) * (1 - w.warmup_ratio)
            return self.base_lr * (1 - k)
        if w.warmup_mode == "exp":
            return self.base_lr * w.warmup_ratio ** (1 - current_loop / w.warmup_loops)
        raise ValueError(w.warmup_mode)

    def __call__(self, epoch: int, train_iter: int) -> float:
        """lr for 0-based (epoch, global train_iter)."""
        w = self.warmup
        if w.warmup_mode is not None:
            loop = (epoch if w.by_epoch else train_iter) + 1
            if loop <= w.warmup_loops:
                return self._warmup_lr(loop)
        decays = sum(1 for m in self.milestones if m <= epoch)
        return self.base_lr * self.gamma**decays


@dataclasses.dataclass(frozen=True)
class ConstantLRSchedule:
    base_lr: float
    warmup: WarmupSetting = WarmupSetting(warmup_mode=None)

    def __call__(self, epoch: int, train_iter: int) -> float:
        return MultiStepLRSchedule(self.base_lr, (), 1.0, self.warmup)(epoch, train_iter)


@dataclasses.dataclass(frozen=True)
class CosineLRSchedule:
    """Cosine decay over total_iters with the same warmup semantics."""

    base_lr: float
    total_iters: int
    final_lr: float = 0.0
    warmup: WarmupSetting = WarmupSetting(warmup_mode=None)

    def __call__(self, epoch: int, train_iter: int) -> float:
        w = self.warmup
        if w.warmup_mode is not None:
            loop = (epoch if w.by_epoch else train_iter) + 1
            if loop <= w.warmup_loops:
                return MultiStepLRSchedule(self.base_lr, (), 1.0, w)(epoch, train_iter)
        t = min(train_iter / max(self.total_iters, 1), 1.0)
        return self.final_lr + 0.5 * (self.base_lr - self.final_lr) * (1 + math.cos(math.pi * t))
