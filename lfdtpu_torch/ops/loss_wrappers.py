# Configured loss objects (`lfdtpu/ops/loss_wrappers.py`, mirroring the
# reference's nn.Module losses, `lfd/model/losses/*.py`): each is a frozen
# dataclass holding hyperparameters + loss_weight, callable as
# loss(pred, target, weight=None, avg_factor=None). Their class names drive
# the detector's switches, as the reference's `type(loss).__name__` checks
# do (`lfd/model/lfd.py:56-71`).

from __future__ import annotations

import dataclasses

from . import losses as L


@dataclasses.dataclass(frozen=True)
class _Base:
    reduction: str = "mean"
    loss_weight: float = 1.0

    def _finish(self, value):
        return self.loss_weight * value


@dataclasses.dataclass(frozen=True)
class FocalLoss(_Base):
    use_sigmoid: bool = True
    gamma: float = 2.0
    alpha: float = 0.25

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        assert self.use_sigmoid
        return self._finish(L.sigmoid_focal_loss(
            pred, target, weight, self.gamma, self.alpha,
            reduction_override or self.reduction, avg_factor))


@dataclasses.dataclass(frozen=True)
class QualityFocalLoss(_Base):
    use_sigmoid: bool = True
    beta: float = 2.0

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.quality_focal_loss(
            pred, target, weight, self.beta, reduction_override or self.reduction,
            avg_factor))


@dataclasses.dataclass(frozen=True)
class DistributionFocalLoss(_Base):
    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.distribution_focal_loss(
            pred, target, weight, reduction_override or self.reduction, avg_factor))


@dataclasses.dataclass(frozen=True)
class CrossEntropyLoss(_Base):
    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.cross_entropy_loss(
            pred, target, weight, reduction_override or self.reduction, avg_factor))


@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLoss(_Base):
    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.binary_cross_entropy_loss(
            pred, target, weight, reduction_override or self.reduction, avg_factor))


@dataclasses.dataclass(frozen=True)
class SmoothL1Loss(_Base):
    beta: float = 1.0

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.smooth_l1_loss(
            pred, target, weight, self.beta, reduction_override or self.reduction,
            avg_factor))


@dataclasses.dataclass(frozen=True)
class L1Loss(_Base):
    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.l1_loss(
            pred, target, weight, reduction_override or self.reduction, avg_factor))


@dataclasses.dataclass(frozen=True)
class MSELoss(_Base):
    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.mse_loss(
            pred, target, weight, reduction_override or self.reduction, avg_factor))


@dataclasses.dataclass(frozen=True)
class IoULoss(_Base):
    eps: float = 1e-6

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.iou_loss(
            pred, target, weight, self.eps, reduction_override or self.reduction,
            avg_factor))


@dataclasses.dataclass(frozen=True)
class GIoULoss(_Base):
    eps: float = 1e-7

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.giou_loss(
            pred, target, weight, self.eps, reduction_override or self.reduction,
            avg_factor))


@dataclasses.dataclass(frozen=True)
class DIoULoss(_Base):
    eps: float = 1e-7

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.diou_loss(
            pred, target, weight, self.eps, reduction_override or self.reduction,
            avg_factor))


@dataclasses.dataclass(frozen=True)
class CIoULoss(_Base):
    eps: float = 1e-7

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None):
        return self._finish(L.ciou_loss(
            pred, target, weight, self.eps, reduction_override or self.reduction,
            avg_factor))


INDEPENDENT_REGRESSION_LOSSES = ("SmoothL1Loss", "MSELoss", "L1Loss")
UNION_REGRESSION_LOSSES = ("IoULoss", "GIoULoss", "DIoULoss", "CIoULoss")
CLASSIFICATION_LOSSES = ("BCEWithLogitsLoss", "FocalLoss", "CrossEntropyLoss",
                         "QualityFocalLoss")
