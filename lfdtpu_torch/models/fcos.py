# FCOS detectors (`lfdtpu/models/fcos.py`, reference `lfd/model/fcos.py`):
# hard one-hot labels with min-area disambiguation (ops/assign.py::
# fcos_assign), a centerness branch trained with BCE, centerness-weighted
# IoU regression, and centerness-modulated scores at decode. The head
# applies Scale and exp itself, so the decode's distances are 'direct'.
#
# FCOSv1 (`fcos.py:452-795`) classifies each (point, class) pair as its own
# binary problem: a point may be positive for several classes.
#
# The net is a DetectionNet whose head returns (cls, reg, centerness); the
# point grids and the reference-API paths are DenseDetector's, so the
# Executor's val loop and make_train_step take an FCOS as they take an LFD.
# lfdtpu serves FCOS through predict_for_single_image / get_results only
# (its compile_inference takes two outputs), and so does the port.

from __future__ import annotations

import torch

from ..ops import assign as assign_ops
from ..ops import boxes as box_ops
from ..ops.decode import DecodeSpec
from ..ops.losses import binary_cross_entropy_loss
from ..parallel.distributed import global_sum, global_sums
from .detector import DenseDetector, DetectionNet


def _global_batch(cls_pred, mesh):
    """The global batch size: every rank holds as many rows as this one."""
    return cls_pred.shape[0] * (mesh.size if mesh is not None else 1)


class FCOS(DenseDetector):
    detector_name = "FCOS"

    def __init__(self, backbone=None, neck=None, head=None, num_classes=80,
                 regression_ranges=((0, 64), (64, 128), (128, 256), (256, 512),
                                    (512, 100000)),
                 point_strides=(8, 16, 32, 64, 128), classification_loss_func=None,
                 regression_loss_func=None, classification_threshold=0.05,
                 nms_threshold=0.5, pre_nms_bbox_limit=1000, post_nms_bbox_limit=100):
        assert len(regression_ranges) == len(point_strides)
        self.net = DetectionNet(backbone, neck, head)
        self.num_classes = num_classes
        self.regression_ranges = tuple(tuple(r) for r in regression_ranges)
        self.point_strides = tuple(int(s) for s in point_strides)
        self.num_heads = len(self.point_strides)
        self.classification_loss_func = classification_loss_func
        self.regression_loss_func = regression_loss_func
        self.classification_threshold = classification_threshold
        self.nms_threshold = nms_threshold
        self.pre_nms_bbox_limit = pre_nms_bbox_limit
        self.post_nms_bbox_limit = post_nms_bbox_limit
        self._level_info_cache = {}
        self._level_array_cache = {}

    # -------------------------------------------------------------- loss
    def _classification_loss(self, cls_pred, info, gt_bboxes, gt_labels, gt_mask, mesh):
        """(classification loss, reg targets (B*P, 4), pos (B*P,), global
        num_pos) with fcos_assign's hard labels; the average is num_pos + B
        over the global batch."""
        labels, reg_t = assign_ops.fcos_assign(info["points"], info["ranges"], gt_bboxes,
                                               gt_labels, gt_mask, self.num_classes)
        labels = labels.reshape(-1).long()
        pos = (labels != self.num_classes).to(cls_pred.dtype)
        num_pos = global_sum(pos.sum(), mesh)
        loss = self.classification_loss_func(cls_pred.reshape(-1, self.num_classes), labels,
                                             avg_factor=num_pos + _global_batch(cls_pred, mesh))
        return loss, reg_t.reshape(-1, 4), pos, num_pos

    def get_loss(self, outputs, gt_bboxes, gt_labels, gt_mask, input_hw,
                 level_arrays=None, mesh=None):
        """`lfd/model/fcos.py:243-330` with padded-GT masking, LFD.get_loss's
        arguments with outputs (cls (B, P, C), reg (B, P, 4) in pixels, ctr
        (B, P, 1)). The classification averages over num_pos + B; the
        regression is weighted by the centerness targets of the positives
        and averages over their sum; the centerness BCE averages over the
        positives. Under a data `mesh` every normalizer is a global sum
        (LFD.get_loss). Returns {"loss", "loss_values": {loss,
        classification_loss, regression_loss, centerness_loss, num_pos}}."""
        cls_pred, reg_pred, ctr_pred = outputs
        B, P = cls_pred.shape[:2]
        info = (level_arrays if level_arrays is not None
                else self.level_arrays(input_hw, cls_pred.device))
        assert info["points"].shape[0] == P, (info["points"].shape, P)
        classification_loss, reg_t, pos, num_pos = self._classification_loss(
            cls_pred, info, gt_bboxes.to(info["points"].dtype), gt_labels, gt_mask.bool(),
            mesh)

        ctr_t = assign_ops.centerness_target(reg_t) * pos
        points = info["points"].repeat(B, 1)
        pred_xyxy = box_ops.distance2bbox(points, reg_pred.reshape(-1, 4).float())
        target_xyxy = box_ops.distance2bbox(points, reg_t)
        regression_loss = self.regression_loss_func(
            pred_xyxy, target_xyxy, weight=ctr_t,
            avg_factor=global_sum(ctr_t.sum(), mesh).clamp(min=1e-6))
        centerness_loss = binary_cross_entropy_loss(
            ctr_pred.reshape(-1, 1), ctr_t[:, None], weight=pos[:, None],
            avg_factor=num_pos.clamp(min=1.0))

        loss = classification_loss + regression_loss + centerness_loss
        values = global_sums(dict(loss=loss, classification_loss=classification_loss,
                                  regression_loss=regression_loss,
                                  centerness_loss=centerness_loss), mesh)
        return dict(loss=loss, loss_values=dict(values, num_pos=num_pos))

    # ------------------------------------------------------------ decode
    def decode_spec(self, classification_threshold=None, nms_threshold=None,
                    class_agnostic=False, max_det=None):
        """'direct' distances; the pre-NMS limit applies per level as well,
        with cls * centerness as the ranking score (`fcos.py:381-387`)."""
        return DecodeSpec(
            num_classes=self.num_classes,
            reg_mode="direct",
            score_thr=float(self.classification_threshold if classification_threshold is None
                            else classification_threshold),
            nms_iou=float(self.nms_threshold if nms_threshold is None else nms_threshold),
            pre_nms_points=self.pre_nms_bbox_limit,
            nms_budget=self.pre_nms_bbox_limit,
            max_det=self.post_nms_bbox_limit if max_det is None else max_det,
            class_agnostic=class_agnostic,
            per_level_limit=int(self.pre_nms_bbox_limit),
        )

    def _score_factors(self, outputs):
        """Each score times its point's sigmoid(centerness)."""
        return torch.sigmoid(outputs[2][..., 0].float())


class FCOSv1(FCOS):
    """Multi-class-per-point FCOS (`lfd/model/fcos.py:452-795`): the
    classification is B*P*C binary problems, a (point, class) pair positive
    when a valid GT of that class covers the point (fcos_v1_assign). The
    regression and the centerness follow FCOS on the smallest valid GT."""

    detector_name = "FCOSv1"

    def _classification_loss(self, cls_pred, info, gt_bboxes, gt_labels, gt_mask, mesh):
        fg, reg_t = assign_ops.fcos_v1_assign(info["points"], info["ranges"], gt_bboxes,
                                              gt_labels, gt_mask, self.num_classes)
        fg = fg.reshape(-1, self.num_classes)
        pos = fg.any(dim=-1).to(cls_pred.dtype)
        # the binary view (`fcos.py:711-739`): logits (B*P*C, 1), label 0 for
        # foreground and 1 (its num_classes) for background
        labels = (~fg.reshape(-1)).long()
        num_pos = global_sum(pos.sum(), mesh)
        loss = self.classification_loss_func(cls_pred.reshape(-1, 1), labels,
                                             avg_factor=num_pos + _global_batch(cls_pred, mesh))
        return loss, reg_t.reshape(-1, 4), pos, num_pos
