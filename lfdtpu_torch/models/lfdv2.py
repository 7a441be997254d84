# LFDv2 detector family (`lfdtpu/models/lfdv2.py`, reference
# `lfd/model/lfdv2.py:134-1652`).
#
# LFDv2 shares LFD's loss (the reference's get_loss at `lfdv2.py:444-560` is
# line-identical to v1's); only the assignment differs (ops/assign.py::
# lfdv2_assign: centerness scores, a stride-sized core zone forced to 1.0 and
# a linear gray-zone relaxation instead of hard ignores). Its defaults:
# range_assign_mode 'longer', NMS 0.5, and the pre-NMS limit applied per
# level (`lfdv2.py:618-624`).
#
# LFDv2Q is the reference file's second, experimental class `LFDv2_`
# (`lfdv2.py:963-1652`): QualityFocalLoss-only classification whose positive
# quality targets are optionally coupled with the IoU between the decoded
# (detached) predictions and the targets (`lfdv2.py:1296-1318`).
#
# Both use LFD's net and state_dict names: the weight bridge needs nothing new.

from __future__ import annotations

import dataclasses

import torch

from ..ops import assign as assign_ops
from ..ops import boxes as box_ops
from ..parallel.distributed import global_sum, global_sums
from .detector import LFD


class LFDv2(LFD):
    detector_name = "LFDv2"

    def __init__(self, backbone=None, neck=None, head=None, range_assign_mode="longer",
                 nms_threshold=0.5, **kwargs):
        """LFD's arguments (by keyword past the three parts), with LFDv2's
        defaults for the range mode and the NMS threshold."""
        super().__init__(backbone, neck, head, range_assign_mode=range_assign_mode,
                         nms_threshold=nms_threshold, **kwargs)

    def decode_spec(self, classification_threshold=None, nms_threshold=None,
                    class_agnostic=False, max_det=None):
        """pre_nms_bbox_limit applies PER LEVEL before the concat
        (`lfdv2.py:618-624`), unlike v1's global candidate budget."""
        spec = super().decode_spec(classification_threshold, nms_threshold,
                                   class_agnostic, max_det)
        return dataclasses.replace(spec, per_level_limit=int(self.pre_nms_bbox_limit))

    def _assign(self, info, gt_bboxes, gt_labels, gt_mask):
        return assign_ops.lfdv2_assign(
            info["points"], info["strides"], info["ranges"], info["gray_ranges"],
            gt_bboxes, gt_labels, gt_mask, self.num_classes,
            range_assign_mode=self.range_assign_mode,
            normalize_by_range=self.regression_loss_type == "independent")


class LFDv2Q(LFDv2):
    """`LFDv2_` (`lfdv2.py:963-1652`): QFL-only classification with optional
    IoU-quality coupling; the regression weighted by the detached predicted
    class probability; 'exp' decode only."""

    detector_name = "LFDv2Q"

    def __init__(self, *args, enable_iou_score_coupling=True, **kwargs):
        kwargs.setdefault("distance_to_bbox_mode", "exp")
        super().__init__(*args, **kwargs)
        assert self.classification_loss_type == "QualityFocalLoss", (
            "LFDv2Q requires QualityFocalLoss (`lfdv2.py:1013-1015`)")
        assert self.regression_loss_type == "union"
        self.enable_iou_score_coupling = enable_iou_score_coupling

    def get_loss(self, outputs, gt_bboxes, gt_labels, gt_mask, input_hw,
                 level_arrays=None, mesh=None):
        """`lfdv2.py:1254-1328` with padded-GT masking; the arguments and
        returns of LFD.get_loss (under a mesh, global normalizers)."""
        cls_pred, reg_pred = outputs
        B, P = cls_pred.shape[:2]
        info = (level_arrays if level_arrays is not None
                else self.level_arrays(input_hw, cls_pred.device))
        assert info["points"].shape[0] == P, (info["points"].shape, P)
        cls_t, reg_t = self._assign(info, gt_bboxes.to(info["points"].dtype), gt_labels,
                                    gt_mask.bool())

        cls_pred_f = cls_pred.reshape(-1, self.num_classes)
        reg_pred_f = reg_pred.reshape(-1, 4)
        cls_t_f = cls_t.reshape(-1, self.num_classes)
        reg_t_f = reg_t.reshape(-1, 4)

        max_scores, max_idx = cls_t_f.max(dim=-1)
        pos = (max_scores > 0).to(cls_pred_f.dtype)

        points = info["points"].repeat(B, 1)
        # clamped before exp: regression outputs at negative points carry zero
        # weight in both terms, so nothing stops them drifting until exp
        # overflows; then the IoU is inf - inf = NaN and `iou * pos` (NaN * 0)
        # poisons the score targets (the reference gathers positive rows only,
        # `lfdv2.py:1288-1309`, and never sees those rows)
        dist = torch.exp(reg_pred_f.float().clamp(max=30.0))
        pred_xyxy = box_ops.distance2bbox(points, dist)
        target_xyxy = box_ops.distance2bbox(points, reg_t_f)

        # regression weighted by the detached predicted probability of the
        # target class (`lfdv2.py:1300-1306`)
        probs = torch.sigmoid(cls_pred_f).detach()
        reg_w = probs.gather(1, max_idx[:, None])[:, 0] * pos
        regression_loss = self.regression_loss_func(
            pred_xyxy, target_xyxy, weight=reg_w,
            avg_factor=global_sum(reg_w.sum(), mesh).clamp(min=1.0))

        iou = box_ops.bbox_overlaps(pred_xyxy.detach(), target_xyxy, is_aligned=True)
        iou_score = iou * pos
        score_targets = (max_scores * iou_score if self.enable_iou_score_coupling
                         else max_scores)
        labels = torch.where(score_targets > 0, max_idx,
                             torch.full_like(max_idx, self.num_classes))
        classification_loss = self.classification_loss_func(
            cls_pred_f, (labels, score_targets),
            avg_factor=global_sum(score_targets.sum(), mesh).clamp(min=1.0))

        loss = classification_loss + regression_loss
        values = global_sums(dict(loss=loss, classification_loss=classification_loss,
                                  regression_loss=regression_loss), mesh)
        return dict(loss=loss, loss_values=dict(values, num_pos=global_sum(pos.sum(), mesh)))
