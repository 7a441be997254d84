from .assign import fcos_assign, lfd_assign, lfdv2_assign
from .boxes import bbox2distance, bbox_overlaps, distance2bbox, xywh_to_xyxy, xyxy_to_xywh
from .decode import DecodeSpec, decode_predictions, detections_to_lists
from .losses import (
    binary_cross_entropy_loss,
    ciou_loss,
    cross_entropy_loss,
    diou_loss,
    distribution_focal_loss,
    giou_loss,
    iou_loss,
    l1_loss,
    mse_loss,
    quality_focal_loss,
    sigmoid_focal_loss,
    smooth_l1_loss,
    weight_reduce_loss,
)
from .nms import batched_nms, multiclass_nms, nms, nms_mask, nms_match, soft_nms
from .points import concat_level_info, feature_map_sizes_for_input, generate_point_coordinates

# lfdtpu's namespace (`lfdtpu/ops/__init__.py`), its `batched_nms_jax` and
# `multiclass_nms_jax` under the port's names
__all__ = [
    "feature_map_sizes_for_input", "generate_point_coordinates", "concat_level_info",
    "distance2bbox", "bbox2distance", "bbox_overlaps", "xywh_to_xyxy", "xyxy_to_xywh",
    "lfd_assign", "lfdv2_assign", "fcos_assign",
    "sigmoid_focal_loss", "quality_focal_loss", "distribution_focal_loss", "iou_loss",
    "giou_loss", "diou_loss", "ciou_loss", "cross_entropy_loss", "binary_cross_entropy_loss",
    "smooth_l1_loss", "l1_loss", "mse_loss", "weight_reduce_loss",
    "DecodeSpec", "decode_predictions", "detections_to_lists",
    "batched_nms", "nms_mask", "multiclass_nms", "nms", "soft_nms", "nms_match",
]
