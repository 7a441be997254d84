from .decode import DecodeSpec, decode_predictions, detections_to_lists
from .nms import batched_nms, multiclass_nms, nms, nms_mask, nms_match, soft_nms

__all__ = [
    "DecodeSpec", "decode_predictions", "detections_to_lists",
    "batched_nms", "nms_mask", "multiclass_nms", "nms", "soft_nms", "nms_match",
]
