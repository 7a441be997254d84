from .decode import DecodeSpec, decode_predictions, detections_to_lists
from .nms import batched_nms, nms_mask

__all__ = [
    "DecodeSpec", "decode_predictions", "detections_to_lists",
    "batched_nms", "nms_mask",
]
