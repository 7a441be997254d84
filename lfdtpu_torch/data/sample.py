# Sample container, a copy of `lfdtpu/data/sample.py` (reference
# `lfd/data_pipeline/dataset/sample.py:1-24`). A dict subclass; the reserved keys below carry image/annotation payloads,
# every other key is per-sample meta that flows through to evaluators.

__all__ = ["Sample", "reserved_keys"]

reserved_keys = [
    "image_bytes",  # encoded image bytes (jpg/png/...)
    "image_type",   # encoding suffix
    "image_path",   # path on disk
    "image",        # decoded HWC numpy array
    "bboxes",       # [[x, y, w, h], ...]
    "bbox_labels",  # [label, ...] 0-based
]


class Sample(dict):
    def __str__(self):
        return "The sample includes the following keys: \n" + "\t".join(
            f"[{k}]" for k in self.keys()
        )
