# Pack helpers, a copy of `lfdtpu/data/pack.py` (reference
# `lfd/data_pipeline/pack/{pack_widerface,pack_coco,pack_tt100k}.py`): thin
# parser -> Dataset wrappers plus the debug utilities (mini-subset sampler for
# fast iteration, visual checker; only the checker needs OpenCV).

from __future__ import annotations

import os
import pickle
import random

from .dataset import Dataset, _PackUnpickler
from .parsers import COCOParser, TT100KParser, WIDERFACEParser

__all__ = [
    "pack_widerface",
    "pack_coco",
    "pack_tt100k",
    "pack_mini_for_debug",
    "check_by_show",
]


def pack_widerface(annotation_file_path, image_root, save_path, neg_image_root=None):
    """`pack/pack_widerface.py:9-17`."""
    parser = WIDERFACEParser(annotation_file_path, image_root, neg_image_root)
    return Dataset(parser=parser, save_path=save_path)


def pack_coco(coco_annotation_path, image_root, save_path,
              filter_no_gt=True, filter_min_size=32):
    """`pack/pack_coco.py:11-23`."""
    parser = COCOParser(coco_annotation_path, image_root, filter_no_gt, filter_min_size)
    return Dataset(parser=parser, save_path=save_path)


def pack_tt100k(data_root, annotation_json_file_path, id_file_path, save_path,
                neg_image_root=None):
    """`pack/pack_tt100k.py:10-28`."""
    parser = TT100KParser(data_root, annotation_json_file_path, id_file_path, neg_image_root)
    return Dataset(parser=parser, save_path=save_path)


def pack_mini_for_debug(pkl_path, mini_pkl_save_path, num_samples=320, seed=0):
    """Sample a small subset from a packed pkl for fast iteration
    (`pack/pack_coco.py:26-49`)."""
    assert os.path.exists(pkl_path)
    parent = os.path.dirname(mini_pkl_save_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(pkl_path, "rb") as f:
        meta_info, dataset = _PackUnpickler(f).load()
    keys = list(dataset.keys())
    random.Random(seed).shuffle(keys)
    mini = {k: dataset[k] for k in keys[:num_samples]}
    with open(mini_pkl_save_path, "wb") as f:
        pickle.dump([meta_info, mini], f, pickle.HIGHEST_PROTOCOL)
    return len(mini)


def check_by_show(pkl_path, out_dir, num=20):
    """Visual inspection of packed samples — boxes drawn and written to
    files (`pack/pack_coco.py:52-71`; headless: imwrite instead of imshow)."""
    import cv2
    import numpy as np

    from .jpeg import decode

    dataset = Dataset(load_path=pkl_path)
    print(dataset)
    os.makedirs(out_dir, exist_ok=True)
    for n, index in enumerate(dataset.get_indexes()[:num]):
        sample = dataset[index]
        if "image" in sample:
            image = np.asarray(sample["image"]).copy()
        elif "image_bytes" in sample:
            image = decode(sample["image_bytes"])
        else:
            image = cv2.imread(sample["image_path"], cv2.IMREAD_COLOR)
        for bbox in sample.get("bboxes", []):
            cv2.rectangle(
                image, (int(bbox[0]), int(bbox[1])),
                (int(bbox[0] + bbox[2]), int(bbox[1] + bbox[3])), (0, 255, 0), 2,
            )
        path = os.path.join(out_dir, f"check_{n}.jpg")
        cv2.imwrite(path, image)
    print(f"wrote {min(num, len(dataset))} images to {out_dir}")
