# -*- coding: utf-8 -*-
# Generate pure negative images from the TT100K train set (reference
# `TT100K_train/generate_neg_images.py`, the PyTorch port's copy of
# `workloads/TT100K_train/generate_neg_images.py`; host code only, OpenCV
# and numpy): an image with no type45 sign is saved whole; otherwise the
# strips left / top / right / bottom of the union of its sign boxes are
# saved when a strip is at least `min_size_threshold` pixels wide / tall.
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import numpy as np  # noqa: E402

from lfdtpu_torch.data import TT100K_TYPE45  # noqa: E402


def generate_neg_images(
    dataset_root="./TT100K/data",
    split="train",
    neg_dir_name="train_neg",
    min_size_threshold=512,
):
    import cv2

    annotation_json_file = os.path.join(dataset_root, "annotations.json")
    with open(os.path.join(dataset_root, split, "ids.txt")) as f:
        id_list = f.read().splitlines()
    neg_image_save_root = os.path.join(dataset_root, neg_dir_name)
    os.makedirs(neg_image_save_root, exist_ok=True)

    with open(annotation_json_file) as f:
        image_annotations = json.load(f)["imgs"]

    type45 = set(TT100K_TYPE45)
    counter = 0

    def save(img):
        nonlocal counter
        counter += 1
        cv2.imwrite(os.path.join(neg_image_save_root, f"{counter}.jpg"), img)
        print("[%5d] neg image saved!" % counter)

    for identity in id_list:
        annotation = image_annotations[identity]
        bboxes = [
            [
                int(obj["bbox"]["xmin"]),
                int(obj["bbox"]["ymin"]),
                int(obj["bbox"]["xmax"]),
                int(obj["bbox"]["ymax"]),
            ]
            for obj in annotation["objects"]
            if obj["category"] in type45
        ]
        image = cv2.imread(os.path.join(dataset_root, annotation["path"]), cv2.IMREAD_UNCHANGED)
        if not bboxes:
            save(image)
            continue
        bboxes = np.asarray(bboxes)
        left, top = bboxes[:, 0].min(), bboxes[:, 1].min()
        right, bottom = bboxes[:, 2].max(), bboxes[:, 3].max()
        if left >= min_size_threshold:
            save(image[:, :left])
        if top >= min_size_threshold:
            save(image[:top, :])
        if image.shape[1] - right >= min_size_threshold:
            save(image[:, right:])
        if image.shape[0] - bottom >= min_size_threshold:
            save(image[bottom:, :])
    print(f"{counter} neg images generated in {neg_image_save_root}")
    return counter


if __name__ == "__main__":
    generate_neg_images()
