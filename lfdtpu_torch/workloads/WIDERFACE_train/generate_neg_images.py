# -*- coding: utf-8 -*-
# Generate face-free negative crops from the WIDERFACE train set (reference
# `WIDERFACE_train/generate_neg_images.py`, the PyTorch port's copy of
# `workloads/WIDERFACE_train/generate_neg_images.py`; host code only,
# OpenCV and numpy): for each annotated image, the
# four margins outside the bounding hull of all faces — when at least
# `min_size_threshold` pixels wide/tall — are saved as negative images for
# RandomWithNegDatasetSampler.
import os

import numpy as np


def generate_neg_images(
    image_root,
    annotation_path,
    neg_image_save_root,
    min_size_threshold=100,
):
    import cv2

    os.makedirs(neg_image_save_root, exist_ok=True)
    counter = 0

    with open(annotation_path, "r") as fin:
        lines = [ln.rstrip("\n") for ln in fin]
    i = 0
    image_path = None
    while i < len(lines):
        line = lines[i]
        if line.endswith(".jpg"):
            image_path = os.path.join(image_root, line)
            i += 1
            continue
        n = int(line)
        i += 1
        rows = max(n, 1)
        boxes = []
        for _ in range(rows):
            parts = lines[i].split(" ")
            i += 1
            x, y, w, h = (int(parts[k]) for k in range(4))
            if x < 0 or y < 0 or w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
        if not boxes:
            continue
        image = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
        if image is None:
            continue
        b = np.asarray(boxes)
        left, top = b[:, 0].min(), b[:, 1].min()
        right, bottom = b[:, 2].max(), b[:, 3].max()
        H, W = image.shape[:2]
        crops = []
        if left >= min_size_threshold:
            crops.append(image[:, :left])
        if top >= min_size_threshold:
            crops.append(image[:top, :])
        if W - right >= min_size_threshold:
            crops.append(image[:, right:])
        if H - bottom >= min_size_threshold:
            crops.append(image[bottom:, :])
        for crop in crops:
            counter += 1
            cv2.imwrite(os.path.join(neg_image_save_root, f"{counter}.jpg"), crop)
    print(f"{counter} neg images saved to {neg_image_save_root}")
    return counter


if __name__ == "__main__":
    generate_neg_images(
        image_root="./WIDER_train/images",
        annotation_path="./wider_face_split/wider_face_train_bbx_gt.txt",
        neg_image_save_root="./WIDER_train/neg_images",
    )
