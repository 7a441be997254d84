# -*- coding: utf-8 -*-
# Pack a COCO-format traffic-light dataset with the PyTorch port's data
# package (reference `TrafficLight_train/pack_TL.py:2-19`, mirroring
# `workloads/TrafficLight_train/pack_TL.py`): the COCOParser reused for
# custom data, images without boxes kept, images under 32 px dropped.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch.data import COCOParser, Dataset  # noqa: E402


def pack(coco_annotation_path, image_root,
         save_path="./TL_pack/tl_train.pkl"):
    parser = COCOParser(
        coco_annotation_path=coco_annotation_path,
        image_root=image_root,
        filter_no_gt=False,
        filter_min_size=32,
    )
    dataset = Dataset(parser=parser, save_path=save_path)
    print(dataset)
    return dataset


if __name__ == "__main__":
    pack(
        coco_annotation_path="./TL/annotations/train.json",
        image_root="./TL/images",
    )
