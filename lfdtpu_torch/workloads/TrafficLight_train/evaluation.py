# -*- coding: utf-8 -*-
# COCO-style mAP evaluation of the PyTorch port for the TrafficLight workload
# (reference `TrafficLight_train/evaluation.py`, mirroring
# `workloads/TrafficLight_train/evaluation.py`): predict every image of a
# COCO-format annotation file class-agnostic on the device LFD_DEVICE
# (default cuda), feed the COCOEvaluator through the packed dataset's label
# -> category map, print the display string.
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import Dataset  # noqa: E402
from lfdtpu_torch.device import resolve_device  # noqa: E402
from lfdtpu_torch.evaluation import COCOEvaluator  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402
from lfdtpu_torch.workloads.TrafficLight_train.TL_augmentation_pipeline import (  # noqa: E402
    tl_val_pipeline,
)


def evaluate(
    model_size="L",
    param_file_path="./TL_LFD_L_work_dir/epoch_100.pth",
    val_annotation_path="./debug_data/annotations/instances_train2017.json",
    val_image_root="./debug_data/images/train2017",
    val_dataset_pkl="./debug_data/train.pkl",
    classification_threshold=0.1,
    nms_threshold=0.3,
):
    import cv2

    model = zoo.trafficlight_lfd(model_size)
    model.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    # default cuda; without a CUDA device that raises
    model.net.to(resolve_device(os.environ.get("LFD_DEVICE", "cuda"), "LFD_DEVICE")).eval()

    val_dataset = Dataset(load_path=val_dataset_pkl)
    label_indexes_to_category_ids = val_dataset.meta_info["label_indexes_to_category_ids"]
    evaluator = COCOEvaluator(
        annotation_path=val_annotation_path,
        label_indexes_to_category_ids=label_indexes_to_category_ids,
    )

    with open(val_annotation_path) as f:
        images = json.load(f)["images"]

    for i, info in enumerate(images):
        image = cv2.imread(os.path.join(val_image_root, info["file_name"]), cv2.IMREAD_UNCHANGED)
        results = model.predict_for_single_image(
            image, aug_pipeline=tl_val_pipeline,
            classification_threshold=classification_threshold,
            nms_threshold=nms_threshold,
            class_agnostic=True,
        )
        evaluator.update(([results], [{"image_id": info["id"]}]))
        print("Predicting: %d/%d" % (i, len(images)))

    evaluator.evaluate()
    print(evaluator.get_eval_display_str())
    return evaluator.metrics


if __name__ == "__main__":
    evaluate()
