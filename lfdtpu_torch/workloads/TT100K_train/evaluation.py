# -*- coding: utf-8 -*-
# TT100K official evaluation of the PyTorch port (reference
# `TT100K_train/evaluation.py` + `official_eval.py`, mirroring
# `workloads/TT100K_train/evaluation.py`): predict every test image on the
# device LFD_DEVICE (default cuda), convert the results to the TT100K
# annotation schema, run the greedy IoU >= 0.5 matcher at minscore 90.
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

from lfdtpu_torch import zoo  # noqa: E402
from lfdtpu_torch.data import TT100K_TYPE45  # noqa: E402
from lfdtpu_torch.device import resolve_device  # noqa: E402
from lfdtpu_torch.evaluation import results_to_tt100k_annos, tt100k_eval  # noqa: E402
from lfdtpu_torch.execution import load_checkpoint  # noqa: E402
from lfdtpu_torch.workloads.TT100K_train.TT100K_augmentation_pipeline import (  # noqa: E402
    tt100k_val_pipeline,
)


def evaluate(
    model_size="L",
    param_file_path="./TT100K_LFD_L_work_dir/epoch_500.pth",
    data_root="./TT100K/data",
    annotation_json="./TT100K/data/annotations.json",
    test_id_file="./TT100K/data/test/ids.txt",
    classification_threshold=0.1,
    nms_threshold=0.5,
    minscore=90,
):
    model = zoo.tt100k_lfd(model_size)
    model.net.load_state_dict(load_checkpoint(param_file_path)["state_dict"], strict=True)
    # default cuda; without a CUDA device that raises
    model.net.to(resolve_device(os.environ.get("LFD_DEVICE", "cuda"), "LFD_DEVICE")).eval()

    with open(annotation_json) as f:
        gt = json.load(f)
    with open(test_id_file) as f:
        imgids = f.read().splitlines()

    label_to_cat = {i: t for i, t in enumerate(TT100K_TYPE45)}
    per_image = {}
    for n, imgid in enumerate(imgids):
        path = os.path.join(data_root, gt["imgs"][imgid]["path"])
        per_image[imgid] = model.predict_for_single_image(
            path, aug_pipeline=tt100k_val_pipeline,
            classification_threshold=classification_threshold,
            nms_threshold=nms_threshold,
        )
        if n % 100 == 0:
            print(f"[{n}/{len(imgids)}] processed")

    results = results_to_tt100k_annos(per_image, label_to_cat)
    summary = tt100k_eval(
        gt, results, iou=0.5, imgids=imgids, types=TT100K_TYPE45,
        minscore=minscore,
    )
    print(summary["report"])
    return summary


if __name__ == "__main__":
    evaluate()
