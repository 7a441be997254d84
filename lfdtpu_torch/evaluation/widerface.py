# WIDERFACE SIO offline evaluation (`lfdtpu/evaluation/widerface.py`,
# reference `WIDERFACE_train/evaluation.py:10-46`): walk the val image tree, predict
# per image with class_agnostic NMS, write per-event txt files in the
# WIDERFACE matlab-eval format (first row is the dummy '0 0 0 0 0.001').

from __future__ import annotations

import math
import os


def SIO_evaluation(
    model,
    val_image_root,
    results_save_root=".",
    classification_threshold=0.5,
    nms_threshold=0.3,
    aug_pipeline=None,
    verbose=True,
    size_divisor=128,
):
    # size_divisor buckets the pad-to resolution: WIDERFACE val has ~3k
    # distinct image sizes; a coarser divisor bounds the number of distinct
    # input shapes (cuDNN picks its plans per shape)
    assert os.path.exists(val_image_root)
    os.makedirs(results_save_root, exist_ok=True)

    if aug_pipeline is None:
        from ..data.augmentation import simple_widerface_val_pipeline

        aug_pipeline = simple_widerface_val_pipeline

    counter = 0
    for parent, _dirs, file_names in os.walk(val_image_root):
        for file_name in sorted(file_names):
            if not file_name.lower().endswith((".jpg", ".jpeg")):
                continue
            results = model.predict_for_single_image(
                os.path.join(parent, file_name),
                aug_pipeline=aug_pipeline,
                classification_threshold=classification_threshold,
                nms_threshold=nms_threshold,
                class_agnostic=True,
                size_divisor=size_divisor,
            )
            event_name = os.path.basename(parent)
            event_dir = os.path.join(results_save_root, event_name)
            os.makedirs(event_dir, exist_ok=True)
            stem = file_name.split(".")[0]
            with open(os.path.join(event_dir, stem + ".txt"), "w") as fout:
                fout.write(stem + "\n")
                fout.write(str(len(results) + 1) + "\n")
                fout.write("0 0 0 0 0.001\n")
                for bbox in results:
                    fout.write(
                        "%d %d %d %d %.03f\n"
                        % (
                            math.floor(bbox[2]),
                            math.floor(bbox[3]),
                            math.ceil(bbox[4]),
                            math.ceil(bbox[5]),
                            bbox[1] if bbox[1] <= 1 else 1,
                        )
                    )
            counter += 1
            if verbose:
                print("[%5d] %s is processed." % (counter, file_name))
    return counter
