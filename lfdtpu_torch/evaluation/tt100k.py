# The port's copy of `lfdtpu/evaluation/tt100k.py` (numpy only; the port imports
# nothing of lfdtpu).
#
# TT100K official evaluation (behavioral equivalent of
# `TT100K_train/official_eval.py:133-246` `eval_annos` + the script
# `TT100K_train/evaluation.py:11-84`).
#
# Protocol: per image, candidate (gt, det) pairs above the IoU threshold are
# matched greedily in descending-IoU order (same-category only when
# match_same); detections below `minscore` and boxes outside the
# [minboxsize, maxboxsize) longer-side window are excluded from the counts;
# accuracy (precision) = matched dets / counted dets, recall = matched gts /
# counted gts. The reference reports iou=0.5, minscore=90 on types45.

from __future__ import annotations

import numpy as np


def _iou_xyxy(a, b):
    ix1 = max(a[0], b[0])
    iy1 = max(a[1], b[1])
    ix2 = min(a[2], b[2])
    iy2 = min(a[3], b[3])
    inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / ua if ua > 0 else 0.0


def _long_side(box):
    return max(box[2] - box[0], box[3] - box[1])


def tt100k_eval(
    annos_gd,
    annos_rt,
    iou=0.5,
    imgids=None,
    check_type=True,
    types=None,
    minscore=90,
    minboxsize=0,
    maxboxsize=400,
    match_same=True,
):
    """Evaluate result annotations against ground truth.

    Both inputs use the TT100K json schema:
      {'imgs': {imgid: {'objects': [{'category', 'bbox': {xmin..ymax},
                                     'score'?}, ...]}}}
    Returns dict(accuracy, recall, report, miss, wrong, right).
    """
    type_set = set(types) if types is not None else None
    if imgids is None:
        imgids = list(annos_rt["imgs"].keys())

    n_gt_counted = n_det_counted = n_matched = 0
    miss = {"imgs": {}}
    wrong = {"imgs": {}}
    right = {"imgs": {}}

    for imgid in imgids:
        objs_g = annos_gd["imgs"][imgid]["objects"]
        objs_r = annos_rt["imgs"][imgid].get("objects", [])

        def box(o):
            b = o["bbox"]
            return (b["xmin"], b["ymin"], b["xmax"], b["ymax"])

        # -1 unmatched, -2 excluded, >=0 matched partner index
        mg = [-1] * len(objs_g)
        mr = [-1] * len(objs_r)
        if type_set is not None:
            for i, o in enumerate(objs_g):
                if o["category"] not in type_set:
                    mg[i] = -2
            for j, o in enumerate(objs_r):
                if o["category"] not in type_set:
                    mr[j] = -2
        for j, o in enumerate(objs_r):
            if "score" in o and o["score"] < minscore:
                mr[j] = -2

        pairs = []
        for i, og in enumerate(objs_g):
            if mg[i] == -2:
                continue
            for j, orr in enumerate(objs_r):
                if mr[j] == -2:
                    continue
                if match_same and og["category"] != orr["category"]:
                    continue
                v = _iou_xyxy(box(og), box(orr))
                if v > iou:
                    pairs.append((v, i, j))
        for v, i, j in sorted(pairs, key=lambda x: -x[0]):
            if mg[i] == -1 and mr[j] == -1:
                mg[i] = j
                mr[j] = i

        # size window: out-of-window gts are excluded, and drag their match
        for i, og in enumerate(objs_g):
            s = _long_side(box(og))
            if not (minboxsize <= s < maxboxsize):
                if mg[i] >= 0:
                    mr[mg[i]] = -2
                mg[i] = -2
        for j, orr in enumerate(objs_r):
            if mr[j] != -1:
                continue
            s = _long_side(box(orr))
            if not (minboxsize <= s < maxboxsize):
                mr[j] = -2

        miss_objs, wrong_objs, right_objs = [], [], []
        matched_here = 0
        for i, og in enumerate(objs_g):
            if mg[i] == -1:
                miss_objs.append(og)
        for j, orr in enumerate(objs_r):
            if mr[j] == -1:
                o = dict(orr)
                o["correct_catelog"] = "none"
                wrong_objs.append(o)
            elif mr[j] != -2:
                gi = mr[j]
                if not check_type or objs_g[gi]["category"] == orr["category"]:
                    right_objs.append(orr)
                    matched_here += 1
                else:
                    o = dict(orr)
                    o["correct_catelog"] = objs_g[gi]["category"]
                    wrong_objs.append(o)

        miss["imgs"][imgid] = {"objects": miss_objs}
        wrong["imgs"][imgid] = {"objects": wrong_objs}
        right["imgs"][imgid] = {"objects": right_objs}

        n_gt_counted += len(objs_g) - mg.count(-2)
        n_det_counted += len(objs_r) - mr.count(-2)
        n_matched += matched_here

    accuracy = 1.0 if n_det_counted == 0 else n_matched / n_det_counted
    recall = 1.0 if n_gt_counted == 0 else n_matched / n_gt_counted
    report = "iou:%s, size:[%s,%s), accuracy:%s, recall:%s" % (
        iou, minboxsize, maxboxsize, accuracy, recall
    )
    return dict(
        iou=iou, accuracy=accuracy, recall=recall,
        miss=miss, wrong=wrong, right=right, report=report,
    )


def results_to_tt100k_annos(per_image_results, label_to_category, score_scale=100.0):
    """Convert predict() rows [label, score, x, y, w, h] into the TT100K
    result-annotation json schema (script `TT100K_train/evaluation.py:11-84`;
    scores are 0-100 there, hence score_scale)."""
    imgs = {}
    for imgid, rows in per_image_results.items():
        objs = []
        for row in rows:
            label, score, x, y, w, h = row
            objs.append(
                dict(
                    category=label_to_category[int(label)],
                    score=float(score) * score_scale,
                    bbox=dict(xmin=x, ymin=y, xmax=x + w, ymax=y + h),
                )
            )
        imgs[imgid] = dict(objects=objs)
    return dict(imgs=imgs)
