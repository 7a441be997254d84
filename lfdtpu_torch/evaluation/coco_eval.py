# The port's copy of `lfdtpu/evaluation/coco_eval.py` (numpy only; the port imports
# nothing of lfdtpu).
#
# COCO-style mAP evaluation in pure numpy (no pycocotools dependency).
#
# Implements the standard COCO bbox protocol — IoU thresholds .5:.05:.95,
# 101-point interpolated precision, area ranges all/small/medium/large,
# crowd-as-ignore with IoF overlap — and the reference's evaluator surface
# (`lfd/evaluation/coco_evaluator.py:13-84`): update((results, meta_batch))
# accumulating [label, score, x, y, w, h] rows, evaluate() producing the
# mAP/mAP_50/mAP_75/mAP_s/mAP_m/mAP_l display string with
# maxDets=[100, 300, 1000].

from __future__ import annotations

import json
import os

import numpy as np

from .base import Evaluator

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 10 thresholds
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _bbox_iou_xywh(dets, gts, iscrowd):
    """IoU of xywh boxes; crowd GT uses IoF (intersection / det area)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    d = np.asarray(dets, np.float64)
    g = np.asarray(gts, np.float64)
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    darea = (d[:, 2] * d[:, 3])[:, None]
    garea = (g[:, 2] * g[:, 3])[None, :]
    union = np.where(np.asarray(iscrowd)[None, :], darea, darea + garea - inter)
    return inter / np.maximum(union, 1e-12)


def _evaluate_image(dets, det_scores, gts, gt_crowd, area_rng, max_det):
    """Greedy per-image matching for one category.

    Returns (dt_matches (T, D), dt_ignore (T, D), gt_ignore (G,), scores (D,)).
    """
    garea = np.array([g[2] * g[3] for g in gts]) if len(gts) else np.zeros((0,))
    gt_ignore = np.asarray(gt_crowd, bool).copy() if len(gts) else np.zeros((0,), bool)
    gt_ignore |= (garea < area_rng[0]) | (garea > area_rng[1])

    order = np.argsort(-np.asarray(det_scores), kind="stable")[:max_det]
    dets = [dets[i] for i in order]
    scores = np.asarray(det_scores)[order]

    # sort gts: non-ignored first (pycocotools convention)
    gorder = np.argsort(gt_ignore, kind="stable")
    gts_sorted = [gts[i] for i in gorder]
    gt_ignore_sorted = gt_ignore[gorder]
    crowd_sorted = np.asarray(gt_crowd, bool)[gorder] if len(gts) else np.zeros((0,), bool)

    ious = _bbox_iou_xywh(dets, gts_sorted, crowd_sorted)
    T = len(IOU_THRS)
    D, G = len(dets), len(gts_sorted)
    dtm = np.zeros((T, D), dtype=np.int64) - 1
    gtm = np.zeros((T, G), dtype=np.int64) - 1
    dt_ignore = np.zeros((T, D), bool)

    for t, thr in enumerate(IOU_THRS):
        for di in range(D):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[t, gi] >= 0 and not crowd_sorted[gi]:
                    continue
                # stop at ignored GTs once a non-ignored match was found
                if m > -1 and not gt_ignore_sorted[m] and gt_ignore_sorted[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[t, di] = m
            gtm[t, m] = di
            dt_ignore[t, di] = gt_ignore_sorted[m]

    # unmatched dets outside the area range are ignored
    darea = np.array([d[2] * d[3] for d in dets]) if D else np.zeros((0,))
    out_of_range = (darea < area_rng[0]) | (darea > area_rng[1])
    dt_ignore |= (dtm == -1) & out_of_range[None, :]
    return dtm >= 0, dt_ignore, gt_ignore_sorted, scores


def coco_map(gt_by_img_cat, det_by_img_cat, categories, max_dets=(100, 300, 1000)):
    """Compute COCO AP metrics.

    Args:
      gt_by_img_cat: {(image_id, cat): (list of xywh, list of iscrowd)}
      det_by_img_cat: {(image_id, cat): (list of xywh, list of scores)}
      categories: iterable of category ids
      max_dets: maxDets list. Matching pycocotools' `_summarizeDets` with
        `params.maxDets=[100,300,1000]` (the reference's setting,
        `coco_evaluator.py:68`): mAP reads the maxDets=100 column; the
        50/75/s/m/l metrics read the LAST column. Truncation to each
        maxDet happens PER IMAGE before the global score sort, exactly
        like `COCOeval.accumulate`.
    Returns dict with mAP, mAP_50, mAP_75, mAP_s, mAP_m, mAP_l.
    """
    image_ids = sorted({k[0] for k in gt_by_img_cat} | {k[0] for k in det_by_img_cat})
    max_det_cap = max_dets[-1]
    T, R, M = len(IOU_THRS), len(REC_THRS), len(max_dets)
    area_names = list(AREA_RANGES)
    # precision[t, r, k, a, m]
    precision = -np.ones((T, R, len(categories), len(area_names), M))

    for ki, cat in enumerate(categories):
        for ai, aname in enumerate(area_names):
            arng = AREA_RANGES[aname]
            all_matches, all_ignore, all_scores = [], [], []
            n_gt = 0
            for img in image_ids:
                gts, crowd = gt_by_img_cat.get((img, cat), ([], []))
                dets, scores = det_by_img_cat.get((img, cat), ([], []))
                if not gts and not dets:
                    continue
                dtm, dti, gti, s = _evaluate_image(
                    dets, scores, gts, crowd, arng, max_det_cap
                )
                all_matches.append(dtm)
                all_ignore.append(dti)
                all_scores.append(s)
                n_gt += int((~gti).sum())
            if n_gt == 0:
                continue
            for mi, md in enumerate(max_dets):
                if all_scores:
                    scores = np.concatenate([s[:md] for s in all_scores])
                    order = np.argsort(-scores, kind="stable")
                    dtm = np.concatenate(
                        [m[:, :md] for m in all_matches], axis=1
                    )[:, order]
                    dti = np.concatenate(
                        [ig[:, :md] for ig in all_ignore], axis=1
                    )[:, order]
                else:
                    dtm = np.zeros((T, 0), bool)
                    dti = np.zeros((T, 0), bool)

                tps = dtm & ~dti
                fps = ~dtm & ~dti
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    rc = tp / n_gt
                    pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                    # monotone envelope
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(R)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[t, :, ki, ai, mi] = q

    def _ap(t_slice=slice(None), area="all", mi=M - 1):
        ai = area_names.index(area)
        p = precision[t_slice, :, :, ai, mi]
        p = p[p > -1]
        return float(np.mean(p)) if p.size else -1.0

    t50 = list(IOU_THRS).index(0.5)
    t75 = list(IOU_THRS).index(0.75)
    # stats[0] uses _summarize's default maxDets=100 when present
    m100 = max_dets.index(100) if 100 in max_dets else M - 1
    return {
        "mAP": _ap(mi=m100),
        "mAP_50": _ap(slice(t50, t50 + 1)),
        "mAP_75": _ap(slice(t75, t75 + 1)),
        "mAP_s": _ap(area="small"),
        "mAP_m": _ap(area="medium"),
        "mAP_l": _ap(area="large"),
    }


class COCOEvaluator(Evaluator):
    """Streaming evaluator with the reference's surface
    (`coco_evaluator.py:13-84`)."""

    def __init__(self, annotation_path, label_indexes_to_category_ids):
        assert os.path.isfile(annotation_path), "annotation file does not exist!!!"
        with open(annotation_path) as f:
            data = json.load(f)
        self._label_to_cat = dict(label_indexes_to_category_ids)
        self._categories = sorted(c["id"] for c in data.get("categories", []))
        self._gt = {}
        for ann in data.get("annotations", []):
            key = (ann["image_id"], ann["category_id"])
            boxes, crowd = self._gt.setdefault(key, ([], []))
            boxes.append(list(ann["bbox"]))
            crowd.append(bool(ann.get("iscrowd", 0)))
        self._dets = {}
        self._image_ids = set()
        self._eval_display_str = ""
        self.metrics = {}

    def update(self, results, meta_batch=None):
        # accept both update((results, meta)) and update(results, meta)
        if meta_batch is None:
            assert isinstance(results, tuple) and len(results) == 2
            predict_bboxes, meta_batch = results
        else:
            predict_bboxes = results
        for i, meta in enumerate(meta_batch):
            image_id = meta["image_id"]
            self._image_ids.add(image_id)
            for row in predict_bboxes[i]:
                label, score = int(row[0]), float(row[1])
                cat = self._label_to_cat[label]
                boxes, scores = self._dets.setdefault((image_id, cat), ([], []))
                boxes.append([float(v) for v in row[2:6]])
                scores.append(score)

    def evaluate(self):
        self._eval_display_str = "\n"
        if not self._dets:
            self._eval_display_str += "No bboxes detected! Evaluation abort!\n"
            return
        gt = {
            k: v for k, v in self._gt.items() if k[0] in self._image_ids
        }
        self.metrics = coco_map(gt, self._dets, self._categories)
        for name in ["mAP", "mAP_50", "mAP_75", "mAP_s", "mAP_m", "mAP_l"]:
            self._eval_display_str += "{:<10}:{:.5f}\n".format(name, self.metrics[name])
        self._dets.clear()

    def get_eval_display_str(self):
        return self._eval_display_str
