"""Full-pipeline accuracy validation on synthetic data, on the port
(`tools/synthetic_e2e.py` of lfdtpu, with its scene generator copied).

Generates a synthetic detection dataset (bright rectangles of two classes on
textured noise, drawn from a seeded numpy RandomState: the same images and
COCO dict as lfdtpu's), trains a small detector of one family through the
port's Executor (threaded loader, region sampler, warmup schedule, grad clip)
on the card, then evaluates it with the numpy COCO evaluator via the val
loop. It passes when mAP_50 exceeds the threshold: evidence that the whole
stack (data -> assignment -> loss -> optimizer -> decode -> NMS ->
evaluator) learns, without any real dataset.

  --family {lfd,lfdv2,lfdv2q,fcos} trains each detector family;
  --multiscale uses a 4-level model with objects drawn from every
  regression range and also asserts per-range recall, so that a level whose
  assignment or decode silently breaks fails the run.

engine_quality=True then scores the trained model through deployment
engines (fp32 and the calibrated int8 engine by default; also the bf16
engine with the hand-written convs and the int8 engine with a bf16 head) and
returns each engine's mAP_50: the accuracy leg of the int8 engine.

    python -m lfdtpu_torch.tools.synthetic_e2e --family lfd --multiscale
    python -m lfdtpu_torch.tools.synthetic_e2e --epochs 1 --threshold 0 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import tempfile

import numpy as np

# (min_wh, max_wh) per scale bucket; bucket i targets regression range i of
# the multiscale model below
MULTISCALE_BUCKETS = ((8, 14), (18, 30), (36, 60), (72, 120))
MULTISCALE_RANGES = ((0, 16), (16, 32), (32, 64), (64, 160))
MULTISCALE_SIZE = 192
# a zoo model's single-class boxes: its mid ranges at a 128 px crop
# (WIDERFACE scales: (4,20),(20,40),(40,80))
ZOO_BUCKETS = ((10, 18), (22, 38), (44, 72))
TRAIN_IMAGES, VAL_IMAGES = 64, 16
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
CALIBRATION_FRAMES, CALIBRATION_BATCH = 32, 8  # training frames the int8 engine sees
# the engines engine_quality_eval can score, as compile_inference switches;
# "bf16" also takes K2 (kernel_stem) where the net's stem is 3x3/s2 3 -> 64
ENGINES = {
    "fp32": dict(precision="fp32"),
    "bf16": dict(precision="bf16", kernel_convs=True),
    "int8": dict(precision="int8"),
    "int8_bf16": dict(precision="int8", int8_head_dtype="bf16"),
}


def make_dataset(n, seed, size=128, buckets=((18, 48),), num_classes=2):
    """Images with bright/dark boxes; each box's size is drawn from a
    cycling scale bucket so that every bucket is represented about equally.
    num_classes=1 emits bright-only boxes (single-class zoo models)."""
    rng = np.random.RandomState(seed)
    samples = {}
    ann_id = 1
    coco = {"images": [], "annotations": [],
            "categories": [{"id": 1, "name": "bright"},
                           {"id": 2, "name": "dark"}][:num_classes]}
    bucket_cycle = 0
    for i in range(n):
        # mid-gray texture keeps both classes separable even at ~10 px
        img = (rng.rand(size, size, 3) * 40 + 90).astype(np.uint8)
        boxes, labels = [], []
        for _ in range(rng.randint(1, 4)):
            lo, hi = buckets[bucket_cycle % len(buckets)]
            bucket_cycle += 1
            w, h = rng.randint(lo, hi + 1, 2)
            if w >= size or h >= size:
                continue
            x = rng.randint(0, size - w)
            y = rng.randint(0, size - h)
            cls = rng.randint(0, num_classes)
            color = (230, 220, 210) if cls == 0 else (15, 25, 20)
            img[y:y + h, x:x + w] = color
            boxes.append([int(x), int(y), int(w), int(h)])
            labels.append(cls)
        samples[i] = {"image": img, "image_id": i + 1, "bboxes": boxes,
                      "bbox_labels": labels}
        coco["images"].append({"id": i + 1, "height": size, "width": size,
                               "file_name": f"{i}.jpg"})
        for b, label in zip(boxes, labels):
            coco["annotations"].append({"id": ann_id, "image_id": i + 1,
                                        "category_id": label + 1, "bbox": b,
                                        "iscrowd": 0, "area": b[2] * b[3]})
            ann_id += 1
    return samples, coco


class MemDataset:
    def __init__(self, samples):
        self._s = samples

    def __getitem__(self, i):
        return self._s[i]

    def __len__(self):
        return len(self._s)

    def get_indexes(self):
        return list(self._s.keys())


def build_detector(family="lfd", multiscale=False):
    """lfdtpu's synthetic detector of `family` on the port's models: a
    two-level LFDResNet (or a four-level one with MULTISCALE_RANGES), a
    64-channel SimpleNeck and a 64-channel GroupNorm head."""
    from lfdtpu_torch.models import (FCOS, LFD, FCOSHead, LFDHead, LFDResNet, LFDv2, LFDv2Q,
                                     SimpleNeck)
    from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss, QualityFocalLoss

    bn = dict(type="BatchNorm2d")
    if multiscale:
        # 4 levels, strides (4, 8, 16, 32): ranges MULTISCALE_RANGES
        bb = LFDResNet(block_mode="faster", stem_mode="fast", body_mode=None,
                       stem_channels=32, body_architecture=(1, 1, 1, 1),
                       body_channels=(32, 48, 64, 64),
                       out_indices=((0, 0), (1, 0), (2, 0), (3, 0)), norm_cfg=bn)
        ranges = MULTISCALE_RANGES
        num_heads = 4
    else:
        bb = LFDResNet(block_mode="faster", stem_mode="faster", body_mode=None,
                       stem_channels=32, body_architecture=(2, 1), body_channels=(32, 64),
                       out_indices=((0, 1), (1, 0)), norm_cfg=bn)
        ranges = ((0, 40), (40, 128))
        num_heads = 2
    strides = tuple(bb.num_output_strides_list)
    neck = SimpleNeck(bb.num_output_channels_list, 64, strides, norm_cfg=bn)
    gn = dict(type="GroupNorm", num_groups=8)

    if family == "fcos":
        head = FCOSHead(2, 64, num_heads=num_heads, num_head_channels=64, num_layers=1,
                        norm_cfg=gn)
        return FCOS(backbone=bb, neck=neck, head=head, num_classes=2,
                    regression_ranges=ranges, point_strides=strides,
                    classification_loss_func=FocalLoss(), regression_loss_func=IoULoss(),
                    classification_threshold=0.3)

    cls_type = "QualityFocalLoss" if family == "lfdv2q" else "FocalLoss"
    head = LFDHead(2, num_heads, 64, num_head_channels=64, num_conv_layers=1, norm_cfg=gn,
                   share_head_flag=True, merge_path_flag=True,
                   classification_loss_type=cls_type, regression_loss_type="IoULoss")
    common = dict(backbone=bb, neck=neck, head=head, num_classes=2,
                  regression_ranges=ranges, point_strides=strides,
                  regression_loss_func=IoULoss(), classification_threshold=0.3)
    if family == "lfd":
        return LFD(classification_loss_func=FocalLoss(), distance_to_bbox_mode="sigmoid",
                   **common)
    if family == "lfdv2":
        return LFDv2(classification_loss_func=FocalLoss(), distance_to_bbox_mode="sigmoid",
                     **common)
    if family == "lfdv2q":
        return LFDv2Q(classification_loss_func=QualityFocalLoss(), **common)
    raise ValueError(family)


def scenes(multiscale=False, zoo_model=None):
    """make_dataset's (size, buckets, num_classes) for a run: 192 px with
    MULTISCALE_BUCKETS (multiscale) or 128 px with 18-48 px boxes, of two
    classes; a zoo model's are single-class ZOO_BUCKETS."""
    size = MULTISCALE_SIZE if multiscale else 128
    if zoo_model is not None:
        return size, ZOO_BUCKETS, 1
    return size, MULTISCALE_BUCKETS if multiscale else ((18, 48),), 2


def per_bucket_recall(det, val_samples, buckets, classification_threshold=0.05, iou_thr=0.3):
    """Recall per scale bucket via det.predict_for_single_image (its net's
    current weights, on its own device): (hits, totals) per bucket.

    IoU 0.3 on purpose: the check exists to catch a silently dead level (no
    detections at that scale at all), not to grade tight localization after
    a short synthetic training; a 2 px offset on an 8 px box already fails
    IoU 0.5."""
    hits = np.zeros(len(buckets))
    totals = np.zeros(len(buckets))

    def bucket_of(w, h):
        m = max(w, h)
        for bi, (lo, hi) in enumerate(buckets):
            if lo <= m <= hi + 1:
                return bi
        return int(np.argmin([abs(m - (lo + hi) / 2) for lo, hi in buckets]))

    for s in val_samples.values():
        rows = det.predict_for_single_image(
            s["image"].astype(np.float32) / 127.5 - 1.0,
            classification_threshold=classification_threshold)
        det_boxes = np.asarray([r[2:6] for r in rows], np.float64).reshape(-1, 4)
        for (x, y, w, h) in s["bboxes"]:
            bi = bucket_of(w, h)
            totals[bi] += 1
            if not len(det_boxes):
                continue
            ix1 = np.maximum(det_boxes[:, 0], x)
            iy1 = np.maximum(det_boxes[:, 1], y)
            ix2 = np.minimum(det_boxes[:, 0] + det_boxes[:, 2], x + w)
            iy2 = np.minimum(det_boxes[:, 1] + det_boxes[:, 3], y + h)
            inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
            union = det_boxes[:, 2] * det_boxes[:, 3] + w * h - inter
            if (inter / np.maximum(union, 1e-9) > iou_thr).any():
                hits[bi] += 1
    return hits, totals


def engine_switches(det, name):
    """compile_inference's switches for the engine ENGINES[name] of det."""
    from lfdtpu_torch.deploy.kernel_net import eligible_stem

    switches = dict(ENGINES[name])
    if name == "bf16" and eligible_stem(det.net):
        switches["kernel_stem"] = True
    return switches


def _score(det, engine, val_samples, ann_path, num_classes):
    from lfdtpu_torch.evaluation import COCOEvaluator

    ev = COCOEvaluator(ann_path, {i: i + 1 for i in range(num_classes)})
    for s in val_samples.values():
        rows = det.predict_for_single_image_with_engine(engine, s["image"])
        ev.update([rows], [{"image_id": s["image_id"]}])
    ev.evaluate()
    return float(ev.metrics.get("mAP_50", 0.0))


def engine_quality_eval(det, train_samples, val_samples, ann_path, size,
                        precisions=("fp32", "int8"), num_classes=2, device=None,
                        on_engine=None):
    """mAP_50 of the trained model (det.net's current weights) through
    deployment engines at (size, size), one for each name of ENGINES in
    `precisions`. The int8 engines are calibrated on real training frames
    (calibrate_module_amax on the first CALIBRATION_FRAMES, in batches of
    CALIBRATION_BATCH); comparing their mAP with the fp32 engine's is the
    accuracy leg of the int8 engine.

    device: where the engines run (the card unless the caller asks for the
    CPU). on_engine(name, engine, score): a caller's wrapper around each
    engine's scoring, where score() runs the val set through the engine and
    returns its mAP_50; it returns that mAP (chip_smoke.py counts the
    engines' launches with it). Returns {name: mAP_50}."""
    from lfdtpu_torch.deploy import (calibrate_module_amax, compile_inference,
                                     make_device_preprocess)
    from lfdtpu_torch.device import resolve_device

    device = resolve_device(device)
    pre = make_device_preprocess(MEAN, STD)
    train_imgs = [s["image"] for s in train_samples.values()]
    calib_batches = [np.stack(train_imgs[i:i + CALIBRATION_BATCH])
                     for i in range(0, CALIBRATION_FRAMES, CALIBRATION_BATCH)]
    act_scales = calibrate_module_amax(det, calib_batches,
                                       preprocess=copy.deepcopy(pre).to(device))
    maps = {}
    for name in precisions:
        switches = engine_switches(det, name)
        engine = compile_inference(
            det, (size, size), preprocess=pre, classification_threshold=0.05, device=device,
            act_scales=act_scales if switches["precision"] == "int8" else None, **switches)

        def score(engine=engine):
            return _score(det, engine, val_samples, ann_path, num_classes)

        maps[name] = score() if on_engine is None else on_engine(name, engine, score)
        del engine
    print("ENGINE QUALITY (mAP_50 per engine):", maps)
    return maps


def _require(ok, message):
    if not ok:
        raise AssertionError(message)


def run_synthetic(family="lfd", multiscale=False, epochs=60, threshold=0.5,
                  recall_threshold=0.6, seed=0, base_lr=0.05, clip_whole_run=False,
                  engine_quality=False, zoo_model=None, device=None,
                  precisions=("fp32", "int8"), on_engine=None):
    """Train `family` (or the zoo model `zoo_model`, e.g. 'WIDERFACE-L', on
    single-class boxes sized for its ranges) on TRAIN_IMAGES synthetic
    images for `epochs` epochs on `device` (the card unless the caller asks
    for the CPU) with lfdtpu's config, score the VAL_IMAGES val images
    through the Executor's val loop, and raise AssertionError when mAP_50
    is not above `threshold` (or, multiscale, a range's recall is below
    `recall_threshold`). engine_quality: also score the trained net through
    the engines in `precisions` (engine_quality_eval, with `on_engine`).
    Returns the evaluator's metrics, with per_range_recall (multiscale) and
    engine_mAP_50 (engine_quality). The temporary directory (the val
    annotations, the work dir) is removed."""
    from lfdtpu_torch.data import (Compose, DataLoader, IdleRegionSampler,
                                   RandomBBoxCropRegionSampler,
                                   RandomBBoxCropWithRangeSelectionRegionSampler,
                                   RandomDatasetSampler, simple_normalize)
    from lfdtpu_torch.device import resolve_device
    from lfdtpu_torch.evaluation import COCOEvaluator
    from lfdtpu_torch.execution import Executor, MultiStepLRSchedule, SGD, WarmupSetting

    device = resolve_device(device)
    size, buckets, num_classes = scenes(multiscale, zoo_model)
    train_samples, _ = make_dataset(TRAIN_IMAGES, seed=seed, size=size, buckets=buckets,
                                    num_classes=num_classes)
    val_samples, val_coco = make_dataset(VAL_IMAGES, seed=seed + 1, size=size,
                                         buckets=buckets, num_classes=num_classes)
    tmp = tempfile.mkdtemp(prefix="lfd_synthetic_")
    try:
        ann_path = os.path.join(tmp, "val.json")
        with open(ann_path, "w") as f:
            json.dump(val_coco, f)

        train_ds, val_ds = MemDataset(train_samples), MemDataset(val_samples)
        if zoo_model is not None:
            from lfdtpu_torch.zoo import ZOO

            det = ZOO[zoo_model]()
        else:
            det = build_detector(family, multiscale=multiscale)

        pipeline = Compose([simple_normalize])
        if multiscale:
            # the reference's scale-aware mechanism: every crop resizes a
            # chosen GT box into a chosen detection range, so that all scale
            # branches train (`region_sampler.py:147-258`)
            region_sampler = RandomBBoxCropWithRangeSelectionRegionSampler(
                crop_size=size, detection_ranges=MULTISCALE_RANGES, range_mode="longer")
        else:
            region_sampler = RandomBBoxCropRegionSampler(
                crop_size=size, resize_range=(0.8, 1.25), resize_prob=0.5)
        train_loader = DataLoader(
            train_ds, RandomDatasetSampler(train_ds, batch_size=16, seed=0), region_sampler,
            augmentation_pipeline=pipeline, num_workers=2, max_boxes_per_image=8)
        val_loader = DataLoader(
            val_ds, RandomDatasetSampler(val_ds, batch_size=16, shuffle=False, seed=0),
            IdleRegionSampler(), augmentation_pipeline=pipeline, num_workers=1,
            max_boxes_per_image=8)
        evaluator = COCOEvaluator(ann_path, {i: i + 1 for i in range(num_classes)})

        config = dict(
            work_dir=os.path.join(tmp, "work"), training_epochs=epochs, display_interval=20,
            save_interval=10**6, val_interval=epochs, seed=0, batch_size=16,
            input_hw=(size, size), model=det, device=str(device),
            optimizer=SGD(momentum=0.9, weight_decay=1e-4),
            lr_schedule=MultiStepLRSchedule(
                base_lr=base_lr, milestones=(int(epochs * 0.7),), gamma=0.1,
                warmup=WarmupSetting(warmup_mode="linear", warmup_loops=40,
                                     warmup_ratio=0.1)),
            optimizer_grad_clip_cfg=dict(max_norm=10,
                                         duration=epochs * 4 if clip_whole_run else 3),
            train_data_loader=train_loader, val_data_loader=val_loader, evaluator=evaluator,
        )
        ex = Executor(config)
        ex.run()  # trains det.net in place: Executor.state.net is the same module
        metrics = dict(evaluator.metrics)
        label = f"{zoo_model or family}{' multiscale' if multiscale else ''}"
        print(f"FINAL METRICS [{label}]:", metrics)
        _require(metrics.get("mAP_50", 0) > threshold,
                 f"{label}: mAP_50 {metrics.get('mAP_50')} not above {threshold}")
        if multiscale:
            hits, totals = per_bucket_recall(det, val_samples, buckets)
            recalls = hits / np.maximum(totals, 1)
            print("PER-RANGE RECALL:", dict(zip(map(str, buckets), recalls.round(3))))
            _require((totals > 0).all(), "a scale bucket has no val objects")
            for bi, r in enumerate(recalls):
                _require(r >= recall_threshold,
                         f"range {buckets[bi]} recall {r:.2f} < {recall_threshold}")
            metrics["per_range_recall"] = recalls.tolist()
        if engine_quality:
            metrics["engine_mAP_50"] = engine_quality_eval(
                det, train_samples, val_samples, ann_path, size, precisions=precisions,
                num_classes=num_classes, device=device, on_engine=on_engine)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("SYNTHETIC E2E OK")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--family", default="lfd", choices=["lfd", "lfdv2", "lfdv2q", "fcos"])
    ap.add_argument("--multiscale", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card ('cuda')")
    args = ap.parse_args(argv)
    run_synthetic(args.family, args.multiscale, args.epochs, args.threshold,
                  device=args.device)


if __name__ == "__main__":
    main()
