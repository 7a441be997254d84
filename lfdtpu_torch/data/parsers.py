# Dataset parsers, a copy of `lfdtpu/data/parsers.py` (reference
# `lfd/data_pipeline/dataset/{base_parser,widerface_parser,coco_parser,
# tt100k_parser}.py`).
#
# COCOParser reads annotation JSON directly (no pycocotools dependency);
# behavior — category-id <-> 0-based-label maps, small-image and bad-box
# filtering, disk-based paths + image_id/original_{height,width} meta —
# matches `coco_parser.py:10-77`.

from __future__ import annotations

import json
import os

from .sample import Sample

__all__ = ["Parser", "WIDERFACEParser", "COCOParser", "TT100KParser", "TT100K_TYPE45"]


class Parser:
    """Protocol (`base_parser.py:4-10`)."""

    def get_meta_info(self):
        raise NotImplementedError

    def generate_sample(self):
        raise NotImplementedError


class WIDERFACEParser(Parser):
    """WIDERFACE txt annotation walker (`widerface_parser.py:9-77`).

    Embeds image bytes in each sample (memory-based dataset); single class,
    label 0; invalid boxes (x<0, y<0, w<=0, h<=0) filtered; optional neg
    images (samples without a 'bboxes' key) appended from neg_image_root.
    """

    def __init__(self, annotation_file_path, image_root, neg_image_root=None):
        assert os.path.exists(annotation_file_path)
        assert os.path.exists(image_root)
        if neg_image_root is not None:
            assert os.path.exists(neg_image_root)
        self._annotation_file_path = annotation_file_path
        self._image_root = image_root
        self._neg_image_root = neg_image_root

    def get_meta_info(self):
        return None

    def generate_sample(self):
        with open(self._annotation_file_path, "r") as fin:
            lines = [ln.rstrip("\n") for ln in fin]
        i = 0
        current_path = None
        while i < len(lines):
            line = lines[i]
            if line.endswith(".jpg"):
                current_path = os.path.join(self._image_root, line)
                i += 1
                continue
            n = int(line)
            i += 1
            bboxes = []
            # a "0" annotation count is followed by one dummy all-zero row
            rows = max(n, 1)
            for _ in range(rows):
                parts = lines[i].split(" ")
                i += 1
                x, y, w, h = (int(parts[k]) for k in range(4))
                if x < 0 or y < 0 or w <= 0 or h <= 0:
                    continue
                bboxes.append([x, y, w, h])
            sample = Sample()
            sample["image_path"] = current_path
            with open(current_path, "rb") as f:
                sample["image_bytes"] = f.read()
            if bboxes:
                sample["bboxes"] = bboxes
                sample["bbox_labels"] = [0] * len(bboxes)
            yield sample

        if self._neg_image_root is not None:
            for name in sorted(os.listdir(self._neg_image_root)):
                if not name.lower().endswith("jpg"):
                    continue
                path = os.path.join(self._neg_image_root, name)
                sample = Sample()
                sample["image_path"] = path
                with open(path, "rb") as f:
                    sample["image_bytes"] = f.read()
                yield sample


class COCOParser(Parser):
    """COCO-format parser without pycocotools (`coco_parser.py:10-77`)."""

    def __init__(self, coco_annotation_path, image_root, filter_no_gt=True, filter_min_size=32):
        assert os.path.exists(coco_annotation_path)
        assert os.path.exists(image_root)
        assert filter_min_size >= 0
        self._image_root = image_root
        self._filter_no_gt = filter_no_gt
        self._filter_min_size = filter_min_size

        with open(coco_annotation_path, "r") as f:
            data = json.load(f)
        self._images = {im["id"]: im for im in data["images"]}
        self._anns_by_image = {}
        for ann in data.get("annotations", []):
            self._anns_by_image.setdefault(ann["image_id"], []).append(ann)

        category_ids = sorted(c["id"] for c in data.get("categories", []))
        names = {c["id"]: c["name"] for c in data.get("categories", [])}
        self._category_ids_to_label_indexes = {cid: i for i, cid in enumerate(category_ids)}
        self._label_indexes_to_category_ids = {i: cid for i, cid in enumerate(category_ids)}
        self._category_ids_to_category_names = {cid: names[cid] for cid in category_ids}

    def get_meta_info(self):
        return {
            "category_ids_to_label_indexes": self._category_ids_to_label_indexes,
            "label_indexes_to_category_ids": self._label_indexes_to_category_ids,
            "category_ids_to_category_names": self._category_ids_to_category_names,
        }

    def generate_sample(self):
        for image_id, info in self._images.items():
            if min(info["height"], info["width"]) < self._filter_min_size:
                continue
            bboxes, cat_ids = [], []
            for ann in self._anns_by_image.get(image_id, []):
                bbox = ann["bbox"]
                if min(bbox[:2]) < 0 or min(bbox[2:]) <= 0:
                    continue
                bboxes.append(list(bbox))
                cat_ids.append(ann["category_id"])
            if self._filter_no_gt and not bboxes:
                continue
            sample = Sample()
            sample["image_id"] = image_id
            sample["image_path"] = os.path.join(self._image_root, info["file_name"])
            sample["image_type"] = info["file_name"].split(".")[-1].lower()
            sample["original_height"] = info["height"]
            sample["original_width"] = info["width"]
            if bboxes:
                sample["bboxes"] = bboxes
                sample["bbox_labels"] = [
                    self._category_ids_to_label_indexes[c] for c in cat_ids
                ]
            yield sample


TT100K_TYPE45 = (
    "i2,i4,i5,il100,il60,il80,io,ip,p10,p11,p12,p19,p23,p26,p27,p3,p5,p6,pg,"
    "ph4,ph4.5,ph5,pl100,pl120,pl20,pl30,pl40,pl5,pl50,pl60,pl70,pl80,pm20,"
    "pm30,pm55,pn,pne,po,pr40,w13,w32,w55,w57,w59,wo"
).split(",")


class TT100KParser(Parser):
    """TT100K json parser, 45-class subset (`tt100k_parser.py:9-80`).

    Boxes converted xyxy -> xywh with +1 inclusive widths; invalid boxes
    (x<0, y<0, w<=2, h<=2) filtered; disk-based paths; optional neg images.
    """

    def __init__(self, data_root, annotation_json_file_path, id_file_path, neg_image_root=None):
        assert os.path.exists(data_root)
        assert os.path.exists(annotation_json_file_path)
        assert os.path.exists(id_file_path)
        if neg_image_root is not None:
            assert os.path.exists(neg_image_root)
        self._data_root = data_root
        with open(id_file_path) as f:
            self._image_id_list = f.read().splitlines()
        with open(annotation_json_file_path, "r") as f:
            self._annotations = json.load(f)["imgs"]
        if neg_image_root is not None:
            self._neg_image_paths_list = [
                os.path.join(neg_image_root, n)
                for n in sorted(os.listdir(neg_image_root))
                if n.lower().endswith(".jpg")
            ]
        else:
            self._neg_image_paths_list = []
        self._category_names_to_label_indexes = {t: i for i, t in enumerate(TT100K_TYPE45)}
        self._label_indexes_to_category_names = {i: t for i, t in enumerate(TT100K_TYPE45)}

    def get_meta_info(self):
        return {
            "category_names_to_label_indexes": self._category_names_to_label_indexes,
            "label_indexes_to_category_names": self._label_indexes_to_category_names,
        }

    def generate_sample(self):
        for identity in self._image_id_list:
            annotation = self._annotations[identity]
            bboxes, labels = [], []
            for obj in annotation["objects"]:
                if obj["category"] not in self._category_names_to_label_indexes:
                    continue
                x = obj["bbox"]["xmin"]
                y = obj["bbox"]["ymin"]
                w = obj["bbox"]["xmax"] - obj["bbox"]["xmin"] + 1
                h = obj["bbox"]["ymax"] - obj["bbox"]["ymin"] + 1
                if x < 0 or y < 0 or w <= 2 or h <= 2:
                    continue
                bboxes.append([x, y, w, h])
                labels.append(self._category_names_to_label_indexes[obj["category"]])
            sample = Sample()
            sample["image_path"] = os.path.join(self._data_root, annotation["path"])
            if bboxes:
                sample["bboxes"] = bboxes
                sample["bbox_labels"] = labels
            yield sample

        for neg_image_path in self._neg_image_paths_list:
            sample = Sample()
            sample["image_path"] = neg_image_path
            yield sample
