# The port's copy of the evaluation package (lfdtpu_torch/evaluation: numpy
# COCO mAP, the COCOEvaluator, the TT100K matcher, the WIDERFACE SIO writer)
# against lfdtpu's: the 10 cases of tests/test_evaluation.py and the 3 of
# tests/test_coco_eval_oracle.py, each fed to lfdtpu's function and to the
# port's copy. The outputs must be EQUAL (the same numpy code), and each case
# keeps the assertion of the test it mirrors.
import json

import numpy as np
import pytest

import lfdtpu.evaluation as jev
import lfdtpu_torch.evaluation as tev
from tests.test_coco_eval_oracle import PyCocoMirror, _random_fixture, _to_lfdtpu_format


def _both(name, *args, **kw):
    ref = getattr(jev, name)(*args, **kw)
    got = getattr(tev, name)(*args, **kw)
    assert got == ref, name
    return got


COCO_CASES = {
    "perfect_predictions": (
        {(1, 1): ([[10, 10, 40, 40]], [False]),
         (2, 1): ([[5, 5, 20, 20], [100, 100, 50, 50]], [False, False])},
        {(1, 1): ([[10, 10, 40, 40]], [0.9]),
         (2, 1): ([[5, 5, 20, 20], [100, 100, 50, 50]], [0.8, 0.95])},
        lambda m: m["mAP"] > 0.99 and m["mAP_50"] > 0.99),
    "false_positive_penalty": (
        {(1, 1): ([[10, 10, 40, 40]], [False])},
        {(1, 1): ([[10, 10, 40, 40], [200, 200, 40, 40]], [0.8, 0.95])},
        lambda m: 0.4 < m["mAP_50"] < 0.75),
    "localization_threshold": (
        {(1, 1): ([[10, 10, 40, 40]], [False])},
        {(1, 1): ([[10, 10, 25, 40]], [0.9])},
        lambda m: m["mAP_50"] > 0.99 and m["mAP_75"] < 0.01),
    "crowd_ignored": (
        {(1, 1): ([[10, 10, 40, 40], [100, 100, 80, 80]], [False, True])},
        {(1, 1): ([[10, 10, 40, 40], [100, 100, 80, 80]], [0.9, 0.8])},
        lambda m: m["mAP"] > 0.99),
}


@pytest.mark.parametrize("case", list(COCO_CASES))
def test_coco_map_cases_equal_lfdtpu(case):
    gt, det, holds = COCO_CASES[case]
    assert holds(_both("coco_map", gt, det, [1]))


def test_coco_evaluator_streaming_equals_lfdtpu(tmp_path):
    ann = {
        "images": [{"id": 1, "height": 100, "width": 100, "file_name": "a.jpg"}],
        "annotations": [{"id": 1, "image_id": 1, "category_id": 7, "bbox": [10, 10, 40, 40],
                         "iscrowd": 0, "area": 1600}],
        "categories": [{"id": 7, "name": "thing"}],
    }
    path = str(tmp_path / "ann.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    evs = [pkg.COCOEvaluator(path, {0: 7}) for pkg in (jev, tev)]
    for ev in evs:
        ev.update(([[[0, 0.9, 10, 10, 40, 40]]], [{"image_id": 1}]))
        ev.evaluate()
    assert isinstance(evs[1], tev.Evaluator)
    assert evs[1].metrics == evs[0].metrics and evs[1].metrics["mAP"] > 0.99
    assert evs[1].get_eval_display_str() == evs[0].get_eval_display_str()
    assert "mAP" in evs[1].get_eval_display_str()


def _tt_obj(cat, x1, y1, x2, y2, score=None):
    o = dict(category=cat, bbox=dict(xmin=x1, ymin=y1, xmax=x2, ymax=y2))
    if score is not None:
        o["score"] = score
    return o


TT_CASES = {
    "basic": (
        [_tt_obj("pn", 10, 10, 50, 50), _tt_obj("i2", 100, 100, 140, 140)],
        [_tt_obj("pn", 12, 11, 49, 52, score=95), _tt_obj("i2", 200, 200, 240, 240, score=99)],
        dict(iou=0.5, types=["pn", "i2"], minscore=90), (0.5, 0.5)),
    "minscore_filter": (
        [_tt_obj("pn", 10, 10, 50, 50)], [_tt_obj("pn", 10, 10, 50, 50, score=50)],
        dict(iou=0.5, minscore=90), (1.0, 0.0)),
    "size_window": (
        [_tt_obj("pn", 0, 0, 500, 500)], [_tt_obj("pn", 0, 0, 500, 500, score=99)],
        dict(iou=0.5, minscore=90, maxboxsize=400), (1.0, 1.0)),
}


@pytest.mark.parametrize("case", list(TT_CASES))
def test_tt100k_eval_cases_equal_lfdtpu(case):
    gt_objs, rt_objs, kw, (accuracy, recall) = TT_CASES[case]
    s = _both("tt100k_eval", {"imgs": {"1": {"objects": gt_objs}}},
              {"imgs": {"1": {"objects": rt_objs}}}, **kw)
    assert (s["accuracy"], s["recall"]) == (accuracy, recall)


def test_results_to_tt100k_annos_equals_lfdtpu():
    annos = _both("results_to_tt100k_annos", {"7": [[0, 0.93, 10.0, 20.0, 30.0, 40.0]]},
                  {0: "pn"})
    obj = annos["imgs"]["7"]["objects"][0]
    assert obj["category"] == "pn" and abs(obj["score"] - 93.0) < 1e-6
    assert obj["bbox"]["xmax"] == 40.0


def test_sio_writer_equals_lfdtpu(tmp_path):
    """The txt files of the port's SIO_evaluation (which takes no
    `variables`: the port's detector owns its net) and of lfdtpu's, from
    stub models returning the same rows."""
    import cv2

    rows = [[0, 0.9, 10.2, 20.8, 30.4, 40.6], [0, 1.2, 3.0, 4.0, 5.0, 6.0]]

    class JaxStub:
        def predict_for_single_image(self, variables, image, **kw):
            assert kw["class_agnostic"] and kw["size_divisor"] == 128
            return rows

    class PortStub:
        def predict_for_single_image(self, image, **kw):
            assert kw["class_agnostic"] and kw["size_divisor"] == 128
            return rows

    for event, names in (("event_a", ("pic.jpg", "other.jpeg")), ("event_b", ("x.jpg",))):
        (tmp_path / "val" / event).mkdir(parents=True)
        for name in names:
            cv2.imwrite(str(tmp_path / "val" / event / name), np.zeros((10, 10, 3), np.uint8))
    (tmp_path / "val" / "event_a" / "notes.txt").write_text("not an image")
    nj = jev.SIO_evaluation(JaxStub(), None, str(tmp_path / "val"), str(tmp_path / "j"),
                            aug_pipeline=False, verbose=False)
    nt = tev.SIO_evaluation(PortStub(), str(tmp_path / "val"), str(tmp_path / "t"),
                            aug_pipeline=False, verbose=False)
    assert nt == nj == 3
    files = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.txt"))
    assert files == sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.txt"))
    for rel in files:
        assert (tmp_path / "t" / rel).read_text() == (tmp_path / "j" / rel).read_text()
    out = (tmp_path / "t" / "event_a" / "pic.txt").read_text().splitlines()
    # name, count with the dummy row, the dummy row, floor x/y and ceil w/h,
    # a score above 1 written as 1
    assert out == ["pic", "3", "0 0 0 0 0.001", "10 20 31 41 0.900", "3 4 5 6 1.000"]


def _oracle(seed, drop_category=None, **fixture_kw):
    """lfdtpu's and the port's coco_map on a random fixture, both against
    the transcription of pycocotools in tests/test_coco_eval_oracle.py."""
    gts, dts = _random_fixture(seed, **fixture_kw)
    dts = [d for d in dts if d["category_id"] != drop_category]
    mirror = PyCocoMirror(gts, dts)
    mirror.accumulate()
    want = mirror.summarize()
    got = _both("coco_map", *_to_lfdtpu_format(gts, dts, 4))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, err_msg=f"{k} seed={seed}")
    return want


def test_coco_map_matches_pycocotools_transcription_and_lfdtpu():
    for seed in (0, 1, 2):
        want = _oracle(seed)
    assert 0.0 < want["mAP"] < 1.0


def test_coco_map_maxdets_column_differs_as_lfdtpu():
    gt_by, det_by, cats = _to_lfdtpu_format(*_random_fixture(7), 4)
    a = _both("coco_map", gt_by, det_by, cats, max_dets=(100, 300, 1000))
    b = _both("coco_map", gt_by, det_by, cats, max_dets=(1000,))
    assert a["mAP"] != b["mAP"]


def test_coco_map_no_dets_for_category_as_lfdtpu():
    _oracle(3, drop_category=2, n_images=8)
