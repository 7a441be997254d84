# The port's TT100K and TrafficLight scripts (lfdtpu_torch/workloads/
# {TT100K_train,TrafficLight_train}) against lfdtpu's (workloads/...), on the
# CPU (LFD_DEVICE=cpu) and on synthetic files:
#   - every script of lfdtpu's two directories has a port counterpart that
#     compiles (TL's two standalone scripts share a _common.py in the port);
#   - the training configs (TT100K _common, TL_LFD_{S,L}) build lfdtpu's
#     config on both augmentation paths, exact: model, crop, Nmax, sampler,
#     optimizer, clip window, lr sequence over 500 iterations; TT100K's
#     device path does not flip, TL's flips with TL_FLIP_P (ROADMAP F4); the
#     device augmentation agrees with lfdtpu's within 1e-3 pixel units;
#   - predict and predict_engine (fp32) on the same weights (an lfdtpu .ckpt
#     and the port's .pth of one bridged init) and the same JPEG: the same
#     number of rows, each within rtol 1e-4 and atol 1e-3
#     (test_torch_widerface_scripts' ROW_TOL; TT100K's 45-class softmax; TL
#     class-agnostic after BGR -> RGB, a file and a folder);
#   - evaluation: TT100K's official-eval summary (accuracy, recall and the
#     right / wrong / miss objects, scores within 1e-3 of the 0-100 scale,
#     boxes within 1e-2 px) and TL's COCO metrics (within 1e-6) equal
#     lfdtpu's, on GT boxes placed at lfdtpu's own predictions so the
#     metrics are not zero;
#   - pack_tt100k and pack_TL give the same pack; generate_neg_images gives
#     the same files, byte for byte; EDA.analyze the same histograms;
#   - the timing scripts keep lfdtpu's defaults.
import importlib.util
import json
import os
import py_compile
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lfdtpu.data as jdata
import lfdtpu.execution as jexe
import lfdtpu_torch.data as tdata
import lfdtpu_torch.execution as texe
from tests.test_torch_bridge import jax_and_port
from tests.test_torch_widerface_scripts import _assert_rows, _write_images

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("TT100K_train", "TrafficLight_train")
PORT = {t: os.path.join(ROOT, "lfdtpu_torch", "workloads", t) for t in TASKS}
JAX = {t: os.path.join(ROOT, "workloads", t) for t in TASKS}
TT, TL = TASKS


def _load(directory, script):
    """The script as a module under a name of its own (both packages' task
    directories hold a predict.py, an evaluation.py, ...)."""
    side = "port" if directory in PORT.values() else "jax"
    name = f"{side}_{os.path.basename(directory)}_{script[:-3]}"
    spec = importlib.util.spec_from_file_location(name, os.path.join(directory, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def jax_script_dirs(monkeypatch):
    """lfdtpu's scripts import their augmentation pipeline by its bare name."""
    for d in JAX.values():
        monkeypatch.syspath_prepend(d)


def test_port_has_every_traffic_script_and_each_compiles():
    for task in TASKS:
        scripts = sorted(f for f in os.listdir(JAX[task]) if f.endswith(".py"))
        assert len(scripts) >= 9, scripts
        for script in scripts + ["_common.py"]:
            path = os.path.join(PORT[task], script)
            assert os.path.isfile(path), f"no port counterpart of {task}/{script}"
            py_compile.compile(path, doraise=True)
    for size in ("S", "L"):  # the same script body, importing the port's _common
        with open(os.path.join(PORT[TT], f"TT100K_LFD_{size}.py")) as f, \
                open(os.path.join(JAX[TT], f"TT100K_LFD_{size}.py")) as g:
            body = lambda text: text[text.index("from _common import"):]
            assert body(f.read()) == body(g.read())


# ------------------------------------------------------------------ configs

@pytest.fixture
def pack(tmp_path):
    rng = np.random.RandomState(0)

    class Parser(tdata.Parser):
        def get_meta_info(self):
            return None

        def generate_sample(self):
            for i in range(12):
                s = tdata.Sample()
                s["image"] = rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)
                if i < 10:
                    s["bboxes"], s["bbox_labels"] = [[50, 60, 20 + i, 24]], [i % 3]
                yield s

    path = str(tmp_path / "pack.pkl")
    tdata.Dataset(parser=Parser(), save_path=path, verbose=False)
    return path


def _configs(tmp_path, monkeypatch, pack, task, size, device_aug):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    for k, v in dict(LFD_DATASET_PATH=pack, LFD_DEVICE_AUG=str(int(device_aug)),
                     LFD_NUM_WORKERS="1", LFD_BATCH_SIZE="4").items():
        monkeypatch.setenv(k, v)
    if task == TT:
        jcfg, tcfg = {}, {}
        for d, cfg in ((JAX[TT], jcfg), (PORT[TT], tcfg)):
            common = _load(d, "_common.py")
            common.prepare_common_settings(cfg, os.path.join(d, f"TT100K_LFD_{size}.py"))
            common.prepare_model(cfg, size)
            common.prepare_data_pipeline(cfg)
            common.prepare_optimizer(cfg)
        return jcfg, tcfg
    script = _load(JAX[TL], f"TL_LFD_{size}.py")  # standalone: module-level config_dict
    for step in ("prepare_common_settings", "prepare_model", "prepare_data_pipeline",
                 "prepare_optimizer"):
        getattr(script, step)()
    common, tcfg = _load(PORT[TL], "_common.py"), {}
    common.prepare_common_settings(tcfg, os.path.join(PORT[TL], f"TL_LFD_{size}.py"))
    common.prepare_model(tcfg, size)
    common.prepare_data_pipeline(tcfg)
    common.prepare_optimizer(tcfg)
    return script.config_dict, tcfg


def _basic(v):
    return isinstance(v, (str, int, float, bool, type(None), tuple, list, dict))


@pytest.mark.parametrize("task,size,device_aug", [(TT, "S", False), (TT, "L", True),
                                                  (TL, "S", True), (TL, "L", False)])
def test_config_builds_lfdtpus(tmp_path, monkeypatch, pack, task, size, device_aug):
    jcfg, tcfg = _configs(tmp_path, monkeypatch, pack, task, size, device_aug)
    assert tcfg.pop("device") == "cuda"  # the workload default; LFD_DEVICE overrides
    skip = {"timestamp", "work_dir", "log_path"}
    assert ({k: v for k, v in tcfg.items() if _basic(v) and k not in skip}
            == {k: v for k, v in jcfg.items() if _basic(v) and k not in skip})
    assert set(tcfg) == set(jcfg)
    jm, tm = jcfg["model"], tcfg["model"]
    for attr in ("num_classes", "regression_ranges", "point_strides", "range_assign_mode",
                 "distance_to_bbox_mode", "gray_ranges", "classification_loss_type",
                 "cls_channels"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.classification_loss_func == type(tm.classification_loss_func)(
        **vars(jm.classification_loss_func))  # QFL beta and weight, CE
    jl, tl = jcfg["train_data_loader"], tcfg["train_data_loader"]
    for attr in ("_batch_size", "_loops", "_num_workers", "_max_boxes", "_image_dtype"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    js, ts = jl._dataset_sampler, tl._dataset_sampler
    assert (ts._num_pos, ts._num_neg, ts._shuffle) == (js._num_pos, js._num_neg, js._shuffle)
    jr, tr = jl._region_sampler, tl._region_sampler
    if device_aug:
        assert (tr.crop_size, tr.buffer_size, tr._flip_p) == (jr.crop_size, jr.buffer_size,
                                                              jr._flip_p)
        if task == TT:
            assert tr._flip_p == 0.0  # signs are not symmetric
        else:
            from lfdtpu_torch.workloads.TrafficLight_train.TL_augmentation_pipeline import (
                TL_FLIP_P)

            assert tr._flip_p == TL_FLIP_P == 0.5  # lfdtpu's flip (ROADMAP F4)
        jr, tr = jr._inner, tr._inner
    else:
        jp, tp = jl._augmentation_pipeline, tl._augmentation_pipeline
        assert [type(t).__name__ for t in tp.transforms] == [
            type(t).__name__ for t in jp.transforms]
        for a, b in zip(tp.transforms, jp.transforms):
            assert vars(a).keys() == vars(b).keys()
            assert all(np.array_equal(vars(a)[k], vars(b)[k]) for k in vars(a)), vars(a)
    assert type(tr).__name__ == type(jr).__name__
    assert vars(tr) == vars(jr)  # crop, resize range and prob
    assert (tcfg["optimizer"].momentum, tcfg["optimizer"].weight_decay) == (
        jcfg["optimizer"].momentum, jcfg["optimizer"].weight_decay)
    lrs = lambda cfg: [cfg["lr_schedule"](it, it) for it in range(500)]
    assert lrs(tcfg) == lrs(jcfg) and len(set(lrs(tcfg))) > 200
    assert ("device_augment" in tcfg) == ("device_augment" in jcfg) == device_aug


@pytest.mark.parametrize("task", [TT, TL])
def test_device_aug_config_matches_lfdtpu(tmp_path, monkeypatch, pack, task):
    jcfg, tcfg = _configs(tmp_path, monkeypatch, pack, task, "S", True)
    crop = tcfg["input_hw"][0]
    rng = np.random.RandomState(1)
    batch = dict(buffer=rng.randint(0, 256, (2, 2 * crop, 2 * crop, 3)).astype(np.uint8),
                 scale=rng.uniform(0.5, 1.5, (2, 2)).astype(np.float32),
                 translation=rng.uniform(-crop / 2, 0, (2, 2)).astype(np.float32),
                 flip=np.asarray([0, 1], np.float32))
    ref = np.asarray(jcfg["device_augment"]({k: jnp.asarray(v) for k, v in batch.items()}))
    got = tcfg["device_augment"]({k: torch.as_tensor(v) for k, v in batch.items()}).numpy()
    assert got.shape == ref.shape == (2, crop, crop, 3)
    # pixel units: TT100K divides by 127.5, TL by 255 x imagenet's std
    assert np.abs(got - ref).max() <= 1e-3 / (0.5 * 255 if task == TT else 0.225 * 255)


# -------------------------------------------------------- predict, engine

@pytest.fixture
def checkpoints(tmp_path, monkeypatch):
    """TT100K-S and TL-S inits, each as an lfdtpu .ckpt and a port .pth."""
    monkeypatch.setenv("LFD_DEVICE", "cpu")
    out = {}
    for task, name in ((TT, "TT100K-S"), (TL, "TL-S")):
        _, variables, tdet = jax_and_port(name)
        jpath, tpath = str(tmp_path / f"{name}.ckpt"), str(tmp_path / f"{name}.pth")
        jexe.save_checkpoint(jpath, {"params": variables["params"],
                                     "batch_stats": variables["batch_stats"]})
        texe.save_checkpoint(tpath, tdet.net)
        out[task] = (jpath, tpath)
    return out


THR = {TT: 0.02, TL: 0.05}  # random weights: 45-class softmax scores sit near 1/46


def test_tt100k_predict_scripts_match_lfdtpus(tmp_path, checkpoints, capsys):
    jpath, tpath = checkpoints[TT]
    image, = _write_images(str(tmp_path), {"img.jpg": (100, 120)}, seed=11)
    ref = _load(JAX[TT], "predict.py").predict(
        "S", jpath, image, classification_threshold=THR[TT], out_path=str(tmp_path / "j.jpg"))
    got = _load(PORT[TT], "predict.py").predict(
        "S", tpath, image, classification_threshold=THR[TT], out_path=str(tmp_path / "t.jpg"))
    _assert_rows(got, ref)
    assert len({r[0] for r in got}) > 1  # several of the 45 classes
    from lfdtpu_torch.data import TT100K_TYPE45

    assert TT100K_TYPE45[int(got[0][0])] in capsys.readouterr().out
    eng_ref = _load(JAX[TT], "predict_engine.py").predict_with_engine(
        "S", jpath, image, precision="fp32", classification_threshold=THR[TT],
        out_path=str(tmp_path / "je.jpg"))
    port = _load(PORT[TT], "predict_engine.py")
    eng = port.predict_with_engine("S", tpath, image, precision="fp32",
                                   classification_threshold=THR[TT],
                                   out_path=str(tmp_path / "te.jpg"))
    _assert_rows(eng, eng_ref)
    assert os.path.getsize(tmp_path / "te.jpg") > 0
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        port.predict_with_engine("S", tpath, image, engine_file=str(tmp_path / "e.lfde"))
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        port.predict_with_engine("S", tpath, image, precision="int8")


def test_tl_predict_scripts_match_lfdtpus(tmp_path, checkpoints):
    jpath, tpath = checkpoints[TL]
    folder = tmp_path / "imgs"
    a, b = _write_images(str(folder), {"a.jpg": (90, 130), "b.jpg": (128, 96)}, seed=12)
    (tmp_path / "jo").mkdir()
    (tmp_path / "to").mkdir()
    jp, tp = _load(JAX[TL], "predict.py"), _load(PORT[TL], "predict.py")
    ref = jp.predict("S", jpath, str(folder), classification_threshold=THR[TL],
                     out_dir=str(tmp_path / "jo"))
    got = tp.predict("S", tpath, str(folder), classification_threshold=THR[TL],
                     out_dir=str(tmp_path / "to"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _assert_rows(g, r)
        assert all(row[0] == 0 for row in g)  # class-agnostic, one class
    assert sorted(os.listdir(tmp_path / "to")) == ["a_result.jpg", "b_result.jpg"]
    _assert_rows(tp.predict("S", tpath, a, classification_threshold=THR[TL],
                            out_dir=str(tmp_path / "to")), ref[0])
    eng_ref = _load(JAX[TL], "predict_engine.py").predict_with_engine(
        "S", jpath, b, precision="fp32", classification_threshold=THR[TL],
        out_path=str(tmp_path / "je.jpg"))
    eng = _load(PORT[TL], "predict_engine.py").predict_with_engine(
        "S", tpath, b, precision="fp32", classification_threshold=THR[TL],
        out_path=str(tmp_path / "te.jpg"))
    _assert_rows(eng, eng_ref)


# -------------------------------------------------------------- evaluation

def _jax_rows(name, image_path, pipeline, thr, **kw):
    """lfdtpu's predict rows on one image: where the synthetic GT goes."""
    import cv2

    jdet, variables, _ = jax_and_port(name)
    v = {"params": variables["params"], "batch_stats": variables["batch_stats"]}
    return jdet.predict_for_single_image(v, cv2.imread(image_path, cv2.IMREAD_UNCHANGED),
                                         aug_pipeline=pipeline,
                                         classification_threshold=thr, **kw)


def test_tt100k_evaluation_summary_matches_lfdtpus(tmp_path, checkpoints):
    from lfdtpu_torch.data import TT100K_TYPE45

    jpath, tpath = checkpoints[TT]
    root = tmp_path / "data"
    ids = ["10", "11", "12"]
    _write_images(str(root), {f"test/{i}.jpg": (96 + 16 * n, 128) for n, i in enumerate(ids)},
                  seed=13)
    pipeline = _load(JAX[TT], "TT100K_augmentation_pipeline.py").tt100k_val_pipeline
    imgs = {}
    for i in ids:  # GT at a few of lfdtpu's detections (one relabeled: a wrong class)
        rows = _jax_rows("TT100K-S", str(root / "test" / f"{i}.jpg"), pipeline, 0.02)
        objs = [dict(category=TT100K_TYPE45[(int(r[0]) + (k == 1)) % 45],
                     bbox=dict(xmin=r[2], ymin=r[3], xmax=r[2] + r[4], ymax=r[3] + r[5]))
                for k, r in enumerate(rows[:3])]
        objs.append(dict(category="pl40", bbox=dict(xmin=1, ymin=2, xmax=30, ymax=33)))
        imgs[i] = dict(path=f"test/{i}.jpg", objects=objs)
    (root / "annotations.json").write_text(json.dumps({"imgs": imgs}))
    (root / "test" / "ids.txt").write_text("\n".join(ids))
    kw = dict(data_root=str(root), annotation_json=str(root / "annotations.json"),
              test_id_file=str(root / "test" / "ids.txt"), classification_threshold=0.02)
    for minscore in (0, 90):  # 90: the official setting, which random weights never reach
        ref = _load(JAX[TT], "evaluation.py").evaluate("S", jpath, minscore=minscore, **kw)
        got = _load(PORT[TT], "evaluation.py").evaluate("S", tpath, minscore=minscore, **kw)
        assert got["report"] == ref["report"]
        assert (got["accuracy"], got["recall"]) == (ref["accuracy"], ref["recall"])
        for part in ("right", "wrong", "miss"):
            for i in ids:
                g, r = got[part]["imgs"][i]["objects"], ref[part]["imgs"][i]["objects"]
                assert len(g) == len(r), (part, i)
                for a, b in zip(g, r):
                    assert a["category"] == b["category"]
                    assert abs(a.get("score", 0) - b.get("score", 0)) < 1e-3
                    for k in a["bbox"]:
                        assert abs(a["bbox"][k] - b["bbox"][k]) < 1e-2
    assert got["recall"] == 0.0 and ref["recall"] == 0.0  # minscore 90 excludes all
    got0 = _load(PORT[TT], "evaluation.py").evaluate("S", tpath, minscore=0, **kw)
    assert 0 < got0["recall"] < 1 and sum(
        len(v["objects"]) for v in got0["right"]["imgs"].values()) >= len(ids)


def _coco_files(tmp_path, with_predictions_of=None):
    """A COCO-format TL set: 4 images (one under 32 px, dropped by the pack;
    one without boxes, kept), two categories (ids 3 and 7), an invalid box."""
    root = tmp_path / "TL" / "images"
    shapes = {"a.jpg": (96, 128), "b.jpg": (128, 160), "c.jpg": (24, 64), "d.jpg": (80, 120)}
    _write_images(str(root), shapes, seed=14)
    images = [dict(id=n + 1, file_name=f, height=h, width=w)
              for n, (f, (h, w)) in enumerate(shapes.items())]
    anns = []
    for im in images[:3]:
        boxes = [[5.0, 6.0, 20.0, 24.0], [40.5, 30.0, 11.0, 30.0]]
        if with_predictions_of is not None and im["height"] >= 32:
            boxes += [r[2:] for r in with_predictions_of(str(root / im["file_name"]))[:3]]
        for k, b in enumerate(boxes):
            anns.append(dict(id=len(anns) + 1, image_id=im["id"], category_id=(3, 7)[k % 2],
                             bbox=b, area=b[2] * b[3], iscrowd=0))
    anns.append(dict(id=len(anns) + 1, image_id=1, category_id=3, bbox=[-3, 4, 10, 10],
                     area=100, iscrowd=0))
    ann_path = tmp_path / "TL" / "train.json"
    ann_path.write_text(json.dumps(dict(images=images, annotations=anns, categories=[
        dict(id=3, name="red"), dict(id=7, name="green")])))
    return str(ann_path), str(root)


def test_tl_pack_eda_and_evaluation_match_lfdtpus(tmp_path, checkpoints):
    jpath, tpath = checkpoints[TL]
    pipeline = _load(JAX[TL], "TL_augmentation_pipeline.py").tl_val_pipeline
    ann, root = _coco_files(tmp_path, lambda p: _jax_rows("TL-S", p, pipeline, THR[TL],
                                                          class_agnostic=True))
    packs = {}
    for side, d, pkg in (("j", JAX[TL], jdata), ("t", PORT[TL], tdata)):
        path = str(tmp_path / f"tl_{side}.pkl")
        ds = _load(d, "pack_TL.py").pack(ann, root, save_path=path)
        assert len(ds) == 3  # c.jpg is under filter_min_size 32; d.jpg has no box
        packs[side] = (path, pkg.Dataset(load_path=path))
    (jp, j), (tp, t) = packs["j"], packs["t"]
    assert t.get_indexes() == j.get_indexes() and t.meta_info == j.meta_info
    for i in t.get_indexes():
        assert dict(t[i]) == dict(j[i]), i
    assert t.meta_info["label_indexes_to_category_ids"] == {0: 3, 1: 7}
    hists = [_load(d, "EDA.py").analyze(p) for d, p in ((JAX[TL], jp), (PORT[TL], tp),
                                                        (PORT[TL], jp))]
    assert hists[1] == hists[0] == hists[2] and sum(hists[1]["sqrt"].values()) > 4

    kw = dict(val_annotation_path=ann, val_image_root=root, classification_threshold=THR[TL])
    ref = _load(JAX[TL], "evaluation.py").evaluate("S", jpath, val_dataset_pkl=jp, **kw)
    got = _load(PORT[TL], "evaluation.py").evaluate("S", tpath, val_dataset_pkl=tp, **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-6, k
    assert max(got.values()) > 0  # the GT at lfdtpu's detections is found


# ---------------------------------------------------------- TT100K packing

def test_tt100k_neg_images_and_pack_match_lfdtpus(tmp_path):
    root = tmp_path / "data"
    ids = ["1", "2", "3", "4"]
    shapes = {f"train/{i}.jpg": (400 + 20 * n, 520) for n, i in enumerate(ids)}
    _write_images(str(root), shapes, seed=15)
    box = lambda x0, y0, x1, y1: dict(xmin=x0, ymin=y0, xmax=x1, ymax=y1)
    objects = {
        "1": [dict(category="pl40", bbox=box(200, 180, 230, 215)),
              dict(category="pn", bbox=box(240.5, 190, 270, 222))],
        "2": [dict(category="zz", bbox=box(10, 10, 40, 40))],  # not a type45 sign: negative
        "3": [dict(category="w57", bbox=box(20, 30, 60, 70)),
              dict(category="io", bbox=box(-2, 5, 30, 40)),  # outside the image: dropped
              dict(category="i5", bbox=box(100, 100, 101, 101))],  # 2 px wide: dropped
        "4": [],
    }
    (root / "annotations.json").write_text(json.dumps({"imgs": {
        i: dict(path=f"train/{i}.jpg", objects=objects[i]) for i in ids}}))
    (root / "train" / "ids.txt").write_text("\n".join(ids))

    negs = {}
    for side, d in (("j", JAX[TT]), ("t", PORT[TT])):
        n = _load(d, "generate_neg_images.py").generate_neg_images(
            str(root), "train", f"neg_{side}", min_size_threshold=150)
        out = root / f"neg_{side}"
        negs[side] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        assert n == len(negs[side]) > 3
    assert negs["t"] == negs["j"]

    packs = {}
    for side, d, pkg in (("j", JAX[TT], jdata), ("t", PORT[TT], tdata)):
        path = str(tmp_path / f"tt_{side}.pkl")
        ds = _load(d, "pack_tt100k.py").pack(
            str(root), str(root / "annotations.json"), str(root / "train" / "ids.txt"),
            neg_image_root=str(root / "neg_t"), save_path=path)
        assert len(ds) == len(ids) + len(negs["t"])
        packs[side] = pkg.Dataset(load_path=path)
    j, t = packs["j"], packs["t"]
    assert t.get_indexes() == j.get_indexes() and t.meta_info == j.meta_info
    for i in t.get_indexes():
        assert dict(t[i]) == dict(j[i]), i
    assert t[0]["bboxes"] == [[200, 180, 31, 36], [240.5, 190, 30.5, 33]]
    assert t[0]["bbox_labels"] == [t.meta_info["category_names_to_label_indexes"][c]
                                   for c in ("pl40", "pn")]
    assert "bboxes" not in t[1] and t[2]["bboxes"] == [[20, 30, 41, 41]]


@pytest.mark.parametrize("task,defaults", [
    (TT, ("S", "bf16", ((480, 640), (720, 1280), (1080, 1920), (2160, 3840)), 50)),
    (TL, ("S", "fp32", ((720, 1280),), 1000)),
])
def test_timing_scripts_keep_lfdtpus_defaults(task, defaults):
    port = _load(PORT[task], "timing_inference_latency.py")
    ref = _load(JAX[task], "timing_inference_latency.py")
    names = ("model_size", "precision_mode", "resolutions", "timing_loops")
    assert tuple(getattr(port, n) for n in names) == tuple(getattr(ref, n) for n in names) \
        == defaults
