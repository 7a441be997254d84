# The port's WIDERFACE training scripts (lfdtpu_torch/workloads/
# WIDERFACE_train) against lfdtpu's (workloads/WIDERFACE_train): every script
# compiles (as tests/test_workloads.py::test_all_workload_scripts_compile),
# and `_common.prepare_*` builds the same model size, crop, Nmax, sampler
# settings, optimizer, clip window and lr sequence over the first 1000
# iterations (exact), on both augmentation paths; the device path's resample
# and normalize agree with lfdtpu's within 1e-3 pixel units.
import importlib.util
import os
import py_compile
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lfdtpu_torch.data as tdata

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "lfdtpu_torch", "workloads", "WIDERFACE_train")
JAX_DIR = os.path.join(ROOT, "workloads", "WIDERFACE_train")
SIZES = ("XS", "S", "M", "L")


def test_port_workload_scripts_compile():
    for name in ["_common.py"] + [f"WIDERFACE_LFD_{s}.py" for s in SIZES]:
        path = os.path.join(PORT_DIR, name)
        assert os.path.isfile(path), name
        py_compile.compile(path, doraise=True)
        if name != "_common.py":  # the same script, importing the port's _common
            with open(path) as f, open(os.path.join(JAX_DIR, name)) as g:
                body = lambda text: text[text.index("from _common import"):]
                assert body(f.read()) == body(g.read())


def _load(directory, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(directory, "_common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pack(tmp_path):
    rng = np.random.RandomState(0)

    class Parser(tdata.Parser):
        def get_meta_info(self):
            return None

        def generate_sample(self):
            for i in range(6):
                s = tdata.Sample()
                s["image"] = rng.randint(0, 256, (300, 400, 3)).astype(np.uint8)
                if i < 5:
                    s["bboxes"], s["bbox_labels"] = [[50, 60, 40 + i, 40]], [0]
                yield s

    path = str(tmp_path / "pack.pkl")
    tdata.Dataset(parser=Parser(), save_path=path, verbose=False)
    return path


def _configs(tmp_path, monkeypatch, pack, size, device_aug):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    for k, v in dict(LFD_DATASET_PATH=pack, LFD_DEVICE_AUG=str(int(device_aug)),
                     LFD_NUM_WORKERS="1", LFD_BATCH_SIZE="4").items():
        monkeypatch.setenv(k, v)
    out = []
    for directory, name in ((JAX_DIR, "jax_widerface_common"),
                            (PORT_DIR, "port_widerface_common")):
        common = _load(directory, name)
        cfg = {}
        common.prepare_common_settings(cfg, os.path.join(directory, f"WIDERFACE_LFD_{size}.py"))
        common.prepare_model(cfg, size)
        common.prepare_data_pipeline(cfg)
        common.prepare_optimizer(cfg)
        out.append(cfg)
    return out


def _basic(v):
    return isinstance(v, (str, int, float, bool, type(None), tuple, list, dict))


@pytest.mark.parametrize("size,device_aug", [("XS", False), ("S", False), ("M", False),
                                             ("L", True)])
def test_common_builds_lfdtpus_config(tmp_path, monkeypatch, pack, size, device_aug):
    jcfg, tcfg = _configs(tmp_path, monkeypatch, pack, size, device_aug)
    assert tcfg.pop("device") == "cuda"  # the workload default; LFD_DEVICE overrides
    skip = {"timestamp", "work_dir", "log_path"}
    jbasic = {k: v for k, v in jcfg.items() if _basic(v) and k not in skip}
    tbasic = {k: v for k, v in tcfg.items() if _basic(v) and k not in skip}
    assert tbasic == jbasic
    assert set(tcfg) == set(jcfg)
    jm, tm = jcfg["model"], tcfg["model"]
    for attr in ("num_classes", "regression_ranges", "point_strides", "range_assign_mode",
                 "distance_to_bbox_mode", "gray_ranges", "classification_loss_type"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.net._backbone.num_output_channels_list == list(jm.backbone.body_channels[s]
                                                             for s, _ in jm.backbone.out_indices)
    jl, tl = jcfg["train_data_loader"], tcfg["train_data_loader"]
    for attr in ("_batch_size", "_loops", "_num_workers", "_max_boxes", "_image_dtype"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    js, ts = jl._dataset_sampler, tl._dataset_sampler
    assert (ts._num_pos, ts._num_neg, ts._shuffle) == (js._num_pos, js._num_neg, js._shuffle)
    jr, tr = jl._region_sampler, tl._region_sampler
    if device_aug:
        assert (tr.crop_size, tr.buffer_size, tr._flip_p) == (jr.crop_size, jr.buffer_size,
                                                              jr._flip_p)
        jr, tr = jr._inner, tr._inner
    assert type(tr).__name__ == type(jr).__name__
    assert vars(tr) == vars(jr)  # crop 480, resize range and prob
    assert (tcfg["optimizer"].momentum, tcfg["optimizer"].weight_decay) == (
        jcfg["optimizer"].momentum, jcfg["optimizer"].weight_decay)
    # 1000 iterations, one per epoch so the milestones (500, 700, 900) fall in
    lrs = lambda cfg: [cfg["lr_schedule"](it, it) for it in range(1000)]
    assert lrs(tcfg) == lrs(jcfg)
    assert len(set(lrs(tcfg))) > 200  # warmup ramp and three decays
    assert ("device_augment" in tcfg) == ("device_augment" in jcfg) == device_aug


def test_device_aug_config_resamples_and_normalizes_as_lfdtpu(tmp_path, monkeypatch, pack):
    jcfg, tcfg = _configs(tmp_path, monkeypatch, pack, "XS", True)
    rng = np.random.RandomState(1)
    batch = dict(buffer=rng.randint(0, 256, (2, 960, 960, 3)).astype(np.uint8),
                 scale=rng.uniform(0.5, 1.5, (2, 2)).astype(np.float32),
                 translation=rng.uniform(-300, 0, (2, 2)).astype(np.float32),
                 flip=np.asarray([0, 1], np.float32))
    ref = np.asarray(jcfg["device_augment"]({k: jnp.asarray(v) for k, v in batch.items()}))
    got = tcfg["device_augment"]({k: torch.as_tensor(v) for k, v in batch.items()}).numpy()
    assert got.shape == ref.shape == (2, 480, 480, 3)
    assert np.abs(got - ref).max() <= 1e-3 / 127.5
