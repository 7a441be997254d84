# The port's WIDERFACE scripts beside the training ones (lfdtpu_torch/
# workloads/WIDERFACE_train: predict, predict_engine, evaluation,
# timing_inference_latency, pack_widerface, generate_neg_images) against
# their lfdtpu counterparts (workloads/WIDERFACE_train), on the CPU
# (LFD_DEVICE=cpu) and on synthetic files:
#   - every script of the reference set exists and compiles (as
#     tests/test_workloads.py::test_all_workload_scripts_compile);
#   - predict and predict_engine (fp32) on the same weights (an lfdtpu .ckpt
#     and the port's .pth of one bridged init) and the same JPEG: the same
#     number of rows, each within ROW_TOL, in fp32 and in int8 (both
#     scripts fake-quantize the weights and calibrate on lfdtpu's noise
#     frames); engine files refuse;
#   - evaluation: the same txt files, row for row (integers within 1: floor
#     and ceil of coordinates that differ in the fifth digit; scores within
#     0.002 of the %.03f print);
#   - pack_widerface: the same pack (indexes, boxes, labels, image bytes);
#     generate_neg_images: the same files, byte for byte;
#   - timing_inference_latency keeps lfdtpu's defaults, and its int8 path runs.
import importlib.util
import os
import py_compile

import numpy as np
import pytest
import torch

import lfdtpu.data as jdata
import lfdtpu.execution as jexe
import lfdtpu_torch.data as tdata
import lfdtpu_torch.execution as texe
from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "lfdtpu_torch", "workloads", "WIDERFACE_train")
JAX_DIR = os.path.join(ROOT, "workloads", "WIDERFACE_train")
SCRIPTS = ["WIDERFACE_LFD_XS.py", "WIDERFACE_LFD_S.py", "WIDERFACE_LFD_M.py",
           "WIDERFACE_LFD_L.py", "pack_widerface.py", "generate_neg_images.py", "predict.py",
           "predict_engine.py", "evaluation.py", "timing_inference_latency.py"]
ROW_TOL = 1e-4  # rows [label, score, x, y, w, h]: relative, plus 1e-3 absolute


def _load(directory, script):
    """The script as a module under a name of its own (both directories
    hold a predict.py, an evaluation.py, ...)."""
    side = "port" if directory == PORT_DIR else "jax"
    name = f"{side}_widerface_{script[:-3]}"
    spec = importlib.util.spec_from_file_location(name, os.path.join(directory, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_has_every_widerface_script_and_each_compiles():
    for script in SCRIPTS + ["_common.py"]:
        assert os.path.isfile(os.path.join(JAX_DIR, script)), script
        path = os.path.join(PORT_DIR, script)
        assert os.path.isfile(path), f"no port counterpart of {script}"
        py_compile.compile(path, doraise=True)


@pytest.fixture
def checkpoints(tmp_path, monkeypatch):
    """One WIDERFACE-XS init as an lfdtpu .ckpt and as the port's .pth."""
    monkeypatch.setenv("LFD_DEVICE", "cpu")
    _, variables, tdet = jax_and_port("WIDERFACE-XS")
    jpath, tpath = str(tmp_path / "xs.ckpt"), str(tmp_path / "xs.pth")
    jexe.save_checkpoint(jpath, {"params": variables["params"],
                                 "batch_stats": variables["batch_stats"]})
    texe.save_checkpoint(tpath, tdet.net)
    return jpath, tpath


def _write_images(root, shapes, seed=0):
    """Smooth random JPEGs (noise would not survive the codec as well)."""
    import cv2

    rng = np.random.RandomState(seed)
    paths = []
    for rel, (h, w) in shapes.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        small = (rng.rand(h // 8 + 1, w // 8 + 1, 3) * 255).astype(np.uint8)
        cv2.imwrite(path, cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))
        paths.append(path)
    return paths


def _assert_rows(got, ref):
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=ROW_TOL, atol=1e-3)


def test_predict_script_matches_lfdtpus(tmp_path, checkpoints):
    jpath, tpath = checkpoints
    image, = _write_images(str(tmp_path), {"img.jpg": (100, 120)})
    ref = _load(JAX_DIR, "predict.py").predict(
        "XS", jpath, image, classification_threshold=0.05, out_path=str(tmp_path / "j.jpg"))
    got = _load(PORT_DIR, "predict.py").predict(
        "XS", tpath, image, classification_threshold=0.05, out_path=str(tmp_path / "t.jpg"))
    _assert_rows(got, ref)
    assert os.path.getsize(tmp_path / "t.jpg") > 0


def test_predict_engine_script_matches_lfdtpus(tmp_path, checkpoints):
    jpath, tpath = checkpoints
    image, = _write_images(str(tmp_path), {"img.jpg": (100, 120)}, seed=1)
    port = _load(PORT_DIR, "predict_engine.py")
    ref = _load(JAX_DIR, "predict_engine.py").predict_with_engine(
        "XS", jpath, image, precision="fp32", classification_threshold=0.05,
        out_path=str(tmp_path / "j.jpg"))
    got = port.predict_with_engine(
        "XS", tpath, image, precision="fp32", classification_threshold=0.05,
        out_path=str(tmp_path / "t.jpg"))
    _assert_rows(got, ref)
    assert os.path.getsize(tmp_path / "t.jpg") > 0
    bf16 = port.predict_with_engine("XS", tpath, image, classification_threshold=0.05,
                                    out_path=str(tmp_path / "b.jpg"))  # the default precision
    assert abs(len(bf16) - len(ref)) <= max(2, len(ref) // 10)
    # engine files: the first run builds and saves the engine, the second
    # loads it (no model built); the port's loaded rows are its built rows
    # and match lfdtpu's, which runs the same flow
    files = {"jax": str(tmp_path / "e_jax.lfde"), "port": str(tmp_path / "e.lfde")}
    jax_script = _load(JAX_DIR, "predict_engine.py")
    ref_runs = [jax_script.predict_with_engine(
        "XS", jpath, image, precision="fp32", classification_threshold=0.05,
        out_path=str(tmp_path / "jf.jpg"), engine_file=files["jax"]) for _ in range(2)]
    runs = [port.predict_with_engine(
        "XS", tpath, image, precision="fp32", classification_threshold=0.05,
        out_path=str(tmp_path / "tf.jpg"), engine_file=files["port"]) for _ in range(2)]
    assert os.path.getsize(files["port"]) > 0
    assert runs[1] == runs[0] == got
    _assert_rows(runs[1], ref_runs[1])
    # int8: both scripts fake-quantize the weights and calibrate on lfdtpu's
    # noise frames (the scales differ by the two float32 nets' rounding)
    int8_ref = _load(JAX_DIR, "predict_engine.py").predict_with_engine(
        "XS", jpath, image, precision="int8", classification_threshold=0.05,
        out_path=str(tmp_path / "j8.jpg"))
    int8 = port.predict_with_engine("XS", tpath, image, precision="int8",
                                    classification_threshold=0.05,
                                    out_path=str(tmp_path / "t8.jpg"))
    _assert_rows(int8, int8_ref)


def test_timing_script_runs_int8_on_the_cpu(monkeypatch):
    """The timing script's int8 path (calibrator, fake-quantized weights, the
    int8 engine) through one small cell on the CPU."""
    monkeypatch.setenv("LFD_DEVICE", "cpu")
    res = _load(PORT_DIR, "timing_inference_latency.py").run("int8", sweep=((64, 64),),
                                                              loops=2)
    (key, r), = res.items()
    assert key == ("int8", (64, 64))
    assert r["loops"] == 2 and r["method"] == "perf_counter_per_call" and r["ms_per_image"] > 0


def test_evaluation_script_writes_lfdtpus_files(tmp_path, checkpoints):
    jpath, tpath = checkpoints
    val = str(tmp_path / "val")
    _write_images(val, {"0--Parade/a.jpg": (90, 130), "0--Parade/b.jpg": (128, 128),
                        "1--Handshaking/c.jpg": (60, 200)}, seed=2)
    _load(JAX_DIR, "evaluation.py").run_SIO_evaluation(
        "XS", jpath, val, str(tmp_path / "j"), classification_threshold=0.05)
    n = _load(PORT_DIR, "evaluation.py").run_SIO_evaluation(
        "XS", tpath, val, str(tmp_path / "t"), classification_threshold=0.05)
    assert n == 3
    files = sorted(str(p.relative_to(tmp_path / "t")) for p in (tmp_path / "t").rglob("*.txt"))
    assert files == ["0--Parade/a.txt", "0--Parade/b.txt", "1--Handshaking/c.txt"]
    rows = 0
    for rel in files:
        got = (tmp_path / "t" / rel).read_text().splitlines()
        ref = (tmp_path / "j" / rel).read_text().splitlines()
        assert got[:3] == ref[:3] and got[2] == "0 0 0 0 0.001"
        assert got[0] == os.path.basename(rel)[:-4] and int(got[1]) == len(got) - 2
        assert len(got) == len(ref)
        for g, r in zip(got[3:], ref[3:]):
            g, r = g.split(" "), r.split(" ")
            assert len(g) == 5
            assert all(abs(int(a) - int(b)) <= 1 for a, b in zip(g[:4], r[:4])), (g, r)
            assert abs(float(g[4]) - float(r[4])) <= 0.002
            rows += 1
    assert rows > 0


def test_pack_and_neg_image_scripts_match_lfdtpus(tmp_path):
    root = str(tmp_path / "WIDER_train" / "images")
    shapes = {"0--Parade/p1.jpg": (300, 400), "0--Parade/p2.jpg": (260, 380),
              "1--Handshaking/h1.jpg": (280, 300)}
    _write_images(root, shapes, seed=3)
    ann = tmp_path / "gt.txt"
    ann.write_text("\n".join([
        "0--Parade/p1.jpg", "2", "150 120 40 50 0 0 0 0 0 0", "220 130 30 30 0 0 0 0 0 0",
        "0--Parade/p2.jpg", "0", "0 0 0 0 0 0 0 0 0 0",
        "1--Handshaking/h1.jpg", "2", "120 110 60 60 0 0 0 0 0 0", "-1 5 10 10 0 0 0 0 0 0",
    ]) + "\n")

    negs = {}
    for side, directory in (("j", JAX_DIR), ("t", PORT_DIR)):
        out = str(tmp_path / f"neg_{side}")
        n = _load(directory, "generate_neg_images.py").generate_neg_images(
            root, str(ann), out, min_size_threshold=100)
        negs[side] = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
        assert n == len(negs[side]) > 0
    assert negs["t"] == negs["j"]

    packs = {}
    for side, directory, pkg in (("j", JAX_DIR, jdata), ("t", PORT_DIR, tdata)):
        path = str(tmp_path / f"pack_{side}.pkl")
        ds = _load(directory, "pack_widerface.py").pack(
            str(ann), root, neg_image_root=str(tmp_path / "neg_t"), save_path=path)
        assert len(ds) == 3 + len(negs["t"])
        packs[side] = pkg.Dataset(load_path=path)
    j, t = packs["j"], packs["t"]
    assert t.get_indexes() == j.get_indexes()
    for i in t.get_indexes():
        a, b = t[i], j[i]
        assert set(a.keys()) == set(b.keys())
        assert all(a[k] == b[k] for k in a.keys()), i
    assert t[0]["bboxes"] == [[150, 120, 40, 50], [220, 130, 30, 30]]
    assert "bboxes" not in t[1] and t[2]["bboxes"] == [[120, 110, 60, 60]]
    # each pack loads in the other package, and the checker draws from it
    assert len(tdata.Dataset(load_path=str(tmp_path / "pack_j.pkl"))) == len(t)
    _load(PORT_DIR, "pack_widerface.py").check_dataset(str(tmp_path / "pack_t.pkl"), num=2,
                                                       out_dir=str(tmp_path))
    assert os.path.getsize(tmp_path / "widerface_check_1.jpg") > 0


def test_timing_script_keeps_lfdtpus_defaults():
    port = _load(PORT_DIR, "timing_inference_latency.py")
    ref = _load(JAX_DIR, "timing_inference_latency.py")
    for name in ("model_size", "precision_mode", "resolutions", "timing_loops"):
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.model_size, port.precision_mode, port.timing_loops) == ("XS", "bf16", 50)
    assert port.resolutions == ((480, 640), (720, 1280), (1080, 1920), (2160, 3840))
