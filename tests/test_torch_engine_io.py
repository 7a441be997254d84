# Engine files (lfdtpu_torch/deploy/engine_io.py) on the CPU against lfdtpu's
# (lfdtpu/deploy/engine_io.py): lfdtpu's five cases of tests/test_engine_io.py
# (fp32, a fresh process, int8, int8 with the bf16 head, batch 2 with
# per-image and shared extents) on bridged WIDERFACE-XS weights at 64x64,
# then a file with a wrong magic and the quantized packed outputs.
#
# Tolerances, each with its cause:
#   - the port's loaded engine against its in-process engine: bit for bit
#     (the same ops on the same weights; lfdtpu allows itself 1e-5, 1e-3
#     for the bf16 head);
#   - the port's detections against lfdtpu's loaded engine: the engine
#     parity tolerances of tests/test_torch_engine.py (fp32: counts and
#     labels equal, scores rel 1e-5, boxes 1e-3 px) and
#     tests/test_torch_int8.py (the bf16 head: counts within 1, scores
#     within 0.02). int8 on fake-quantized weights: the same count and the
#     sorted scores within 0.005 (INT8_SCORE_ATOL of
#     tests/test_torch_traffic_scripts.py, whose int8 rows differ for the
#     same cause): XLA's CPU rsqrt is 1 ulp off torch's in some folded BN
#     scales, which can move a requant that lies on a rounding boundary, and
#     the move spreads through the chain (tests/test_torch_int8.py).
import copy
import io
import json
import os
import subprocess
import sys
import textwrap
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu.deploy import quantize_variables_int8
from lfdtpu.deploy.engine_io import load_engine as jax_load
from lfdtpu.deploy.engine_io import save_engine as jax_save
from lfdtpu.deploy.int8_net import calibrate_module_amax as jax_calibrate
from lfdtpu_torch.deploy import (compile_inference, load_engine, make_device_preprocess,
                                 quantize_net_int8, save_engine, unpack_detections)
from lfdtpu_torch.deploy.engine_io import read_meta
from lfdtpu_torch.execution.jax_convert import jax_amax_to_port
from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 64)
HALF = (0.5, 0.5, 0.5)
ENGINE_TOL = dict(rtol=1e-5, atol=1e-3)  # boxes, tests/test_torch_engine.py
INT8_SCORE_ATOL = 0.005  # tests/test_torch_traffic_scripts.py


def _img(seed, b=1):
    return np.random.RandomState(seed).randint(0, 255, (b,) + HW + (3,), dtype=np.uint8)


def _pair(precision="fp32", **kw):
    """lfdtpu's engine and the port's on the same XS weights. int8: both
    fake-quantize the weights (quantize_variables_int8 / quantize_net_int8)
    and calibrate on lfdtpu's two noise frames, with one amax dict (lfdtpu's,
    mapped), so both quantize at the same scales."""
    jdet, variables, tdet = jax_and_port("WIDERFACE-XS")
    port_kw = dict(kw)
    if precision == "int8":
        tdet = copy.copy(tdet)
        tdet.net = quantize_net_int8(tdet.net)
        if kw.get("int8_head_dtype") != "bf16":
            variables = quantize_variables_int8(variables)
        rng = np.random.RandomState(0)
        calib = [rng.randint(0, 255, (kw.get("batch_size", 1),) + HW + (3,), dtype=np.uint8)
                 for _ in range(2)]
        amax = jax_calibrate(jdet, variables, calib, preprocess=jax_preprocess(HALF, HALF))
        kw["act_scales"] = amax
        port_kw["act_scales"] = jax_amax_to_port(amax, tdet.net)
    je = jax_compile(jdet, variables, HW, precision, preprocess=jax_preprocess(HALF, HALF), **kw)
    te = compile_inference(tdet, HW, precision, preprocess=make_device_preprocess(HALF, HALF),
                           device="cpu", **port_kw)
    return je, te


def _files(tmp_path, je, te):
    jpath, tpath = str(tmp_path / "jax.lfde"), str(tmp_path / "port.lfde")
    jax_save(je, jpath)
    save_engine(te, tpath)
    return jax_load(jpath), tpath


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _match_fp32(got, ref):
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], **ENGINE_TOL)


def test_engine_save_load_roundtrip(tmp_path):
    je, te = _pair(classification_threshold=0.01)
    jl, tpath = _files(tmp_path, je, te)
    img = _img(0)
    ref = _np(te(img, (60, 64)))
    assert os.path.getsize(tpath) > 1000
    loaded = load_engine(tpath, device="cpu")
    assert loaded.precision_mode == "fp32" and loaded.input_resolution == HW
    assert not loaded.captured
    got = _np(loaded(img, (60, 64)))
    _bit_equal(got, ref)
    assert ref["count"][0] > 0
    _match_fp32(got, _np(jl(img, (60, 64))))


def test_engine_loads_in_fresh_process(tmp_path):
    """The file serves in a process that imports only engine_io: no jax, no
    lfdtpu, and none of the port's model code."""
    je, te = _pair(classification_threshold=0.01)
    jl, tpath = _files(tmp_path, je, te)
    img = _img(0)
    ref = _np(te(img, (60, 64)))
    out = str(tmp_path / "out.npz")
    src = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from lfdtpu_torch.deploy.engine_io import load_engine
        eng = load_engine({tpath!r}, device="cpu")
        img = np.random.RandomState(0).randint(0, 255, (1, 64, 64, 3), dtype=np.uint8)
        np.savez({out!r}, **{{k: v.numpy() for k, v in eng(img, (60, 64)).items()}})
        print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lfdtpu")
                                or m.startswith(("lfdtpu_torch.models", "lfdtpu_torch.zoo")))))
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    proc = subprocess.run([sys.executable, "-c", src], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    got = dict(np.load(out))
    _bit_equal(got, ref)
    _match_fp32(got, _np(jl(img, (60, 64))))


def test_int8_engine_save_load_roundtrip(tmp_path):
    """int8 engines carry the chain's packed weights, multipliers and biases:
    the file holds them."""
    je, te = _pair("int8", classification_threshold=0.01)
    jl, tpath = _files(tmp_path, je, te)
    # K5: the float head's 5 levels x the shared merge path's 2 GroupNorm + ReLU
    assert read_meta(tpath)["ops"] == {"lfd::group_norm_relu": 10,
                                       "lfd::int8_conv": len(te.int8_chain.units),
                                       "lfd::nms_mask_sorted": 1}
    img = _img(1)
    got = _np(load_engine(tpath, device="cpu")(img, (64, 64)))
    _bit_equal(got, _np(te(img, (64, 64))))
    ref = _np(jl(img, (64, 64)))
    assert ref["count"][0] > 0
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_allclose(np.sort(got["scores"][0]), np.sort(ref["scores"][0]),
                               atol=INT8_SCORE_ATOL)


def test_int8_bf16_head_engine_save_load(tmp_path):
    """The bf16 float remainder's weights go through the file as bf16."""
    je, te = _pair("int8", int8_head_dtype="bf16", classification_threshold=0.01)
    jl, tpath = _files(tmp_path, je, te)
    loaded = load_engine(tpath, device="cpu")
    assert loaded.program.state_dict["net._head.head0_merge_path.0.weight"].dtype == \
        torch.bfloat16
    img = _img(2)
    got = _np(loaded(img, (64, 64)))
    _bit_equal(got, _np(te(img, (64, 64))))
    ref = _np(jl(img, (64, 64)))
    na, nb = int(ref["count"][0]), int(got["count"][0])
    assert na > 0 and abs(na - nb) <= 1, (na, nb)
    n = min(na, nb)
    np.testing.assert_allclose(got["scores"][0, :n], ref["scores"][0, :n], atol=0.02)


def test_batch_engine_save_load_per_image_extents(tmp_path):
    """Batch engines serialize with (B, 2) per-image valid extents; a loaded
    engine takes per-image (B, 2) and shared (2,) extents."""
    je, te = _pair(batch_size=2, classification_threshold=0.01)
    jl, tpath = _files(tmp_path, je, te)
    loaded = load_engine(tpath, device="cpu")
    assert read_meta(tpath)["vhw_shape"] == [2, 2]
    imgs = _img(0, 2)
    for hws in (np.asarray([[60, 64], [64, 48]], np.float32), np.asarray([60.0, 64.0])):
        got = _np(loaded(imgs, hws))
        _bit_equal(got, _np(te(imgs, hws)))
        _match_fp32(got, _np(jl(jnp.asarray(imgs), hws)))


def test_engine_file_with_a_wrong_magic_raises(tmp_path):
    _, te = _pair()
    path = str(tmp_path / "e.lfde")
    save_engine(te, path)
    bad = str(tmp_path / "bad.lfde")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(bad, "w") as dst:
        meta = json.loads(src.read("meta.json"))
        meta["magic"] = "lfdtpu-engine-v2"  # lfdtpu's own files
        dst.writestr("meta.json", json.dumps(meta))
        dst.writestr("program.pt2", src.read("program.pt2"))
    with pytest.raises(ValueError, match="not an lfdtpu_torch engine file"):
        load_engine(bad, device="cpu")


def test_quantized_packed_outputs_survive_a_round_trip(tmp_path):
    """output_dtype="f16" with pack_output: the loaded engine returns the
    same float16 (B, max_det, 7) tensor, and the file says so."""
    _, te = _pair(classification_threshold=0.01, output_dtype="f16", pack_output=True)
    path = str(tmp_path / "e.lfde")
    save_engine(te, path)
    meta = read_meta(path)
    assert meta["output_dtype"] == "float16" and meta["pack_output"] is True
    loaded = load_engine(path, device="cpu")
    assert loaded.output_dtype == torch.float16 and loaded.pack_output
    img = _img(3)
    ref, got = te(img, (64, 64)), loaded(img, (64, 64))
    assert got.dtype == torch.float16 and got.shape == (1, 100, 7)
    assert torch.equal(got, ref)
    assert unpack_detections(got)["count"][0] > 0


def _tampered(path, out, edit):
    """A copy of engine file `path` at `out` whose program archive has each
    member's bytes replaced by edit(name, data) (None drops the member)."""
    with zipfile.ZipFile(path) as src:
        meta, blob = src.read("meta.json"), src.read("program.pt2")
    inner = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as a, zipfile.ZipFile(inner, "w") as b:
        for name in a.namelist():
            data = edit(name, a.read(name))
            if data is not None:
                b.writestr(name, data)
    with zipfile.ZipFile(out, "w") as dst:
        dst.writestr("meta.json", meta)
        dst.writestr("program.pt2", inner.getvalue())
    return out


def _pickled_weight(name, data):
    if name.endswith("/data/weights/model_weights_config.json"):
        cfg = json.loads(data)
        next(iter(cfg["config"].values()))["use_pickle"] = True
        return json.dumps(cfg)
    return data


def _sample_inputs(name, data):
    if name.endswith("/data/sample_inputs/model.pt"):
        blob = io.BytesIO()
        torch.save(((torch.zeros(1, *HW, 3),), {}), blob)
        return blob.getvalue()
    return data


def _no_weights_config(name, data):
    return None if name.endswith("_weights_config.json") else data


@pytest.mark.parametrize("edit, match", [
    (_pickled_weight, "not stored as raw tensor bytes"),
    (_sample_inputs, "pickled sample inputs"),
    (_no_weights_config, "no weights config"),
])
def test_loading_refuses_an_archive_it_would_unpickle(tmp_path, edit, match):
    """Loading unpickles nothing: a weight stored as a pickle, sample inputs
    kept in the archive, or an archive whose weights config is not where the
    check looks all raise before torch.export.load runs."""
    _, te = _pair()
    path = save_engine(te, str(tmp_path / "e.lfde"))
    load_engine(path, device="cpu")  # the untouched file loads
    bad = _tampered(path, str(tmp_path / "bad.lfde"), edit)
    with pytest.raises(ValueError, match=match):
        load_engine(bad, device="cpu")


def test_loaded_engine_runs_under_the_files_tf32_switches(tmp_path, monkeypatch):
    """The file carries the building process's TF32 switches, and the loaded
    engine runs under them whatever the loading process's are (restored
    after each call); a file from another torch version loads with a
    warning."""
    from lfdtpu_torch.deploy import engine_io
    from lfdtpu_torch.deploy.runner import tf32_switches

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    _, te = _pair(classification_threshold=0.01)
    path = save_engine(te, str(tmp_path / "e.lfde"))
    assert read_meta(path)["tf32"] == [False, False]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
    loaded = load_engine(path, device="cpu")
    seen = []
    real = engine_io.LoadedEngine._forward
    monkeypatch.setattr(engine_io.LoadedEngine, "_forward",
                        lambda self, x, vhw: seen.append(tf32_switches()) or real(self, x, vhw))
    img = _img(4)
    _bit_equal(_np(loaded(img, (64, 64))), _np(te(img, (64, 64))))
    assert seen == [(False, False)] and tf32_switches() == (True, True)
    monkeypatch.setattr(engine_io.torch, "__version__", "0.0.0")
    with pytest.warns(UserWarning, match="written by torch"):
        load_engine(path, device="cpu")
