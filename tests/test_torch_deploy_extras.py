# Resolution buckets and quantized outputs of the port's deployment layer
# (lfdtpu_torch/deploy/buckets.py, compile_inference(output_dtype=...)) on the
# CPU, ported from lfdtpu's tests/test_deploy.py
# (test_bucketed_engine_set_routes_and_matches,
# test_quantized_output_engine_rounds_within_tolerance) and run against
# lfdtpu's counterparts on the same weights (lfdtpu's tiny_lfd, bridged).
# Tolerances are lfdtpu's own: rows rel 1e-4 / 1e-3 px; float16 outputs
# within 0.5 px (boxes) and 2e-3 (scores) of the float32 engine's. The port
# against lfdtpu at float32 holds tests/test_torch_engine.py's tolerances.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.deploy import BucketedEngineSet as JaxBuckets
from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu_torch.deploy import (BucketedEngineSet, compile_inference, make_device_preprocess,
                                 unpack_detections)
from tests.test_torch_int8 import _tiny_pair

torch.set_num_threads(1)

HALF = (0.5, 0.5, 0.5)
KW = dict(classification_threshold=0.01)


def _rows_close(got, ref):
    assert len(got) == len(ref)
    if ref:
        np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                                   rtol=1e-4, atol=1e-3)


def test_bucketed_engine_set_routes_and_matches():
    """Images route to the smallest covering bucket, engines build lazily
    once per bucket, and rows equal a directly built engine's at the same
    bucket, and lfdtpu's BucketedEngineSet's."""
    jdet, variables, tdet = _tiny_pair()
    bset = BucketedEngineSet(tdet, buckets=((32, 32), (64, 64)), precision="fp32",
                             device="cpu", preprocess=make_device_preprocess(HALF, HALF), **KW)
    jset = JaxBuckets(jdet, variables, buckets=((32, 32), (64, 64)), precision="fp32",
                      preprocess=jax_preprocess(HALF, HALF), **KW)
    rng = np.random.RandomState(2)
    small = rng.randint(0, 255, (30, 31, 3)).astype(np.uint8)
    large = rng.randint(0, 255, (50, 64, 3)).astype(np.uint8)
    assert bset.buckets == jset.buckets == ((32, 32), (64, 64))
    assert bset.bucket_for(30, 31) == (32, 32)
    assert bset.bucket_for(50, 64) == (64, 64)
    assert bset.bucket_for(100, 100) is None

    assert bset._engines == {}  # nothing built before the first image
    rows_small = bset.predict(small)
    rows_large = bset.predict(large)
    assert set(bset._engines) == {(32, 32), (64, 64)}

    direct = compile_inference(tdet, (64, 64), "fp32", preprocess=make_device_preprocess(HALF, HALF),
                               device="cpu", **KW)
    assert rows_large == tdet.predict_for_single_image_with_engine(direct, large)
    assert len(rows_large) > 0
    _rows_close(rows_large, jset.predict(large))
    _rows_close(rows_small, jset.predict(small))
    # routing reuses the cached engine (no rebuild)
    assert bset.engine_for(20, 20) is bset.engine_for(31, 32)
    with pytest.raises(ValueError):
        bset.engine_for(100, 100)
    assert bset.prewarm() is bset and set(bset._engines) == {(32, 32), (64, 64)}


def test_quantized_output_engine_rounds_within_tolerance():
    """output_dtype="f16": boxes and scores float16 (exact to 0.5 px below
    2048), labels int16, the count untouched, within float16 rounding of the
    float32 engine, and equal to lfdtpu's f16 engine within the same
    rounding; with pack_output one float16 buffer."""
    jdet, variables, tdet = _tiny_pair()
    img = np.random.RandomState(0).randint(0, 255, (1, 64, 64, 3)).astype(np.uint8)
    vhw = np.asarray([64.0, 64.0], np.float32)
    pre = make_device_preprocess(HALF, HALF)
    base = compile_inference(tdet, (64, 64), "fp32", preprocess=pre, device="cpu", **KW)
    q = compile_inference(tdet, (64, 64), "fp32", preprocess=pre, device="cpu",
                          output_dtype="f16", **KW)
    d0 = {k: v.numpy() for k, v in base(img, vhw).items()}
    d = q(img, vhw)
    assert d["boxes"].dtype == torch.float16 and d["scores"].dtype == torch.float16
    assert d["labels"].dtype == torch.int16 and d["count"].dtype == torch.int32
    d = {k: v.numpy() for k, v in d.items()}
    n = int(d0["count"][0])
    assert n > 0 and int(d["count"][0]) == n
    np.testing.assert_allclose(d["boxes"].astype(np.float32)[0][:n], d0["boxes"][0][:n],
                               atol=0.5)
    np.testing.assert_allclose(d["scores"].astype(np.float32)[0][:n], d0["scores"][0][:n],
                               atol=2e-3)
    assert (d["labels"][0][:n] == d0["labels"][0][:n]).all()

    jq = jax_compile(jdet, variables, (64, 64), "fp32", preprocess=jax_preprocess(HALF, HALF),
                     output_dtype="f16", **KW)
    ref = {k: np.asarray(v) for k, v in jq(jnp.asarray(img), jnp.asarray(vhw)).items()}
    for k in ref:
        assert d[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(d["count"], ref["count"])
    np.testing.assert_array_equal(d["labels"], ref["labels"])
    np.testing.assert_allclose(d["boxes"].astype(np.float32), ref["boxes"].astype(np.float32),
                               atol=0.5)
    np.testing.assert_allclose(d["scores"].astype(np.float32), ref["scores"].astype(np.float32),
                               atol=2e-3)

    qp = compile_inference(tdet, (64, 64), "fp32", preprocess=pre, device="cpu",
                           output_dtype="f16", pack_output=True, **KW)
    packed = qp(img, vhw)
    assert packed.dtype == torch.float16 and packed.shape[-1] == 7
    assert int(unpack_detections(packed)["count"][0]) == n
    assert torch.equal(packed, _packed_f32(tdet, pre, img, vhw).to(torch.float16))
    with pytest.raises(ValueError, match="output_dtype"):
        compile_inference(tdet, (64, 64), "fp32", device="cpu", output_dtype="int8")


def _packed_f32(tdet, pre, img, vhw):
    """The float32 engine's packed output: the f16 packed engine casts it."""
    e = compile_inference(tdet, (64, 64), "fp32", preprocess=pre, device="cpu",
                          pack_output=True, **KW)
    return e(img, vhw)
