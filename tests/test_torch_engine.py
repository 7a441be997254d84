# The port's compiled engine (compile_inference) on the CPU against
# lfdtpu's, for WIDERFACE-S and -L at 128x128, fp32 and bf16, on the same
# weights and raw uint8 frames. fp32: the same rows (scores well separated
# by random weights). bf16: the two frameworks round at different places
# (and the port's bf16 case runs with the three kernel switches on, which on
# the CPU means their plain versions), so dense outputs agree to bf16
# tolerance and detections as tests/test_deploy.py holds lfdtpu's own bf16
# variants: counts within 1, matched scores within 0.04.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu.deploy import compile_inference as jax_compile
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu_torch.deploy import compile_inference, make_device_preprocess
from lfdtpu_torch.deploy import unpack_detections

from tests.test_torch_bridge import jax_and_port

torch.set_num_threads(1)

HW = (128, 128)
MEAN, STD = (0.45, 0.5, 0.55), (0.25, 0.25, 0.3)
KW = dict(classification_threshold=0.01)


def _frames(seed, b=2):
    return np.random.RandomState(seed).randint(0, 255, (b,) + HW + (3,)).astype(np.uint8)


def _engines(name, precision, **port_kw):
    jdet, variables, tdet = jax_and_port(name)
    je = jax_compile(jdet, variables, HW, precision, batch_size=2,
                     preprocess=jax_preprocess(MEAN, STD, bgr2rgb=True), **KW)
    te = compile_inference(tdet, HW, precision, batch_size=2, device="cpu",
                           preprocess=make_device_preprocess(MEAN, STD, bgr2rgb=True),
                           **KW, **port_kw)
    return jdet, variables, je, te


@pytest.mark.parametrize("name", ["WIDERFACE-S", "WIDERFACE-L"])
def test_fp32_engine_matches_lfdtpu(name):
    jdet, variables, je, te = _engines(name, "fp32")
    imgs = _frames(1)
    vhw = np.asarray([[128, 128], [100, 77]], np.float32)
    ref = {k: np.asarray(v) for k, v in je(jnp.asarray(imgs), jnp.asarray(vhw)).items()}
    got = {k: v.numpy() for k, v in te(imgs, vhw).items()}
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], rtol=1e-5, atol=1e-3)
    # the dense half on its own
    x = (imgs[..., ::-1].astype(np.float32) - np.float32(MEAN) * 255) / (np.float32(STD) * 255)
    jc, jr = jdet.net.apply(variables, jnp.asarray(x), train=False)
    tc, tr = te.dense(imgs)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["WIDERFACE-S", "WIDERFACE-L"])
def test_bf16_engine_with_kernel_switches_matches_lfdtpu(name):
    jdet, variables, je, te = _engines(name, "bf16", nms_use_kernel=True,
                                       kernel_convs=True, kernel_stem=True)
    imgs = _frames(2)
    vhw = np.asarray([128, 128], np.float32)
    ref = {k: np.asarray(v) for k, v in je(jnp.asarray(imgs), jnp.asarray(vhw)).items()}
    got = {k: v.numpy() for k, v in te(imgs, vhw).items()}
    for b in range(2):
        na, nb = int(ref["count"][b]), int(got["count"][b])
        assert abs(na - nb) <= 1, (na, nb)
        n = min(na, nb)
        np.testing.assert_allclose(got["scores"][b, :n], ref["scores"][b, :n], atol=0.04)
    # dense outputs: bf16 logits of magnitude ~1 agree to a few bf16 ulps
    x = (imgs[..., ::-1].astype(np.float32) - np.float32(MEAN) * 255) / (np.float32(STD) * 255)
    from lfdtpu.deploy.compile import cast_variables

    jc, jr = jdet.net.apply(cast_variables(variables, jnp.bfloat16),
                            jnp.asarray(x, jnp.bfloat16), train=False)
    tc, tr = te.dense(imgs)
    assert tc.dtype == torch.bfloat16
    for t, j in ((tc, jc), (tr, jr)):
        j = np.asarray(j, np.float32)
        assert np.abs(t.float().numpy() - j).max() / np.abs(j).max() < 0.05


def test_predict_paths_match_lfdtpu():
    """predict_for_single_image (the net, eager) and the engine's single and
    mixed-size batch predicts give lfdtpu's rows."""
    jdet, variables, tdet = jax_and_port("WIDERFACE-S")
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 255, (128, 128, 3)).astype(np.uint8),
            rng.randint(0, 255, (97, 70, 3)).astype(np.uint8)]
    got = tdet.predict_for_single_image(imgs[1], classification_threshold=0.01)
    ref = jdet.predict_for_single_image(variables, imgs[1], classification_threshold=0.01)
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-3)

    pre = make_device_preprocess(MEAN, STD)
    single = compile_inference(tdet, HW, "fp32", preprocess=pre, device="cpu", **KW)
    batched = compile_inference(tdet, HW, "fp32", preprocess=pre, batch_size=2, device="cpu",
                                **KW)
    jsingle = jax_compile(jdet, variables, HW, "fp32",
                          preprocess=jax_preprocess(MEAN, STD), **KW)
    rows_b = tdet.predict_for_batch_with_engine(batched, imgs)
    for img, rows in zip(imgs, rows_b):
        rows_s = tdet.predict_for_single_image_with_engine(single, img)
        rows_j = jdet.predict_for_single_image_with_engine(jsingle, img)
        assert len(rows) == len(rows_s) == len(rows_j) > 0
        np.testing.assert_allclose(np.asarray(rows), np.asarray(rows_s), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(rows), np.asarray(rows_j), rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="batch_size"):
        batched(np.zeros((1,) + HW + (3,), np.uint8), [128, 128])


@pytest.mark.parametrize("dtype", [np.uint8, np.float64])
def test_batched_predict_of_mixed_sizes_equals_the_prepadded_call(dtype):
    """The predict API hands the engine unpadded frames of mixed sizes; its
    rows equal those of engine(padded, hws) with each frame zero-padded into
    a batch of the engine's resolution, call after call as the extents
    change (float64 frames reach the net as float32 either way), and so do
    predict_padded's. An image larger than the engine still raises."""
    from lfdtpu_torch.deploy import predict_padded
    from lfdtpu_torch.ops.decode import detections_to_lists

    _, _, tdet = jax_and_port("WIDERFACE-S")
    pre = make_device_preprocess(MEAN, STD)
    engine = compile_inference(tdet, HW, "fp32", preprocess=pre, batch_size=2, device="cpu",
                               **KW)
    single = compile_inference(tdet, HW, "fp32", preprocess=pre, device="cpu", **KW)
    rng = np.random.RandomState(5)
    for sizes in ([(128, 128), (97, 70)], [(64, 120), (128, 50)], [(97, 70), (97, 70)]):
        imgs = [rng.randint(0, 255, hw + (3,)).astype(dtype) for hw in sizes]
        padded = np.zeros((2,) + HW + (3,), dtype)
        for i, img in enumerate(imgs):
            padded[i, :img.shape[0], :img.shape[1]] = img
        hws = np.asarray(sizes, np.float32)
        out = {k: v.numpy() for k, v in engine(padded, hws).items()}
        want = [detections_to_lists({k: v[i] for k, v in out.items()}) for i in range(2)]
        got = tdet.predict_for_batch_with_engine(engine, imgs)
        assert got == want and sum(len(r) for r in got) > 0, sizes
        one = {k: v.numpy() for k, v in predict_padded(single, imgs[1]).items()}
        ref = {k: v.numpy() for k, v in single(padded[1:], hws[1]).items()}
        assert all(np.array_equal(one[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="exceeds engine resolution"):
        tdet.predict_for_batch_with_engine(engine, [imgs[0], np.zeros((129, 64, 3), dtype)])
    with pytest.raises(ValueError, match="exceeds engine resolution"):
        predict_padded(single, np.zeros((64, 129, 3), dtype))


def test_packed_output_and_budgets():
    _, _, tdet = jax_and_port("WIDERFACE-L")
    pre = make_device_preprocess(MEAN, STD)
    imgs = _frames(4)
    base = compile_inference(tdet, HW, "fp32", preprocess=pre, batch_size=2, device="cpu",
                             **KW)
    packed = compile_inference(tdet, HW, "fp32", preprocess=pre, batch_size=2, device="cpu",
                               pack_output=True, **KW)
    small = compile_inference(tdet, HW, "fp32", preprocess=pre, batch_size=2, device="cpu",
                              pre_nms_points=300, nms_budget=300, max_det=20, **KW)
    d0 = {k: v.numpy() for k, v in base(imgs, [128, 128]).items()}
    d1 = unpack_detections(packed(imgs, [128, 128]))
    # the packed tensor holds the detections; the candidate count rides the
    # dict only
    assert set(d0) == set(d1) | {"candidates"}
    for k in d1:
        np.testing.assert_array_equal(d1[k], d0[k])
    d2 = small(imgs, [128, 128])
    assert d2["boxes"].shape == (2, 20, 4)
    n = int(d2["count"][0])
    np.testing.assert_array_equal(d2["scores"][0, :n].numpy(), d0["scores"][0, :n])
