# The port's synthetic end-to-end tool (lfdtpu_torch/tools/synthetic_e2e.py)
# against lfdtpu's tools/synthetic_e2e.py on the CPU:
#   - make_dataset bit-equal (images and the COCO dict) for the
#     single-scale, multiscale (192 px, 4 buckets) and zoo (single class,
#     3 buckets) draws;
#   - build_detector of every family on lfdtpu's weights (carried through
#     jax_variables_to_state_dict, strict): the same strides and regression
#     ranges, and eval-mode dense outputs within rtol=1e-4, atol=1e-5 (the
#     two frameworks sum the convs in another order);
#   - per_bucket_recall's hits and totals equal lfdtpu's on carried weights;
#   - a one-epoch run on the CPU reaches the val loop and the engines'
#     scoring, and the mAP gate raises.
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
from lfdtpu_torch.tools import synthetic_e2e as T
from tests.test_torch_bridge import randomize_norms

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import synthetic_e2e as J  # noqa: E402  (lfdtpu's tool)

torch.set_num_threads(1)

DRAWS = {
    "single-scale": dict(n=12, seed=0),
    "multiscale": dict(n=12, seed=1, size=J.MULTISCALE_SIZE, buckets=J.MULTISCALE_BUCKETS),
    "zoo": dict(n=12, seed=2, buckets=((10, 18), (22, 38), (44, 72)), num_classes=1),
}
FAMILIES = [("lfd", False), ("lfdv2", False), ("lfdv2q", False), ("fcos", False),
            ("lfd", True)]


@pytest.mark.parametrize("draw", DRAWS)
def test_make_dataset_is_lfdtpus_draw(draw):
    jsamples, jcoco = J.make_dataset(**DRAWS[draw])
    tsamples, tcoco = T.make_dataset(**DRAWS[draw])
    assert tcoco == jcoco
    assert list(tsamples) == list(jsamples)
    for i, js in jsamples.items():
        ts = tsamples[i]
        assert ts["image"].dtype == js["image"].dtype == np.uint8
        assert np.array_equal(ts["image"], js["image"])
        assert (ts["image_id"], ts["bboxes"], ts["bbox_labels"]) == \
            (js["image_id"], js["bboxes"], js["bbox_labels"])
    assert len(jcoco["annotations"]) > 0


def test_zoo_buckets_are_lfdtpus():
    assert T.ZOO_BUCKETS == DRAWS["zoo"]["buckets"]
    assert (T.MULTISCALE_BUCKETS, T.MULTISCALE_RANGES, T.MULTISCALE_SIZE) == \
        (J.MULTISCALE_BUCKETS, J.MULTISCALE_RANGES, J.MULTISCALE_SIZE)


def carried(family, multiscale, seed=0):
    """lfdtpu's detector with randomized norms, and the port's with the same
    weights (strict), in eval mode."""
    size = J.MULTISCALE_SIZE if multiscale else 128
    jdet = J.build_detector(family, multiscale)
    variables = randomize_norms(jdet.init(jax.random.PRNGKey(seed), (size, size)), seed)
    tdet = T.build_detector(family, multiscale)
    tdet.net.load_state_dict(jax_variables_to_state_dict(variables, tdet.net), strict=True)
    tdet.net.eval()
    return jdet, variables, tdet, size


@pytest.mark.parametrize("family,multiscale", FAMILIES)
def test_build_detector_matches_lfdtpu(family, multiscale):
    jdet, variables, tdet, size = carried(family, multiscale)
    assert type(tdet).__name__ == type(jdet).__name__
    assert tdet.point_strides == tuple(jdet.point_strides)
    assert tdet.regression_ranges == tuple(tuple(r) for r in jdet.regression_ranges)
    assert tdet.classification_threshold == jdet.classification_threshold
    x = np.random.RandomState(3).uniform(-1.0, 1.0, (2, size, size, 3)).astype(np.float32)
    jouts = jdet.net.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        touts = tdet.net(torch.from_numpy(x))
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)


def test_per_bucket_recall_matches_lfdtpu():
    jdet, variables, tdet, size = carried("lfd", True)
    val, _ = J.make_dataset(4, seed=1, size=size, buckets=J.MULTISCALE_BUCKETS)
    jhits, jtotals = J.per_bucket_recall(jdet, variables, val, J.MULTISCALE_BUCKETS,
                                         classification_threshold=0.0)
    thits, ttotals = T.per_bucket_recall(tdet, val, T.MULTISCALE_BUCKETS,
                                         classification_threshold=0.0)
    assert jtotals.sum() > 0 and jhits.sum() > 0
    np.testing.assert_array_equal(ttotals, jtotals)
    np.testing.assert_array_equal(thits, jhits)


def test_one_epoch_reaches_the_val_loop_and_the_engines(monkeypatch):
    """Plumbing, on the CPU: one epoch (4 iterations), the Executor's val
    loop over the 16 val images, then the fp32 and int8 engines (the int8
    one calibrated on 32 training frames) each scoring the same 16. One
    epoch leaves no val detection above the detector's 0.3 classification
    threshold (the evaluator then reports no mAP, as lfdtpu's does), so the
    gate is held below 0 here; test_the_map_gate_raises holds the gate."""
    from lfdtpu_torch.evaluation import COCOEvaluator

    updates = []
    update = COCOEvaluator.update

    def counted(self, results, metas):
        updates.append(len(results))
        return update(self, results, metas)

    monkeypatch.setattr(COCOEvaluator, "update", counted)
    seen = []

    def on_engine(name, engine, score):
        seen.append((name, engine.precision_mode, engine.captured))
        return score()

    m = T.run_synthetic("lfd", epochs=1, threshold=-1.0, engine_quality=True, device="cpu",
                        on_engine=on_engine)
    assert sum(updates) == 3 * 16  # the val loop, then each engine
    assert seen == [("fp32", "fp32", False), ("int8", "int8", False)]
    assert set(m["engine_mAP_50"]) == {"fp32", "int8"}
    assert all(0.0 <= v <= 1.0 for v in m["engine_mAP_50"].values())


def test_the_map_gate_raises():
    with pytest.raises(AssertionError, match="mAP_50"):
        T.run_synthetic("lfd", epochs=1, threshold=1.0, device="cpu")


def test_engine_switches():
    det = T.build_detector("lfd")
    assert T.engine_switches(det, "bf16") == dict(precision="bf16", kernel_convs=True)
    from lfdtpu_torch.zoo import ZOO

    assert T.engine_switches(ZOO["WIDERFACE-L"](), "bf16") == dict(
        precision="bf16", kernel_convs=True, kernel_stem=True)
    assert T.engine_switches(det, "int8_bf16") == dict(precision="int8",
                                                       int8_head_dtype="bf16")


def test_int8_quality_cell_matches_lfdtpus(monkeypatch, capsys):
    """Both cells' QUALITY_RESULT lines on the same run_synthetic result
    (each package's run_synthetic replaced by one that records its
    arguments): lfdtpu's keys and values, the same run asked for, and the
    port's bf16 and int8-bf16-head mAPs and card beside them."""
    import json

    import int8_quality_cell as JC  # noqa: F401  (lfdtpu's, beside its synthetic_e2e)
    from lfdtpu_torch.tools import int8_quality_cell as TC

    metrics = {"mAP_50": 0.91234, "engine_mAP_50": {
        "fp32": 0.90012, "int8": 0.89871, "bf16": 0.90345, "int8_bf16": 0.8999}}
    asked = {}

    def fake(package):
        def run_synthetic(*args, **kwargs):
            asked[package] = kwargs
            return metrics
        return run_synthetic

    monkeypatch.setattr(J, "run_synthetic", fake("lfdtpu"))
    monkeypatch.setattr(TC, "run_synthetic", fake("port"))
    monkeypatch.setattr(sys, "argv", ["int8_quality_cell.py", "WIDERFACE-L", "7"])
    JC.main()
    TC.main(["WIDERFACE-L", "7", "--device", "cpu"])
    lines = [json.loads(line.split(" ", 1)[1]) for line in capsys.readouterr().out.splitlines()
             if line.startswith("QUALITY_RESULT ")]
    ref, got = lines
    assert set(got) == set(ref) | {"mAP_50_bf16_engine", "mAP_50_int8_bf16_engine", "card"}
    assert {k: got[k] for k in ref if k != "total_s"} == \
        {k: v for k, v in ref.items() if k != "total_s"}
    assert (got["mAP_50_bf16_engine"], got["mAP_50_int8_bf16_engine"], got["card"]) == \
        (0.9034, 0.8999, "cpu")
    port = dict(asked["port"])
    assert port.pop("device") == "cpu" and port.pop("on_engine") is None
    assert port.pop("precisions") == ("fp32", "bf16", "int8", "int8_bf16")
    assert port == asked["lfdtpu"]
