"""The benchmark's plain reference against lfdtpu_torch on the CPU, at small
sizes, for both configurations: the dense net, the served rows, the target
assignment and the train step. (The tests may import the port; the
reference never does.)

    python -m pytest -q benchmark/tests
"""

import copy

import numpy as np
import pytest
import torch

from benchmark.core import compare, harness, spec, system
from benchmark.loops import train as train_loop
from benchmark.reference import lfd
from benchmark.reference import train as ref_train

torch.set_num_threads(2)

CELLS = {"widerface_lfd_l": "wfl-cams-1080p", "tt100k_lfd_l": "ttl-cams-2048"}


def context(config, seed=3, **cfg_update):
    c = copy.deepcopy(spec.cell(CELLS[config]))
    c["config"].update(cfg_update)
    return harness.Context(name=CELLS[config], cfg=c["config"], traffic=c["traffic"],
                           seed=seed, seconds=1, trace=False, device="cpu")


@pytest.mark.parametrize("config", sorted(CELLS))
def test_dense_net_equals_the_ports(config):
    ctx = context(config)
    w = harness.draw_weights(ctx)
    det = harness.build_detector(ctx, w).net.eval()
    frames = torch.as_tensor(harness.frame_pool(ctx, 2, (128, 192)))
    s = ctx.cfg["serve"]
    x = (frames.float() - torch.tensor(s["mean"]) * 255) / (torch.tensor(s["std"]) * 255)
    with torch.no_grad():
        got = det(x)
        ref = lfd.forward(w, ctx.cfg, frames)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max() / r.abs().max()) < 1e-5


@pytest.mark.parametrize("config", sorted(CELLS))
def test_fp32_engine_rows_equal_the_reference(config):
    """The port's fp32 engine through the predict API serves the
    reference's rows: every row matched in the pool with IoU 1 and the same
    score, and the rows themselves are the reference's decode."""
    ctx = context(config)
    ctx.cfg["serve"].update(precision="fp32", kernel_convs=False, kernel_stem=False)
    w = harness.draw_weights(ctx)
    det = harness.build_detector(ctx, w)
    hw = (250, 380)
    pad = harness.padded_hw(ctx.cfg, hw)
    eng = system.engine(det, ctx.cfg, pad, "cpu")
    frame = harness.frame_pool(ctx, 1, hw)[0]
    rows = system.predict(det, eng, frame)
    assert len(rows) > 10
    ref, pool, _ = harness.reference_rows(ctx, w, frame, pad)
    e = compare.row_errors(rows, pool, ref, ctx.cfg["nms_threshold"])
    assert e["rows"] == 2 * len(rows) and e["matched"] == len(rows) and e["unmatched"] == 0
    assert e["box_ae"] / e["matched"] < 1e-6 and e["score_ae"] / e["matched"] < 1e-5
    x = torch.zeros((1, *pad, 3), dtype=torch.uint8)
    x[0, :hw[0], :hw[1]] = torch.as_tensor(frame)
    c, r = lfd.forward(w, ctx.cfg, x)
    ref, _ = lfd.decode(c[0], r[0], lfd.level_info(ctx.cfg, pad), hw, ctx.cfg, pool=0)
    ref_rows = np.asarray(compare.decoded_rows(ref))
    assert ref_rows.shape == np.asarray(rows).shape
    np.testing.assert_allclose(np.asarray(rows), ref_rows, rtol=1e-5, atol=1e-3)


def test_row_sets_pair_one_to_one_above_the_nms_threshold():
    """A neighbour kept in place of its cluster's best pairs with it; a
    second served row on the same reference row (NMS off) and a reference
    row with no served row (a row lost) stay unpaired, and so does a row
    of another class."""
    def rows(boxes, labels):
        return dict(boxes=torch.tensor(boxes, dtype=torch.float64),
                    scores=torch.full((len(boxes),), 0.5, dtype=torch.float64),
                    labels=torch.tensor(labels))

    ref = rows([[0, 0, 20, 20], [100, 100, 120, 120], [200, 200, 230, 230]], [0, 0, 0])
    served = [[0, 0.5, 4, 0, 21, 21], [0, 0.5, 0, 0, 21, 21], [1, 0.5, 100, 100, 21, 21]]
    e = compare.row_errors(served, ref, ref, 0.4)
    assert e["rows"] == 6 and e["unmatched"] == 4  # one pair, at IoU 1; 2 served, 2 lost
    served = [[0, 0.5, 0, 0, 21, 21], [0, 0.5, 100, 100, 21, 21], [0, 0.5, 200, 200, 31, 31]]
    assert compare.row_errors(served, ref, ref, 0.4)["unmatched"] == 0


def test_assignment_equals_the_ports():
    ctx = context("widerface_lfd_l")
    ctx.cfg["train"].update(batch=3, crop=[128, 128], nmax=12)
    w = harness.draw_weights(ctx)
    det = harness.build_detector(ctx, w)
    rng = np.random.default_rng(5)
    boxes = spec.cell("wfl-train-480")["traffic"]["boxes"]
    gt, labels, mask = train_loop.ground_truth(rng, 3, (128, 128), 12, 1, boxes)
    gt, labels, mask = (torch.as_tensor(a) for a in (gt, labels, mask))
    info = det.level_arrays((128, 128), "cpu")
    cls_p, reg_p = det._assign(info, gt, labels, mask)
    ref_info = lfd.level_info(ctx.cfg, (128, 128))
    for i in range(3):
        cls_r, reg_r = lfd.assign(ref_info, gt[i], labels[i], mask[i], ctx.cfg)
        torch.testing.assert_close(cls_p[i], cls_r)
        torch.testing.assert_close(reg_p[i], reg_r)


def test_fp32_train_steps_equal_the_ports():
    """Two fp32 steps of the port's train step against the reference's,
    from the same weights and batches: losses, the first clipped gradient
    (from the optimizer's momentum buffers) and the change."""
    cell = copy.deepcopy(spec.cell("wfl-train-480"))
    cfg = cell["config"]
    cfg["train"].update(batch=2, crop=[128, 128], nmax=10, mixed_precision=False)
    cell["traffic"].update(batches=2, checked_steps=2)
    ctx = harness.Context(name="wfl-train-480", cfg=cfg, traffic=cell["traffic"], seed=9,
                          seconds=0, trace=False, device="cpu")
    train_loop.setup(ctx)
    prog = ctx.state["prog"]
    losses, grad, w, positives = ref_train.steps(ctx.state["weights"], cfg,
                                                 ctx.state["data"][:2])
    assert positives == prog["positives"]
    change = {k: w[k] - ctx.state["weights"][k] for k in grad}
    gaps = compare.train_gaps(prog["losses"], losses, prog["grad"], grad, prog["change"], change)
    assert set(prog["grad"]) == set(grad)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-3 and gaps["change_gap"] < 1e-3
