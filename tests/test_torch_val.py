# Evaluation through the port's detector and Executor, on the CPU against
# lfdtpu on bridged weights and seeded numpy inputs:
#   - LFD.get_results / results_from_outputs (one batched decode, per-image
#     valid extents and resize scales from the loader meta): the same number
#     of rows per image, each row within ROW_TOL of lfdtpu's (float32 convs
#     summed in another order);
#   - make_eval_step: lfdtpu's dense outputs, the BN statistics untouched,
#     the net left in the mode it was found in; a one-device mesh gives the
#     same outputs, spatial (ROADMAP item 8b) refuses;
#   - the val loop (tests/test_execution.py::test_executor_val_loop, over 2
#     epochs): both Executors from the same initial state, val_interval 1, a
#     COCOEvaluator each; the per-image results of every val pass and the
#     metrics agree (rows within VAL_TOL relative: after training the two
#     nets differ by the train step's own tolerance), the hook order is
#     lfdtpu's, and val leaves the BN statistics and the train mode alone.
import json

import jax
import numpy as np
import pytest
import torch

import lfdtpu.data as jdata
import lfdtpu.evaluation as jev
import lfdtpu.execution as jexe
import lfdtpu_torch.data as tdata
import lfdtpu_torch.evaluation as tev
import lfdtpu_torch.execution as texe
from lfdtpu import models as jmodels
from lfdtpu.parallel.data_parallel import TrainState as JaxTrainState
from lfdtpu.parallel.data_parallel import make_eval_step as jax_eval_step
from lfdtpu_torch import models as tmodels
from lfdtpu_torch.parallel import TrainState, make_eval_step
from tests.test_torch_bridge import jax_and_port, randomize_norms
from tests.test_torch_executor import _ArrayDataset, _tiny

torch.set_num_threads(1)

ROW_TOL = 1e-4   # rows [label, score, x, y, w, h]: relative, plus 1e-4 absolute
VAL_TOL = 2e-3   # the same after two epochs of training on each side
THR = 0.01


def _assert_rows(got, ref, tol):
    assert [len(r) for r in got] == [len(r) for r in ref]
    for g, r in zip(got, ref):
        if r:
            np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=tol, atol=1e-4)


def test_get_results_match_lfdtpu():
    jdet, variables, tdet = jax_and_port("WIDERFACE-S")
    rng = np.random.RandomState(5)
    images = rng.uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)
    meta = [dict(resized_height=100, resized_width=77, resize_scale=0.5), None,
            dict(resize_scale=2.0)]
    ref = jdet.get_results(variables, images, meta, classification_threshold=THR)
    got = tdet.get_results(images, meta, classification_threshold=THR)
    assert len(got) == 3 and all(len(r) > 0 for r in ref)
    _assert_rows(got, ref, ROW_TOL)
    # image 0: boxes inside its valid extent, over its resize scale
    a = np.asarray(got[0])
    assert (a[:, 2] + a[:, 4] - 1 <= 77 / 0.5 + 1e-3).all()
    assert (a[:, 3] + a[:, 5] - 1 <= 100 / 0.5 + 1e-3).all()
    # results_from_outputs on lfdtpu's own dense outputs: the decode alone
    outs = jdet(variables, images, train=False)
    spec = tdet.decode_spec(THR)
    rows = tdet.results_from_outputs(tuple(torch.as_tensor(np.array(o)) for o in outs),
                                     (128, 128), meta, spec)
    _assert_rows(rows, ref, 1e-6)


def test_eval_step_matches_lfdtpu_and_leaves_the_net_alone():
    jdet, variables, tdet = jax_and_port("WIDERFACE-S")
    images = np.random.RandomState(6).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jstate = JaxTrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None)
    jc, jr = jax_eval_step(jdet)(jstate, images)

    net = tdet.net  # cached and shared: restored below
    step = make_eval_step(tdet)
    state = TrainState(net, None)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    try:
        for training in (True, False):
            net.train(training)
            tc, tr = step(state, images)
            assert net.training == training
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)
    finally:
        net.eval()
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert not tc.requires_grad
    # a mesh without a process group is one device: the same outputs
    from lfdtpu_torch.parallel import Mesh

    mesh = Mesh(1, 0, torch.device("cpu"))
    tc1, tr1 = make_eval_step(tdet, mesh)(state, images)
    assert torch.equal(tc1, tc) and torch.equal(tr1, tr)
    with pytest.raises(NotImplementedError, match="item 8b"):
        make_eval_step(tdet, mesh, spatial=True)


class _ValDataset(_ArrayDataset):
    """tests/test_execution.py's val set: 4 images with image ids."""

    def __init__(self, pkg):
        super().__init__(pkg, 4)
        rng = np.random.RandomState(1)
        for i, s in self._samples.items():
            s["image_id"] = i + 1
            s["image"] = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            s["bboxes"] = [[8, 8, 16, 16]]
            s["bbox_labels"] = [0]


class _Trace:
    """The val loop as the hooks see it. Module-level: lfdtpu pickles the
    config's extra_hooks into its checkpoint meta."""

    def before_val_epoch(self, executor):
        self.events.append("before_val_epoch")
        self.stats_before = self._stats(executor)

    def after_val_iter(self, executor):
        cfg = executor.config_dict
        assert cfg["mode"] == "val"
        self.results.append(cfg["eval_results"])
        self.metas.append(cfg["eval_meta"])

    def after_val_epoch(self, executor):
        self.events.append("after_val_epoch")
        self.stats_same.append(self._same(self.stats_before, self._stats(executor)))

    def before_train_epoch(self, executor):
        self.events.append("before_train_epoch")

    def _stats(self, executor):
        return None

    def _same(self, a, b):
        return True


class _JaxTrace(_Trace, jexe.Hook):
    def __init__(self):
        super().__init__()
        self.priority = jexe.Priority.LOWEST
        self.events, self.results, self.metas, self.stats_same = [], [], [], []


class _PortTrace(_Trace, texe.Hook):
    def __init__(self):
        super().__init__()
        self.priority = texe.Priority.LOWEST
        self.events, self.results, self.metas, self.stats_same = [], [], [], []
        self.training = []

    def _stats(self, executor):
        self.training.append(executor.state.net.training)
        return {k: v.clone() for k, v in executor.state.net.state_dict().items()
                if "running_" in k or "num_batches" in k}

    def _same(self, a, b):
        return len(a) > 0 and all(torch.equal(v, b[k]) for k, v in a.items())


def _val_config(pkg, exe, ev, det, tmp_path, name, trace, **extra):
    ds = _ValDataset(pkg)
    ann = {
        "images": [{"id": i + 1, "height": 64, "width": 64, "file_name": f"{i}.jpg"}
                   for i in range(4)],
        "annotations": [{"id": i + 1, "image_id": i + 1, "category_id": 1,
                         "bbox": [8, 8, 16, 16], "iscrowd": 0, "area": 256} for i in range(4)],
        "categories": [{"id": 1, "name": "obj"}],
    }
    ann_path = str(tmp_path / f"{name}_val.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    pipeline = pkg.Compose([pkg.simple_normalize])
    loaders = [pkg.DataLoader(ds, pkg.RandomDatasetSampler(ds, batch_size=2, shuffle=False,
                                                           seed=0),
                              pkg.IdleRegionSampler(), augmentation_pipeline=pipeline,
                              num_workers=1, max_boxes_per_image=4) for _ in range(2)]
    return dict(
        work_dir=str(tmp_path / name), training_epochs=2, display_interval=10,
        save_interval=100, val_interval=1, seed=0, batch_size=2, input_hw=(64, 64),
        model=det, optimizer=exe.SGD(momentum=0.9),
        lr_schedule=exe.ConstantLRSchedule(base_lr=0.01),
        train_data_loader=loaders[0], val_data_loader=loaders[1],
        evaluator=ev.COCOEvaluator(ann_path, {0: 1}), extra_hooks=[trace], **extra)


def test_executor_val_loop_matches_lfdtpu(tmp_path):
    jdet = _tiny(jmodels, lambda bb: {}, False)
    tdet = _tiny(tmodels, lambda bb: {"num_input_channels_list": bb.num_output_channels_list},
                 False)
    jtrace, ttrace = _JaxTrace(), _PortTrace()
    jcfg = _val_config(jdata, jexe, jev, jdet, tmp_path, "j", jtrace)
    jex = jexe.Executor(jcfg)
    variables = randomize_norms({"params": jex.state.params,
                                 "batch_stats": jex.state.batch_stats})
    jex.state = jex.state.replace(**variables)
    initial = jax.device_get(jex.state)
    jex.run()
    tcfg = _val_config(tdata, texe, tev, tdet, tmp_path, "t", ttrace, device="cpu")
    tex = texe.Executor(tcfg)
    texe.jax_train_state_to_port(tex.state, initial)
    tex.run()

    # the same hooks in the same order, EvaluationHook before LoggerHook
    names = lambda ex: [type(h).__name__ for h in ex._hooks]
    assert names(tex)[:-1] == names(jex)[:-1] == [
        "LrSchedulerHook", "OptimizerHook", "SpeedHook", "CheckpointHook", "EvaluationHook",
        "LoggerHook"]
    assert ttrace.events == jtrace.events == [
        "before_train_epoch", "before_val_epoch", "after_val_epoch"] * 2
    # two val passes of two batches of two images: one result list per image
    assert len(ttrace.results) == len(jtrace.results) == 4
    assert ttrace.metas == jtrace.metas
    assert [m["image_id"] for metas in ttrace.metas for m in metas] == [1, 2, 3, 4] * 2
    n_rows = 0
    for got, ref in zip(ttrace.results, jtrace.results):
        assert len(got) == 2
        _assert_rows(got, ref, VAL_TOL)
        n_rows += sum(len(r) for r in ref)
    assert n_rows > 0
    jm, tm = jcfg["evaluator"].metrics, tcfg["evaluator"].metrics
    assert set(tm) == set(jm) and "mAP" in tm
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-6, (k, tm[k], jm[k])
    assert "mAP" in tcfg["evaluator"].get_eval_display_str()
    # val ran in eval mode on frozen statistics and handed the net back
    assert ttrace.stats_same == [True, True]
    assert ttrace.training == [True] * 4 and tcfg["mode"] == "train"
    assert (tcfg["epoch"], tcfg["train_iter"]) == (2, 4)


def test_val_without_a_loader_is_a_no_op(tmp_path):
    det = _tiny(tmodels, lambda bb: {"num_input_channels_list": bb.num_output_channels_list},
                False)
    cfg = _val_config(tdata, texe, tev, det, tmp_path, "n", _PortTrace(), device="cpu")
    cfg["val_data_loader"] = None
    ex = texe.Executor(cfg)
    ex.val()
    assert cfg["mode"] == "train" and cfg["extra_hooks"][0].events == []
