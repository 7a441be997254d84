# The port's Executor (lfdtpu_torch/execution) against lfdtpu's on the CPU:
# a tiny LFD at 64x64, batch 4, 8 seeded images (tests/test_execution.py:
# 66-157), both Executors built on the same config, lfdtpu's initial
# TrainState carried into the port (jax_train_state_to_port) before run().
# Over 2 epochs (4 iterations) they must agree on:
#   - the per-iteration lr and clip flag (exact: the same host schedule);
#   - the per-iteration losses and grad_norm, and the final params and BN
#     stats, within STEP_TOL max|err|/max|ref| (float32 convs summed in
#     another order; the batches are identical: one loader worker each,
#     seeded the same, and the port's resize is bit-exact with OpenCV here);
# on the host-augmentation path and on the device-augmentation config of
# tests/test_execution.py:240-300. Also: checkpoint save / resume /
# weight_path (counters, params and momentum exact), a port checkpoint read
# by lfdtpu.execution.load_reference_checkpoint, hook priority order,
# AverageMeter modes, the speed reading (ROADMAP F12), the refusals (no CUDA
# device, a device list in one process) and a mesh taken.
import os

import jax
import numpy as np
import pytest
import torch

import lfdtpu.data as jdata
import lfdtpu.execution as jexe
import lfdtpu_torch.data as tdata
import lfdtpu_torch.execution as texe
from lfdtpu import models as jmodels
from lfdtpu.deploy import make_device_preprocess as jax_preprocess
from lfdtpu.ops import loss_wrappers as jloss
from lfdtpu_torch import models as tmodels
from lfdtpu_torch.deploy import make_device_preprocess
from lfdtpu_torch.execution.jax_convert import jax_variables_to_state_dict
from lfdtpu_torch.ops import loss_wrappers as tloss
from tests.test_torch_bridge import randomize_norms

torch.set_num_threads(1)

STEP_TOL = 1e-4  # max|err| / max|ref| over losses, grad_norm, params, BN stats
EPOCHS = 2


def _tiny(m, nn_kw, device_aug):
    """tests/test_execution.py's tiny LFD (two levels, 8x8 and 4x4 at
    64x64) or, for the device-aug config, its one-level variant."""
    levels = ((0, 0),) if device_aug else ((0, 0), (1, 0))
    chans = (16,) if device_aug else (16, 32)
    width = 16 if device_aug else 32
    bb = m.LFDResNet(block_mode="fastest", stem_mode="fastest", body_mode=None,
                     stem_channels=16, body_architecture=(1,) * len(levels),
                     body_channels=chans, out_indices=levels,
                     norm_cfg=dict(type="BatchNorm2d"))
    strides = tuple(bb.num_output_strides_list)
    neck = m.SimpleNeck(**nn_kw(bb), num_neck_channels=width, num_input_strides_list=strides,
                        norm_cfg=dict(type="BatchNorm2d"))
    head = m.LFDHead(num_classes=1, num_heads=len(levels), num_head_channels=width,
                     num_conv_layers=1, norm_cfg=None, share_head_flag=not device_aug,
                     merge_path_flag=not device_aug, classification_loss_type="FocalLoss",
                     regression_loss_type="IoULoss",
                     **({} if m is jmodels else {"in_channels": width}))
    losses = jloss if m is jmodels else tloss
    return m.LFD(backbone=bb, neck=neck, head=head, num_classes=1,
                 regression_ranges=((0, 64),) if device_aug else ((0, 32), (32, 64)),
                 point_strides=strides, classification_loss_func=losses.FocalLoss(),
                 regression_loss_func=losses.IoULoss(), distance_to_bbox_mode="sigmoid")


class _ArrayDataset:
    """tests/test_execution.py's in-memory dataset: 8 images, 1/4 negs."""

    def __init__(self, pkg, n=8):
        rng = np.random.RandomState(0)
        self._samples = {}
        for i in range(n):
            s = pkg.Sample()
            s["image"] = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
            if i % 4 != 3:
                s["bboxes"] = [[10 + 2 * i, 10, 20, 20 + i]]
                s["bbox_labels"] = [0]
            self._samples[i] = s

    def __getitem__(self, i):
        return self._samples[i]

    def __len__(self):
        return len(self._samples)

    def get_indexes(self):
        return list(self._samples.keys())


def _config(pkg, exe, det, work_dir, device_aug, **extra):
    ds = _ArrayDataset(pkg)
    region = pkg.RandomBBoxCropRegionSampler(crop_size=64, resize_range=(0.8, 1.2))
    if device_aug:
        region = pkg.DeviceAugRegionSampler(region, flip_p=0.5)
    loader = pkg.DataLoader(
        ds, pkg.RandomWithNegDatasetSampler(ds, batch_size=4, neg_ratio=0.25, seed=0),
        region, augmentation_pipeline=None if device_aug else pkg.simple_widerface_train_pipeline,
        num_workers=1, max_boxes_per_image=8, image_dtype=np.uint8 if device_aug else np.float32)
    config = dict(
        work_dir=str(work_dir), training_epochs=EPOCHS, display_interval=1, save_interval=1,
        seed=1, batch_size=4, input_hw=(64, 64), model=det,
        optimizer=exe.SGD(momentum=0.9, weight_decay=1e-4),
        lr_schedule=exe.MultiStepLRSchedule(
            base_lr=0.01, milestones=(1,), gamma=0.1,
            warmup=exe.WarmupSetting(warmup_mode="linear", warmup_loops=2, warmup_ratio=0.1)),
        optimizer_grad_clip_cfg=dict(max_norm=10, duration=1),
        train_data_loader=loader, **extra)
    if device_aug:
        pre = jax_preprocess if pkg is jdata else make_device_preprocess
        config["device_augment"] = pkg.make_device_augment(64, normalize=pre((0.5,) * 3,
                                                                             (0.5,) * 3))
    return config


class _Record:
    """Per iteration: lr, clip flag, losses, grad_norm (read before
    LoggerHook clears the meter). Module-level: lfdtpu pickles the
    config's extra_hooks into its checkpoint meta."""

    def after_train_iter(self, executor):
        cfg = executor.config_dict
        meter = cfg["train_average_meter"]
        self.rows.append(dict(
            lr=cfg["current_lr"], clip=cfg["clip_enabled"], grad_norm=cfg["grad_norm"],
            **{n: meter.get_average(n) for n in meter.get_all_names() if "loss" in n}))


class _JaxRecord(_Record, jexe.Hook):
    def __init__(self):
        super().__init__()
        self.priority, self.rows = jexe.Priority.HIGH, []


class _PortRecord(_Record, texe.Hook):
    def __init__(self):
        super().__init__()
        self.priority, self.rows = texe.Priority.HIGH, []


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12))


def _run_both(tmp_path, device_aug):
    jdet = _tiny(jmodels, lambda bb: {}, device_aug)
    tdet = _tiny(tmodels, lambda bb: {"num_input_channels_list": bb.num_output_channels_list},
                 device_aug)
    jrec, trec = _JaxRecord(), _PortRecord()
    # each Executor seeds `random` (the region sampler's stream) when it is
    # built, so each is built right before it runs
    jex = jexe.Executor(_config(jdata, jexe, jdet, tmp_path / "j", device_aug,
                                extra_hooks=[jrec]))
    # non-zero norm affines, biases and stats: a tensor that starts at zero
    # would be held to the relative error of its few small updates
    variables = randomize_norms({"params": jex.state.params,
                                 "batch_stats": jex.state.batch_stats})
    jex.state = jex.state.replace(**variables)
    initial = jax.device_get(jex.state)
    jex.run()
    tex = texe.Executor(_config(tdata, texe, tdet, tmp_path / "t", device_aug,
                                extra_hooks=[trec], device="cpu"))
    texe.jax_train_state_to_port(tex.state, initial)
    tex.run()
    return jdet, jex, jrec.rows, tdet, tex, trec.rows


@pytest.mark.parametrize("device_aug", [False, True], ids=["host_aug", "device_aug"])
def test_executor_matches_lfdtpu_over_two_epochs(tmp_path, device_aug):
    jdet, jex, jrows, tdet, tex, trows = _run_both(tmp_path, device_aug)
    assert len(jrows) == len(trows) == 2 * EPOCHS
    assert [(r["lr"], r["clip"]) for r in trows] == [(r["lr"], r["clip"]) for r in jrows]
    assert [r["clip"] for r in trows] == [True, True, False, False]  # duration 1
    worst = {}
    for name in ("loss", "classification_loss", "regression_loss", "grad_norm"):
        worst[name] = _max_rel([r[name] for r in trows], [r[name] for r in jrows])
    jsd = jax_variables_to_state_dict(jax.device_get(jex.variables), tdet.net)
    tsd = tex.state.net.state_dict()
    for k, v in jsd.items():
        if v.is_floating_point():
            worst[k] = _max_rel(tsd[k].detach(), v)
    assert max(worst.values()) <= STEP_TOL, sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    assert sorted(os.listdir(tmp_path / "t")) == ["epoch_1.pth", "epoch_2.pth"]


def _port_executor(tmp_path, name, **extra):
    det = _tiny(tmodels, lambda bb: {"num_input_channels_list": bb.num_output_channels_list},
                False)
    return texe.Executor(_config(tdata, texe, det, tmp_path / name, False, device="cpu",
                                 **extra))


def test_save_resume_and_weight_path(tmp_path):
    ex = _port_executor(tmp_path, "a")
    ex.run()
    path = str(tmp_path / "a" / "epoch_1.pth")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"state_dict", "optimizer", "meta"}
    assert ckpt["meta"]["epoch"] == 0 and ckpt["meta"]["train_iter"] == 2
    assert ckpt["meta"]["input_hw"] == (64, 64) and "model" not in ckpt["meta"]

    resumed = _port_executor(tmp_path, "b", resume_path=path)
    assert resumed.config_dict["epoch"] == 1 and resumed.config_dict["train_iter"] == 2
    for k, v in resumed.state.net.state_dict().items():
        assert torch.equal(v, ckpt["state_dict"][k]), k
    momentum = {id(p): resumed.state.optimizer.state[p]["momentum_buffer"]
                for p in resumed.state.net.parameters()}
    saved = ckpt["optimizer"]["state"]
    assert len(saved) == len(momentum)
    for i, p in enumerate(resumed.state.net.parameters()):
        assert torch.equal(momentum[id(p)], saved[i]["momentum_buffer"])
    resumed.run()  # the second epoch only
    assert resumed.config_dict["epoch"] == 2 and resumed.config_dict["train_iter"] == 4
    assert all(torch.isfinite(v.float()).all() for v in resumed.state.net.state_dict().values())

    init = _port_executor(tmp_path, "c", weight_path=path)
    assert init.config_dict["epoch"] == 0
    for k, v in init.state.net.state_dict().items():
        assert torch.equal(v, ckpt["state_dict"][k]), k
    assert not init.state.optimizer.state  # weights only: no momentum
    partial = {k: v for k, v in ckpt["state_dict"].items() if k.startswith("_backbone.")}
    torch.save({"state_dict": partial}, str(tmp_path / "backbone.pth"))
    other = _port_executor(tmp_path, "d", weight_path=str(tmp_path / "backbone.pth"))
    for k, v in other.state.net.state_dict().items():
        if k.startswith("_backbone."):
            assert torch.equal(v, ckpt["state_dict"][k]), k
    fresh = _port_executor(tmp_path, "e").state.net
    assert texe.load_backbone_weights(fresh._backbone, path).missing_keys == []
    for k, v in fresh._backbone.state_dict().items():
        assert torch.equal(v, ckpt["state_dict"]["_backbone." + k]), k


def test_port_checkpoint_loads_into_lfdtpu(tmp_path):
    ex = _port_executor(tmp_path, "a")
    ex.run()
    jdet = _tiny(jmodels, lambda bb: {}, False)
    template = jdet.init(jax.random.PRNGKey(0), (64, 64))
    variables = jexe.load_reference_checkpoint(str(tmp_path / "a" / "epoch_2.pth"), jdet,
                                               template)
    rng = np.random.RandomState(3)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jc, jr = jdet(variables, images, train=False)
    net = ex.state.net.eval()
    with torch.no_grad():
        tc, tr = net(torch.as_tensor(images))
    assert _max_rel(tc.numpy(), np.asarray(jc)) <= STEP_TOL
    assert _max_rel(tr.numpy(), np.asarray(jr)) <= STEP_TOL


def test_hook_priority_order_and_average_meter():
    orders = []
    for exe in (texe, jexe):
        class Named(exe.Hook):
            def __init__(self, name, priority):
                super().__init__()
                self.name, self.priority = name, priority

        ex = object.__new__(exe.Executor)
        ex._hooks = []
        for name, p in (("a", 50), ("b", "HIGHEST"), ("c", exe.Priority.LOW), ("d", 50),
                        ("e", 0), ("f", "very_high")):
            ex.register_hook(Named(name, p))
        orders.append([h.name for h in ex._hooks])
    assert orders[0] == orders[1] == ["b", "e", "f", "a", "d", "c"]
    with pytest.raises(ValueError):
        texe.get_priority(101)

    tm, jm = texe.AverageMeter(), jexe.AverageMeter()
    for name, v, w in (("loss", 2.0, 4), ("loss", 3.0, 2), ("speed", 64, 0.5), ("x", 1, 0)):
        tm.update(name, v, w)
        jm.update(name, v, w)
    for name in ("loss", "speed", "x", "missing"):
        for mode in ("weighted_sum", "sum"):
            assert tm.get_average(name, mode) == jm.get_average(name, mode)
    assert tm.get_all_names() == jm.get_all_names() == ["loss", "speed", "x"]
    tm.clear()
    assert tm.get_all_names() == []


def test_speed_reads_images_per_second(monkeypatch):
    """ROADMAP F12: lfdtpu's SpeedHook weights the batch size by the
    seconds, so its "images/s" reads batch x seconds; the port's reads the
    mean of batch / seconds."""
    import time

    clock = iter([100.0, 100.5, 200.0, 200.25])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    meters = {}
    for exe in (texe, jexe):
        cfg = dict(batch_size=8, train_average_meter=exe.AverageMeter())
        ex = type("E", (), {"config_dict": cfg})()
        hook = exe.SpeedHook()
        hook.before_train_iter(ex)
        hook.after_train_iter(ex)
        meters[exe] = cfg["train_average_meter"].get_average("speed", "sum")
    assert meters[texe] == 8 / 0.5
    assert meters[jexe] == 8 * 0.25  # lfdtpu: batch x seconds


def test_executor_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    det = _tiny(tmodels, lambda bb: {"num_input_channels_list": bb.num_output_channels_list},
                False)
    base = lambda **kw: _config(tdata, texe, det, tmp_path / "w", False, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texe.Executor(base())  # the workload default device is cuda
    # a device list would be DataParallel: one process drives one device
    with pytest.raises(ValueError, match="launch one process per device"):
        texe.Executor(base(device=["cuda:0", "cuda:1"]))
    # a real mesh is taken: its device is the run's (ROADMAP item 8)
    from lfdtpu_torch.parallel import Mesh

    ex = texe.Executor(base(device="cuda", mesh=Mesh(1, 0, torch.device("cpu"))))
    assert ex.device == torch.device("cpu") and ex.mesh.size == 1 and ex.rank == 0
    # a val loop and an evaluator are taken now (tests/test_torch_val.py runs them)
    ex = texe.Executor(base(device="cpu", val_interval=1, val_data_loader=object(),
                            evaluator=object()))
    assert "EvaluationHook" in [type(h).__name__ for h in ex._hooks]
