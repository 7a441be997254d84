"""The system under test: lfdtpu_torch, the PyTorch and CUDA port.

The only module of the harness that imports the program. It builds the
configuration's detector, loads the benchmark's weights into it, and hands
back the program's own entry points: the captured engine and the predict
API, the pipelined stream, the train step. The program's kernels build into
`build/kernels/` of the checkout (its own fixed, content-hashed path).
"""

from __future__ import annotations


def detector(cfg, weights, names_of):
    """The configuration's detector from the port's zoo, with `weights` (the
    reference's names; names_of(name) lists the program's names of one
    weight, a shared head's copies included) loaded strictly."""
    from lfdtpu_torch import zoo

    factory, size = cfg["zoo"]
    det = getattr(zoo, factory)(size)
    state = {}
    for name, t in weights.items():
        for n in names_of(name):
            state[n] = t
    det.net.load_state_dict(state, strict=True)
    return det


def engine(det, cfg, hw, device, batch=1):
    """The configuration's served engine: compile_inference with its
    precision, kernel switches and device normalize, captured on the card."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    s = cfg["serve"]
    pre = make_device_preprocess(s["mean"], s["std"], bgr2rgb=s.get("bgr2rgb", False))
    extra = {k: s[k] for k in ("int8_head_dtype",) if k in s}
    return compile_inference(
        det, hw, precision=s["precision"], preprocess=pre,
        classification_threshold=cfg["classification_threshold"],
        nms_threshold=cfg["nms_threshold"], batch_size=batch,
        kernel_convs=s.get("kernel_convs", False), kernel_stem=s.get("kernel_stem", False),
        nms_use_kernel=s.get("nms_use_kernel", True), device=device, **extra)


def predict(det, engine_, frame):
    """One raw frame through the predict API: rows [label, score, x, y, w, h]
    on the host."""
    return det.predict_for_single_image_with_engine(engine_, frame)


def stream(engine_, requests, depth):
    """run_stream: results (numpy dicts) in submission order."""
    from lfdtpu_torch.deploy.serving import run_stream

    return run_stream(engine_, requests, depth=depth)


def rows_of(decoded, i=0):
    """Image i of an engine's decoded dict (numpy) as the predict API's rows."""
    from lfdtpu_torch.ops.decode import detections_to_lists

    return detections_to_lists({k: v[i] for k, v in decoded.items()})


def train_step(det, cfg, device):
    """(net, optimizer, step) of the configuration's train step on
    `device`: the port's TrainState and make_train_step with the
    workload's optimizer, clip, device normalize and precision."""
    from lfdtpu_torch.deploy import make_device_preprocess
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    t, s = cfg["train"], cfg["serve"]
    o = t["optimizer"]
    state = create_train_state(det, SGD(momentum=o["momentum"], weight_decay=o["weight_decay"]),
                               device=device)
    step = make_train_step(det, state.optimizer, t["crop"], clip_max_norm=t["clip_max_norm"],
                           preprocess=make_device_preprocess(s["mean"], s["std"]),
                           mixed_precision=t["mixed_precision"])
    return state.net, state.optimizer, step


def momentum_buffers(net, optimizer):
    """{parameter name: SGD momentum buffer} (each shared parameter once,
    by its first name)."""
    out = {}
    for name, p in net.named_parameters():
        st = optimizer.state.get(p, {})
        if "momentum_buffer" in st:
            out[name] = st["momentum_buffer"].detach().clone()
    return out


def parameters(net):
    return {name: p.detach().clone() for name, p in net.named_parameters()}


def learning_rate(cfg, it):
    """The program's schedule (the workload's warmup and multistep)."""
    from lfdtpu_torch.execution import MultiStepLRSchedule, WarmupSetting

    o = cfg["train"]["optimizer"]
    sched = MultiStepLRSchedule(o["lr"], tuple(o["milestones"]), o["gamma"],
                                WarmupSetting(False, "linear", o["warmup_iters"],
                                              o["warmup_ratio"]))
    return sched(0, it)


def assignment(det, cfg, device):
    """The port's target assignment alone (ops/assign.py through the
    detector), as a callable on (gt_xywh, labels, mask)."""
    info = det.level_arrays(tuple(cfg["train"]["crop"]), device)
    return lambda gt, labels, mask: det._assign(info, gt, labels, mask.bool())
