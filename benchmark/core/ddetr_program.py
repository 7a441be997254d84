"""The program's entry points that the Deformable DETR cell needs: the
port's zoo model with the benchmark's weights, its captured engine, and the
handles the cell's after-window measurement and its faults take (the port's
MSDA sampling function and the net's class). With system.py, programs.py
and spans.py the modules of the harness that import the program, and for
them only; a program without the model raises at its first call.
"""

from __future__ import annotations

import torch


def detector(weights):
    """The port's Deformable DETR-R50 (zoo.deformable_detr_r50) with
    `weights` (the reference's names are the program's own) loaded
    strictly."""
    from lfdtpu_torch import zoo

    det = zoo.deformable_detr_r50()
    det.net.load_state_dict(weights, strict=True)
    return det


def engine(det, cfg, hw, device):
    """compile_inference at hw with the configuration's precision and
    device normalize (RGB from BGR frames), batch 1: captured on the card,
    eager on the CPU."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    s = cfg["serve"]
    pre = make_device_preprocess(s["mean"], s["std"], bgr2rgb=s["bgr2rgb"])
    return compile_inference(det, hw, precision=s["precision"], preprocess=pre,
                             batch_size=s["batch"], device=device)


def msda_ops():
    """The port's module of ms_deform_attn (lfdtpu_torch.ops.msda), whose
    attribute every MSDA layer calls."""
    from lfdtpu_torch.ops import msda

    return msda


def net_class():
    """The port's DeformableDETRNet (its _refine is the decoder's box
    refinement)."""
    from lfdtpu_torch.models.deformable_detr import DeformableDETRNet

    return DeformableDETRNet


def msda_calls(engine_, frames, valid_hw):
    """(ms_deform_attn, [the arguments of each of its calls]) of one eager
    forward of the engine's program on `frames` (B, H, W, 3) at its
    resolution on its device, `valid_hw` (B, 2): the calls' own inputs, to
    replay the sampling alone."""
    mod = msda_ops()
    real, calls = mod.ms_deform_attn, []

    def record(*args):
        calls.append(args)
        return real(*args)

    mod.ms_deform_attn = record
    try:
        with torch.inference_mode():
            engine_.program(frames, valid_hw)
    finally:
        mod.ms_deform_attn = real
    return real, calls
