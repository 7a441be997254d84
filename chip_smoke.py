#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lfdtpu_torch) on one NVIDIA GPU.

Drives the port's two paths at full width, the WIDERFACE-L inference engine
(random seeded weights with randomized BatchNorm statistics and affines and
head Scales, so the BN folding is exercised) and the WIDERFACE-L training
step, and checks them:

  1. card     the GPU's name and power limit (nvidia-smi);
  2. build    the hand-written kernels from lfdtpu_torch/csrc/*.cu (nvcc);
  3. K1       NMS keep mask against its plain version, EXACT, at K = 1000 and
              1536, batch 4: random boxes, valid holes, tied scores, integer
              boxes whose IoUs hit the threshold exactly, and the greedy walk's
              hard cases: a suppression chain (every other box kept), disjoint
              boxes (all kept), identical boxes (one kept);
  4. K2, K3   stem and 3x3 conv against their plain versions at the engine's
              1088x1920 shapes, at batch 1 and at the bf16_kernels_b4
              engine's batch 4, max|err| / max|ref| < 0.03 (K2), 0.02 (K3):
              K3 is bf16 out of fp32 accumulation in another order, K2 also
              rounds its taps and weights to bf16 (the TPU kernel's
              numerics);
  5. engine   bf16 engines at 1088x1920 (1080p padded to the stride-64
              multiple): 8 single frames through
              predict_for_single_image_with_engine and one batch of 4 with
              different valid extents through predict_for_batch_with_engine,
              with all three kernels on; every kernel's launch counter must
              grow during that run. Then: dense outputs of the kernel engine
              against the plain bf16 engine and both against fp32; decode + NMS on the same dense
              outputs, K1 against plain, rows identical; the fp32 engine on the
              GPU against the fp32 port on the CPU at 256x256, TF32 off;
  6. train    the training path (forward, on-device target assignment,
              loss, backward, clip, SGD) of WIDERFACE-L, which runs no
              hand-written kernel: two fp32 steps at 128x128, batch 2, on the
              GPU against the same steps on the CPU (loss, grad_norm, every
              param and BN running stat, max|err|/max|ref| < 1e-3, TF32 off);
              then full width at the workload's batch 64, crop 480x480, GT
              padded to 200 rows, SGD momentum 0.9 / wd 1e-4, clip 10 and its
              warmup schedule, 20 steps in fp32 and 20 in bf16 autocast on one
              fixed batch (finite, loss falls, fp32 master weights, BN stats
              move; ms/step, images/s, peak memory); then the trained net is
              compiled into the bf16 engine with all three kernels and serves
              a frame (every kernel launches, rows checked), and
              predict_for_single_image on the net left in train() leaves its
              running stats alone;
  7. timings  CUDA events, warmup excluded: ms/frame of the three engines; each
              kernel's device ms (CUDA events around replays of a CUDA graph
              of its launches, warm on repeated inputs and cold rotating over
              more than the 50 MB L2) at the shapes the engine gives it, beside
              its bound (kernel_bound_ms), its share of the bound, its plain
              version (eager) and, for K3, cuDNN in bf16 with the BN folded
              in: conv2d alone, with the bias, followed by the residual add
              and ReLU, and the fused call of K3's own function
              (cudnn_convolution_add_relu / _relu), which is K3's library
              call where the card runs it; K1 on random boxes at B=1,
              K=1000, on the walk's hard cases and at B=4, each with its
              kept count;
              one frame of the bf16_kernels engine launches K1 once, K2 once
              and K3 10 times; torch.profiler over 5 frames of that engine
              gives each kernel's device ms per frame; all beside the card's
              name and power limit;
  8. workload the WIDERFACE training entry point end to end: a seeded
              synthetic pack (170 uint8 images 1024 wide, 680-1024 high, 0-30
              faces of 4-320 px, every fifth a negative: 3 iterations per
              epoch at batch 64) built with the port's Dataset in a temporary
              directory; the port's WIDERFACE_LFD_L config (its _common, with
              LFD_DEVICE_AUG=1: batch 64, crop 480, Nmax 200, fp32) trains 2
              epochs through the Executor (finite losses that do not blow up,
              the warmup lr, epoch_1.pth), resumes from epoch_1.pth (counters,
              params exact) for the last epoch under torch.profiler, then the
              host-augmentation config (LFD_DEVICE_AUG=0) trains the same
              iterations; the device half of the augmentation on the GPU
              against the CPU on one loader batch (1e-3 pixel units); the
              final checkpoint served through the bf16 kernel engine (every
              kernel launches). Printed beside the card: loader-alone
              images/s of both paths (4 batches per worker thread, every
              image over the time from the workers' start to the last
              batch), Executor images/s after one warmup
              iteration (wall time ending in a synchronize), device-aug and
              H2D ms per batch (CUDA events) and the device-busy share of the
              two profiled iterations, whose batches were already prefetched.

The second-to-last line is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Any failed check exits non-zero. Needs a
CUDA device: without one it exits 1 and prints no result.

Run from the root of a checkout:  python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HW = (1088, 1920)           # 1080p padded to the stride-64 multiple
SMALL_HW = (256, 256)       # fp32 GPU vs CPU reference size
MEAN, STD = (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)
K2_TOL, K3_TOL = 0.03, 0.02
# bf16 engines, max|err| / max|ref| of the dense outputs: a random deep net
# amplifies bf16 rounding (each bf16 engine lands 3-4% from fp32 at small
# sizes on the CPU), and the kernels round at other places (fp32 normalize in
# the stem, one rounding after the folded BN) than the plain engine. So the
# kernel engine must stay near the plain one AND no further from fp32.
DENSE_BF16_TOL = 0.1
DENSE_BF16_VS_PLAIN = 1.5
DENSE_FP32_TOL = 1e-3       # GPU vs CPU fp32 engine, max|err| / max|ref|
TIMED_ITERS, WARMUP = 20, 3
# kernel bounds: NVIDIA's H100 SXM data sheet, dense rates (see kernel_bound_ms)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
IOU_FLOPS = 14              # per box pair: 4 min/max, 2 sub, 2 clamp, mul, 2 add/sub,
#                             max, div, compare (K1's IoU test)
GRAPH_LAUNCHES = 20         # kernel timing: launches per CUDA graph
COLD_BYTES = 100 * 2 ** 20  # cold timing rotates over more inputs than the L2 holds
PROFILED_FRAMES = 5
NMS_KERNEL_NAME = re.compile(r"nms_\w+(<[^>]*>)?")  # K1's kernels in a profile
ENGINE_LAUNCHES = {"nms_mask_sorted": 1, "stem_conv": 1, "pair_conv3x3": 10}  # one L frame
# training: the WIDERFACE workload's batch, crop, GT padding and optimizer
# (`workloads/WIDERFACE_train/_common.py:82-158`)
TRAIN_HW, TRAIN_BATCH, TRAIN_NMAX = (480, 480), 64, 200
TRAIN_STEPS, TRAIN_WARMUP = 20, 3
TRAIN_SMALL_HW = (128, 128)  # GPU vs CPU, batch 2
TRAIN_TOL = 1e-3            # GPU vs CPU fp32 steps, max|err| / max|ref|
SERVE_HW = (480, 480)       # the trained net's engine
# the workload phase: pack size and the checks' tolerances
PACK_IMAGES, PACK_NEG_EVERY = 170, 5  # 136 positives: 3 iterations of 52 + 12 negs
AUG_TOL = 1e-3              # device-aug GPU vs CPU, pixel units (0-255)
LOSS_BLOWUP = 1.5           # the last loss may not exceed the first by more
LOADER_BATCHES_PER_WORKER = 4  # loader-alone run length, per worker thread
SERVE_THRESHOLD = 1e-4      # the workload checkpoint's engine, see workload_phase


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def time_ms(fn, iters=TIMED_ITERS, warmup=WARMUP):
    """Mean ms per call by CUDA events around `iters` calls, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, launches=GRAPH_LAUNCHES, reps=5):
    """Device ms per call: CUDA events around `reps` replays of a CUDA graph
    of `launches` calls cycling through `calls` (one per input set), after
    one eager call each and one replay. Replaying keeps the host's cost of an
    eager call (Python, ctypes; tens of µs, more than the small launches
    take on the device) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * reps)


def kernel_work(name, shape, residual=False):
    """(bytes, operations, their type) of one launch: each input read once
    and each output written once, the operations its inputs need.
    shape: (N, H, W) of K3's activations or K2's frame; (B, K) for K1."""
    if name == "pair_conv3x3":
        n, h, w = shape
        act = n * h * w * 64 * 2  # bf16 NHWC
        weights = 9 * 64 * 64 * 2 + 2 * 64 * 4  # + fp32 scale, bias
        return act * (3 if residual else 2) + weights, 2 * n * h * w * 64 * 9 * 64, "bf16"
    if name == "stem_conv":
        n, h, w = shape
        out = n * ((h + 1) // 2) * ((w + 1) // 2)
        consts = 27 * 64 * 4 + 2 * 3 * 4 + 2 * 64 * 4  # fp32 weights, mean/std, scale/bias
        return n * h * w * 3 + out * 64 * 2 + consts, 2 * out * 64 * 27, "bf16"
    if name == "nms_mask_sorted":
        b, k = shape  # fp32 xyxy boxes and a bool mask in, a bool mask out
        return b * k * (16 + 1 + 1), b * k * (k - 1) // 2 * IOU_FLOPS, "fp32"
    raise ValueError(f"unknown kernel {name}")


def kernel_bound_ms(name, shape, residual=False):
    """The least time the card could take for one launch: the larger of its
    bytes over the memory rate and its operations over the peak rate of
    their type (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 tensor, 67 TFLOP/s
    fp32). Returns (ms, "bytes" or "operations"), whichever binds."""
    nbytes, ops, kind = kernel_work(name, shape, residual)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_shapes(hw=HW):
    """K3's (H, W) in the engine: the stride-4, -8 and -16 levels."""
    h, w = (hw[0] + 3) // 4, (hw[1] + 3) // 4
    return (h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 3) // 4, (w + 3) // 4)


# --------------------------------------------------------------------- model

def build_detector(device, seed=0):
    """WIDERFACE-L at full width, seeded init, randomized norms and Scales."""
    import torch
    from torch import nn

    from lfdtpu_torch import zoo
    from lfdtpu_torch.models.layers import Scale

    det = zoo.widerface_lfd("L")
    g = torch.Generator().manual_seed(seed)
    det.init(g)
    with torch.no_grad():
        for m in det.net.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            if isinstance(m, Scale):
                m._scale.uniform_(0.5, 1.5, generator=g)
    det.net.to(device).eval()
    return det


def frames(rng, n, hw):
    return rng.randint(0, 256, (n,) + tuple(hw) + (3,)).astype(np.uint8)


# ---------------------------------------------------------------- kernels

def check_k1(device, sizes=(1000, 1536)):
    """K1 against its plain version: exact masks. Returns the largest
    |kernel - plain| over all masks (as 0/1 values; 0 when exact)."""
    import torch

    from lfdtpu_torch.ops import nms_kernel
    from lfdtpu_torch.ops.nms import nms_mask

    rng = np.random.RandomState(1)
    worst = 0.0
    for K in sizes:
        xy = rng.rand(4, K, 2) * 12 * K ** 0.5
        wh = rng.rand(4, K, 2) * 60 + 1
        cases = {
            "random": (np.concatenate([xy, xy + wh], -1), rng.rand(4, K),
                       np.ones((4, K), bool)),
            "valid holes": (np.concatenate([xy, xy + wh], -1), rng.rand(4, K),
                            rng.rand(4, K) > 0.3),
            "tied scores": (np.concatenate([xy, xy + wh], -1),
                            rng.randint(0, 5, (4, K)) / 5.0, rng.rand(4, K) > 0.1),
        }
        gxy = rng.randint(0, 40, (4, K, 2)) * 2.0  # integer boxes: exact 0.5 IoUs
        gwh = rng.randint(1, 5, (4, K, 2)) * 2.0
        cases["exact-threshold"] = (np.concatenate([gxy, gxy + gwh], -1),
                                    rng.rand(4, K), np.ones((4, K), bool))
        scores = np.tile(1.0 - np.arange(K) / K, (4, 1))  # the hard cases come sorted
        cases.update({name: (b.numpy(), scores, v.numpy())
                      for name, (b, v) in nms_kernel.walk_cases(4, K).items()})
        for name, (b, s, v) in cases.items():
            boxes = torch.as_tensor(b, dtype=torch.float32, device=device)
            scores = torch.as_tensor(s, dtype=torch.float32, device=device)
            valid = torch.as_tensor(v, device=device)
            thr = 0.5 if name == "exact-threshold" else 0.4
            got = nms_mask(boxes, scores, thr, valid=valid, use_kernel=True)
            ref = nms_mask(boxes, scores, thr, valid=valid, use_kernel=False)
            direct = nms_kernel.nms_mask_sorted(boxes.contiguous(), valid, thr)
            direct_ref = nms_kernel.nms_mask_sorted_plain(boxes, valid, thr)
            if boxes.is_cuda:
                torch.cuda.synchronize()
            bad = int((got != ref).sum()) + int((direct != direct_ref).sum())
            worst = max(worst, float(bad > 0))
            print(f"K1 K={K} {name}: kept {int(got.sum())}/{int(valid.sum())}, "
                  f"mismatches {bad}")
            check(bad == 0, f"K1 disagrees with its plain version (K={K}, {name})")
    return worst


def check_k2_k3(device, hw=HW):
    """K2 and K3 against their plain versions at the engine's shapes, batch
    1 and the bf16_kernels_b4 engine's batch 4. Returns ({name: max abs
    err}, K2's batch-1 inputs, K3's batch-1 inputs at the first level)."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    g = torch.Generator(device=device).manual_seed(2)
    w = torch.randn(3, 3, 3, 64, generator=g, device=device) * 0.2
    mean = torch.tensor([127.5] * 3, device=device)
    std = torch.tensor([127.5] * 3, device=device)
    s = torch.rand(64, generator=g, device=device) + 0.5
    b = torch.randn(64, generator=g, device=device) * 0.1
    abs2, k2_inputs = 0.0, None
    for n in (1, 4):
        frame = torch.randint(0, 256, (n,) + tuple(hw) + (3,), generator=g,
                              device=device, dtype=torch.uint8)
        got = ck.stem_conv(frame, w, mean, std, s, b)
        ref = ck.stem_conv_plain(frame, w, mean, std, s, b)
        e2 = rel_err(got, ref)
        abs2 = max(abs2, float((got.float() - ref.float()).abs().max()))
        print(f"K2 {tuple(frame.shape)} -> {tuple(got.shape)}: max|err|/max|ref| "
              f"{e2:.3e} (tol {K2_TOL})")
        check(got.shape == ref.shape and e2 < K2_TOL, "K2 disagrees with its plain version")
        if k2_inputs is None:
            k2_inputs = (frame, w, mean, std, s, b)

    abs3, k3_inputs = 0.0, None
    for n in (1, 4):
        for (hh, ww) in k3_shapes(hw):
            x = torch.randn(n, hh, ww, 64, generator=g, device=device).bfloat16()
            wk = (torch.randn(3, 3, 64, 64, generator=g, device=device) * 0.05).bfloat16()
            for residual, relu in ((None, True), (x, True), (None, False)):
                got = ck.pair_conv3x3(x, wk, s, b, residual=residual, relu=relu)
                ref = ck.pair_conv3x3_plain(x, wk, s, b, residual=residual, relu=relu)
                e3 = rel_err(got, ref)
                abs3 = max(abs3, float((got.float() - ref.float()).abs().max()))
                print(f"K3 {tuple(x.shape)} residual={residual is not None} relu={relu}: "
                      f"max|err|/max|ref| {e3:.3e} (tol {K3_TOL})")
                check(e3 < K3_TOL, "K3 disagrees with its plain version")
            if k3_inputs is None:
                k3_inputs = (x, wk, s, b)
    if device != "cpu":
        torch.cuda.synchronize()
    return {"stem_conv": abs2, "pair_conv3x3": abs3}, k2_inputs, k3_inputs


# ----------------------------------------------------------------- engine

def compile_engines(det, hw, device):
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    pre = make_device_preprocess(MEAN, STD)
    kernels = dict(nms_use_kernel=True, kernel_convs=True, kernel_stem=True)
    plain = dict(nms_use_kernel=False, kernel_convs=False, kernel_stem=False)
    return dict(
        bf16_kernels=compile_inference(det, hw, "bf16", preprocess=pre, device=device,
                                       **kernels),
        bf16_kernels_b4=compile_inference(det, hw, "bf16", preprocess=pre,
                                          batch_size=4, device=device, **kernels),
        bf16_plain=compile_inference(det, hw, "bf16", preprocess=pre, device=device,
                                     **plain),
        fp32=compile_inference(det, hw, "fp32", preprocess=pre, device=device),
    )


def serve(det, engines, hw, rng):
    """The main path: 8 single frames and one batch of 4 with different
    valid extents, through the predict entry points. Returns the rows."""
    h, w = hw
    singles = []
    for i in range(8):
        singles.append(frames(rng, 1, (h - 8 - i * (h // 32), w - i * (w // 16)))[0])
    rows_single = [det.predict_for_single_image_with_engine(engines["bf16_kernels"], f)
                   for f in singles]
    batch = [frames(rng, 1, s)[0] for s in ((h - 8, w), (h * 2 // 3, w * 2 // 3),
                                             (h, w * 3 // 4), (h // 2, w // 3))]
    rows_batch = det.predict_for_batch_with_engine(engines["bf16_kernels_b4"], batch)
    for rows, img in zip(rows_single + rows_batch, singles + batch):
        check_rows(det, rows, img)
    return rows_single, rows_batch


def check_rows(det, rows, img):
    """Reference result rows [label, score, x, y, w, h] of one image."""
    arr = np.asarray(rows, np.float64).reshape(-1, 6)
    check(np.isfinite(arr).all(), "non-finite detection rows")
    check(len(arr) <= det.post_nms_bbox_limit, "more rows than max_det")
    if len(arr):
        check((arr[:, 0] == 0).all(), "label outside the single WIDERFACE class")
        check(((arr[:, 1] > 0) & (arr[:, 1] <= 1)).all(), "score outside (0, 1]")
        x2 = arr[:, 2] + arr[:, 4] - 1
        y2 = arr[:, 3] + arr[:, 5] - 1
        check((arr[:, 2] >= 0).all() and (x2 <= img.shape[1] + 1e-3).all()
              and (arr[:, 3] >= 0).all() and (y2 <= img.shape[0] + 1e-3).all(),
              "box outside the image's valid extent")


def check_engine_parity(det, engines, hw, rng):
    import torch

    imgs = frames(rng, 1, hw)
    vhw = np.asarray([hw[0] - 8, hw[1]], np.float32)
    ck, rk = engines["bf16_kernels"].dense(imgs)
    cp, rp = engines["bf16_plain"].dense(imgs)
    cf, rf = engines["fp32"].dense(imgs)
    ec, er = rel_err(ck, cp), rel_err(rk, rp)
    kc, kr = rel_err(ck, cf), rel_err(rk, rf)
    pc, pr = rel_err(cp, cf), rel_err(rp, rf)
    print(f"engine bf16 dense max|err|/max|ref|: kernels vs plain cls {ec:.3e} reg "
          f"{er:.3e} (tol {DENSE_BF16_TOL}); vs fp32: kernels cls {kc:.3e} reg "
          f"{kr:.3e}, plain cls {pc:.3e} reg {pr:.3e} (kernels within "
          f"{DENSE_BF16_VS_PLAIN}x of plain)")
    check(ec < DENSE_BF16_TOL and er < DENSE_BF16_TOL,
          "bf16 kernel engine disagrees with the plain bf16 engine")
    check(kc <= DENSE_BF16_VS_PLAIN * pc + 1e-3 and kr <= DENSE_BF16_VS_PLAIN * pr + 1e-3,
          "bf16 kernel engine is further from fp32 than the plain bf16 engine")
    dk = engines["bf16_kernels"].decode(ck, rk, vhw)
    dp = engines["bf16_plain"].decode(ck, rk, vhw)
    same = all(torch.equal(dk[k], dp[k]) for k in dk)
    print(f"decode + NMS on the same dense outputs, K1 vs plain: "
          f"{int(dk['count'][0])} rows, identical={same}")
    check(same, "decode with K1 differs from decode with the plain NMS")
    return imgs


def check_fp32_reference(det, device, rng):
    """The fp32 engine on the GPU against the fp32 port on the CPU."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    pre = make_device_preprocess(MEAN, STD)
    gpu = compile_inference(det, SMALL_HW, "fp32", preprocess=pre, device=device)
    cpu = compile_inference(det, SMALL_HW, "fp32", preprocess=pre, device="cpu")
    imgs = frames(rng, 1, SMALL_HW)
    vhw = np.asarray(SMALL_HW, np.float32)
    (cg, rg), (cc, rc) = gpu.dense(imgs), cpu.dense(imgs)
    ec, er = rel_err(cg.cpu(), cc), rel_err(rg.cpu(), rc)
    print(f"fp32 {SMALL_HW} dense GPU vs CPU: cls {ec:.3e}, reg {er:.3e} "
          f"max|err|/max|ref| (tol {DENSE_FP32_TOL}, TF32 off)")
    check(ec < DENSE_FP32_TOL and er < DENSE_FP32_TOL, "fp32 GPU engine disagrees with CPU")
    dg = {k: v.cpu().numpy() for k, v in gpu(imgs, vhw).items()}
    dc = {k: v.numpy() for k, v in cpu(imgs, vhw).items()}
    ng, nc = int(dg["count"][0]), int(dc["count"][0])
    # near-tied scores may swap the greedy order: match rows, not positions
    matched = 0
    for i in range(ng):
        d = (np.abs(dc["scores"][0, :nc] - dg["scores"][0, i]) < 1e-4) & \
            (np.abs(dc["boxes"][0, :nc] - dg["boxes"][0, i]).max(-1) < 0.05) & \
            (dc["labels"][0, :nc] == dg["labels"][0, i])
        matched += bool(d.any())
    print(f"fp32 {SMALL_HW} detections GPU vs CPU: {ng} vs {nc} rows, "
          f"{matched} GPU rows matched (score 1e-4, box 0.05 px)")
    check(ng > 0 and abs(ng - nc) <= 2 and matched >= 0.9 * ng,
          "fp32 GPU detections disagree with the CPU reference")


# ----------------------------------------------------------------- train

def train_schedule():
    """The workload's lr: base 0.1, milestones (500, 700, 900), linear
    warmup over 200 iterations from ratio 0.1."""
    from lfdtpu_torch.execution import MultiStepLRSchedule, WarmupSetting

    return MultiStepLRSchedule(0.1, (500, 700, 900), 0.1,
                               WarmupSetting(False, "linear", 200, 0.1))


def train_batch(rng, n, hw, nmax):
    """Seeded uint8 frames and GT padded to `nmax` rows: 0 to 30 face boxes
    per image (about 20% of images none, the sampler's neg_ratio 0.2), sides
    log-uniform over the WIDERFACE scales 4..320 px (capped at 0.8 of the
    crop), aspect 0.7..1.3, inside the crop."""
    images = frames(rng, n, hw)
    gt = np.zeros((n, nmax, 4), np.float32)
    labels = np.zeros((n, nmax), np.int32)
    mask = np.zeros((n, nmax), bool)
    top = min(320.0, 0.8 * min(hw))
    for i in range(n):
        k = 0 if rng.rand() < 0.2 else rng.randint(1, 31)
        side = np.exp(rng.uniform(np.log(4.0), np.log(top), k))
        aspect = rng.uniform(0.7, 1.3, k)
        w = np.minimum(side * aspect, hw[1])
        h = np.minimum(side / aspect, hw[0])
        x = rng.uniform(0, 1, k) * (hw[1] - w)
        y = rng.uniform(0, 1, k) * (hw[0] - h)
        gt[i, :k] = np.stack([x, y, w, h], -1)
        mask[i, :k] = True
    return images, gt, labels, mask


def init_weights(seed):
    """WIDERFACE-L's state_dict from lfdtpu's initializers, seeded."""
    import torch

    from lfdtpu_torch import zoo

    det = zoo.widerface_lfd("L")
    det.init(torch.Generator().manual_seed(seed))
    return det.net.state_dict()


def make_trainer(device, hw, weights, mixed_precision=False):
    """A fresh WIDERFACE-L with `weights`, its TrainState on `device` and the
    train step: SGD momentum 0.9, wd 1e-4, clip 10, uint8 frames through the
    workload's device preprocess."""
    from lfdtpu_torch import zoo
    from lfdtpu_torch.deploy import make_device_preprocess
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    det = zoo.widerface_lfd("L")
    det.net.load_state_dict(weights)
    state = create_train_state(det, SGD(momentum=0.9, weight_decay=1e-4), device=device)
    step = make_train_step(det, state.optimizer, hw, clip_max_norm=10.0,
                           preprocess=make_device_preprocess(MEAN, STD),
                           mixed_precision=mixed_precision)
    return det, step


def check_train_gpu_vs_cpu(device):
    """Two fp32 steps at 128x128, batch 2, on the GPU and on the CPU from
    the same weights and batch. The weights have randomized norm affines and Scales (build_detector): a
    parameter that starts at zero would be held to the relative error of
    its update alone."""
    weights = build_detector("cpu", seed=7).net.state_dict()
    batch = train_batch(np.random.RandomState(7), 2, TRAIN_SMALL_HW, TRAIN_NMAX)
    sched = train_schedule()
    runs = {}
    for dev in (device, "cpu"):
        det, step = make_trainer(dev, TRAIN_SMALL_HW, weights)
        metrics = [step(*batch, sched(0, it), True) for it in range(2)]
        runs[dev] = (det.net, metrics)
    (gnet, gm), (cnet, cm) = runs[device], runs["cpu"]
    worst = {}
    for i, (g, c) in enumerate(zip(gm, cm)):
        for k in ("loss", "grad_norm"):
            worst[f"step{i + 1} {k}"] = rel_err(g[k].cpu(), c[k])
    csd = cnet.state_dict()
    for kind in ("param", "running"):
        errs = [rel_err(v.cpu(), csd[k]) for k, v in gnet.state_dict().items()
                if v.is_floating_point() and ("running" in k) == (kind == "running")]
        worst[f"{kind} (worst of {len(errs)})"] = max(errs)
    print(f"train fp32 GPU vs CPU, WIDERFACE-L {TRAIN_SMALL_HW[0]}x{TRAIN_SMALL_HW[1]} "
          "batch 2, 2 steps, "
          "max|err|/max|ref|: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol {TRAIN_TOL}, TF32 off)")
    check(gm[0]["num_pos"].item() > 0, "the small training batch has no positives")
    check(max(worst.values()) < TRAIN_TOL, "GPU train steps disagree with the CPU")


def train_full_width(device, card):
    """WIDERFACE-L at full width on the workload's batch: TRAIN_STEPS steps
    in fp32 and in bf16 on one fixed batch. Returns the bf16-trained
    detector."""
    import torch

    weights = init_weights(11)
    batch = [torch.as_tensor(a, device=device) for a in train_batch(
        np.random.RandomState(11), TRAIN_BATCH, TRAIN_HW, TRAIN_NMAX)]
    n_boxes = int(batch[3].sum())
    sched = train_schedule()
    for name, mp in (("fp32", False), ("bf16", True)):
        det, step = make_trainer(device, TRAIN_HW, weights, mixed_precision=mp)
        stats0 = {k: v.clone() for k, v in det.net.state_dict().items() if "running" in k}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = [step(*batch, sched(0, it), True) for it in range(TRAIN_WARMUP)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for it in range(TRAIN_WARMUP, TRAIN_STEPS):
            metrics.append(step(*batch, sched(0, it), True))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        vals = {k: torch.stack([m[k] for m in metrics]).cpu().numpy() for k in metrics[0]}
        print(f"train {name} WIDERFACE-L batch {TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]} "
              f"({n_boxes} GT boxes, Nmax {TRAIN_NMAX}): {ms:.2f} ms/step, "
              f"{TRAIN_BATCH * 1000.0 / ms:.1f} images/s, peak {peak:.2f} GiB allocated "
              f"[{card}]")
        print(f"  loss {vals['loss'][0]:.4f} -> {vals['loss'][-1]:.4f} over {TRAIN_STEPS} "
              f"steps, grad_norm {vals['grad_norm'][0]:.3f} -> {vals['grad_norm'][-1]:.3f}, "
              f"num_pos {vals['num_pos'][0]:.0f}, lr {sched(0, 0):.5f} -> "
              f"{sched(0, TRAIN_STEPS - 1):.5f}")
        check(all(np.isfinite(v).all() for v in vals.values()),
              f"non-finite train metrics ({name})")
        check(vals["loss"][-1] < vals["loss"][0], f"the {name} loss did not fall")
        check(all(p.dtype == torch.float32 for p in det.net.parameters()),
              f"master weights left fp32 ({name})")
        moved = sum(not torch.equal(v, stats0[k]) for k, v in det.net.state_dict().items()
                    if k in stats0)
        check(moved == len(stats0), f"{len(stats0) - moved} BN running stats did not "
              f"move ({name})")
    return det


def train_to_serve(det, device, counters, classification_threshold=None):
    """The trained net (left in train mode) into the bf16 engine with all
    three kernels, one frame served; then predict_for_single_image on the
    net itself must leave its running stats and its mode alone. Returns the
    engine's rows."""
    import torch

    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    engine = compile_inference(det, SERVE_HW, "bf16", preprocess=make_device_preprocess(
        MEAN, STD), device=device, nms_use_kernel=True, kernel_convs=True,
        kernel_stem=True, classification_threshold=classification_threshold)
    frame = frames(np.random.RandomState(13), 1, (SERVE_HW[0] - 24, SERVE_HW[1] - 8))[0]
    for c in counters:
        c.launches = 0
    rows = det.predict_for_single_image_with_engine(engine, frame)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"trained net served through the bf16 kernel engine {SERVE_HW}: "
          f"{len(rows)} rows; launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the trained net's engine never launched {name}")
    check_rows(det, rows, frame)
    check(det.net.training, "the trained net left train mode")
    before = {k: v.clone() for k, v in det.net.state_dict().items()}
    image = (frame.astype(np.float32) / 255.0 - 0.5) / 0.5
    rows_direct = det.predict_for_single_image(image)
    same = all(torch.equal(v, before[k]) for k, v in det.net.state_dict().items())
    print(f"predict_for_single_image on the net in train mode: {len(rows_direct)} rows, "
          f"state unchanged={same}, still training={det.net.training}")
    check(same and det.net.training, "predict_for_single_image changed the training net")
    return rows


# --------------------------------------------------------------- workload

def build_pack(path, seed=17):
    """A WIDERFACE-like pack: uint8 BGR arrays 1024 wide, 680-1024 high,
    0-30 face boxes of 4-320 px per image (phase 6's draw), every
    PACK_NEG_EVERY-th image a negative (no boxes)."""
    from lfdtpu_torch.data import Dataset, Parser, Sample

    class SyntheticFaces(Parser):
        def get_meta_info(self):
            return None

        def generate_sample(self):
            rng = np.random.RandomState(seed)
            for i in range(PACK_IMAGES):
                h = int(rng.randint(680, 1025))
                s = Sample()
                s["image"] = rng.randint(0, 256, (h, 1024, 3), dtype=np.uint8)
                if i % PACK_NEG_EVERY != PACK_NEG_EVERY - 1:
                    _, gt, _, mask = train_batch(rng, 1, (h, 1024), 30)
                    boxes = gt[0][mask[0]]
                    if len(boxes) == 0:  # train_batch draws 20% empty: keep a face
                        boxes = np.asarray([[100.0, 100.0, 40.0, 48.0]], np.float32)
                    s["bboxes"] = [[int(v) for v in b] for b in np.maximum(boxes, 1)]
                    s["bbox_labels"] = [0] * len(boxes)
                yield s

    Dataset(parser=SyntheticFaces(), save_path=path, verbose=False)


def load_workload_common():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lfdtpu_torch",
                        "workloads", "WIDERFACE_train", "_common.py")
    spec = importlib.util.spec_from_file_location("widerface_common", path)
    common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(common)
    return common, os.path.join(os.path.dirname(path), "WIDERFACE_LFD_L.py")


def workload_config(common, script, pack, device_aug, epochs):
    """config_dict of the port's WIDERFACE_LFD_L script, as the script
    builds it, with the environment overrides of a smoke run."""
    os.environ.update(LFD_DEVICE_AUG=str(int(device_aug)), LFD_EPOCHS=str(epochs),
                      LFD_DATASET_PATH=pack, LFD_DEVICE="cuda")
    cfg = {}
    common.prepare_common_settings(cfg, script)
    common.prepare_model(cfg, "L")
    common.prepare_data_pipeline(cfg)
    common.prepare_optimizer(cfg)
    return cfg


def _record_hook():
    import torch

    from lfdtpu_torch.execution import Hook, Priority

    class Record(Hook):
        """Per iteration: the lr and the step's metrics (device tensors, no
        sync); wall time from the end of the first iteration (after a
        synchronize) to the end of the run (after another)."""

        def __init__(self):
            super().__init__()
            self.priority = Priority.HIGH
            self.lrs, self.metrics, self.t0 = [], [], None

        def after_train_iter(self, executor):
            self.lrs.append(executor.config_dict["current_lr"])
            self.metrics.append(executor.last_metrics)
            if self.t0 is None:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()

        def after_run(self, executor):
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()

        def images_per_s(self, batch):
            return (len(self.lrs) - 1) * batch / (self.t1 - self.t0)

        def values(self, key):
            return torch.stack([m[key] for m in self.metrics]).cpu().numpy()

    return Record()


def run_workload(cfg, card, label):
    from lfdtpu_torch.execution import Executor

    rec = _record_hook()
    cfg["extra_hooks"] = cfg.get("extra_hooks", []) + [rec]
    ex = Executor(cfg)
    ex.run()
    loss = rec.values("loss")
    sched = cfg["lr_schedule"]
    want = [0.1 * (1 - (1 - (i + 1) / 200) * 0.9) for i in range(len(rec.lrs))]
    print(f"workload {label}: {len(rec.lrs)} iterations, loss "
          + " ".join(f"{v:.4f}" for v in loss)
          + f", lr {rec.lrs[0]:.6f} -> {rec.lrs[-1]:.6f}; Executor "
          f"{rec.images_per_s(cfg['batch_size']):.1f} images/s after one warmup "
          f"iteration (wall, synchronized) [{card}]")
    check(np.isfinite(loss).all() and np.isfinite(rec.values("grad_norm")).all(),
          f"non-finite losses ({label})")
    check(loss[-1] <= LOSS_BLOWUP * loss[0], f"the loss blew up ({label})")
    check(np.allclose(rec.lrs, want, rtol=1e-12, atol=0)
          and rec.lrs == [sched(0, i) for i in range(len(rec.lrs))],
          f"the lr does not follow the warmup ({label})")
    return ex, rec


def busy_share(prof):
    """Union of the device's kernel and copy intervals over the profiled
    window (first to last traced event): each device interval counted once,
    whatever the ops above it."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA)
    if not dev:
        return None
    busy, cur_s, cur_e = 0.0, dev[0][0], dev[0][1]
    for st, en in dev[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    return busy / (hi - lo)


class _Repeat:
    """The pack `k` times over (indexes i -> i mod n), for a loader run of
    many batches per worker."""

    def __init__(self, dataset, k):
        self._ds, self._n = dataset, len(dataset)
        self._k = k

    def __getitem__(self, i):
        return self._ds[i % self._n]

    def __len__(self):
        return self._n * self._k

    def get_indexes(self):
        return list(range(len(self)))


def loader_alone(cfg, card, label):
    """The config's loader setup over the pack repeated until it gives
    LOADER_BATCHES_PER_WORKER batches per worker thread: every image over
    the wall time from the start of the iteration (the workers start there)
    to the last batch."""
    from lfdtpu_torch.data import DataLoader, RandomWithNegDatasetSampler

    src = cfg["train_data_loader"]
    workers = src._num_workers
    k = 0
    sampler = []
    while len(sampler) < LOADER_BATCHES_PER_WORKER * workers:
        k += 1
        ds = _Repeat(src._dataset, k)
        sampler = RandomWithNegDatasetSampler(ds, batch_size=cfg["batch_size"],
                                              neg_ratio=0.2, seed=3)
    loader = DataLoader(ds, sampler, src._region_sampler, src._augmentation_pipeline,
                        num_workers=workers, max_boxes_per_image=src._max_boxes,
                        image_dtype=src._image_dtype)
    n = 0
    t0 = time.perf_counter()
    for batch in loader:
        n += len(batch["images"])
    seconds = time.perf_counter() - t0
    print(f"loader alone, {label}: {n / seconds:.1f} images/s ({n} images in "
          f"{len(loader)} batches of {cfg['batch_size']}, {seconds:.2f} s from the start "
          f"of the iteration to the last batch), {workers} worker threads, "
          f"os.cpu_count() {os.cpu_count()} [{card}]")
    return batch


def check_aug_gpu_vs_cpu(aug, batch, device, card):
    """The config's DeviceAugment on one loader batch: GPU against CPU
    (pixel units: the normalize divides by 127.5), and its ms per batch."""
    import torch

    host = {"buffer": batch["images"], "scale": batch["aug_scale"],
            "translation": batch["aug_translation"], "flip": batch["aug_flip"]}
    cpu = {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in host.items()}
    gpu = {k: v.to(device) for k, v in cpu.items()}
    aug_gpu = copy.deepcopy(aug).to(device)
    got = aug_gpu(gpu)
    ref = aug(cpu)
    err = float((got.cpu() - ref).abs().max()) * 127.5
    ms = time_ms(lambda: aug_gpu(gpu), iters=10, warmup=2)
    print(f"device aug {tuple(batch['images'].shape)} -> {tuple(got.shape)}: GPU vs CPU "
          f"max|err| {err:.3e} pixel units (tol {AUG_TOL}); {ms:.3f} ms per batch [{card}]")
    check(err <= AUG_TOL, "device aug on the GPU disagrees with the CPU")


def h2d_ms(batch, keys, device):
    """ms to copy one batch's arrays from pinned host memory to the device
    (CUDA events), and the host ms of prefetch_to_device's copy into pinned
    memory (host clock, mean of 5 after 1)."""
    import torch

    host = [torch.from_numpy(np.ascontiguousarray(batch[k])) for k in keys]
    pinned = [t.pin_memory() for t in host]
    t0 = time.perf_counter()
    for _ in range(5):
        [t.pin_memory() for t in host]
    pin_ms = (time.perf_counter() - t0) * 1e3 / 5
    nbytes = sum(t.numel() * t.element_size() for t in pinned)
    ms = time_ms(lambda: [t.to(device, non_blocking=True) for t in pinned],
                 iters=10, warmup=2)
    return ms, nbytes, pin_ms


def workload_phase(device, card, counters):
    """Phase 8: the WIDERFACE training entry point, end to end."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.data import AUG_KEYS
    from lfdtpu_torch.execution import ProfilerHook
    from lfdtpu_torch.parallel import BATCH_KEYS

    common, script = load_workload_common()
    for c in counters:
        c.launches = 0
    tmp = tempfile.mkdtemp(prefix="lfd_workload_")
    cwd, hook, env = os.getcwd(), sys.excepthook, dict(os.environ)
    try:
        os.chdir(tmp)  # the scripts' work dirs go under the temp dir
        pack = os.path.join(tmp, "widerface_synthetic.pkl")
        t0 = time.time()
        build_pack(pack)
        print(f"pack: {PACK_IMAGES} images in {time.time() - t0:.1f} s "
              f"({os.path.getsize(pack) / 2 ** 20:.0f} MiB)")

        cfg = workload_config(common, script, pack, device_aug=True, epochs=2)
        ex, rec = run_workload(cfg, card, "device aug, 2 epochs")
        work = cfg["work_dir"]
        ckpts = sorted(f for f in os.listdir(work) if f.endswith(".pth"))
        print(f"checkpoints: {ckpts}")
        check(ckpts == ["epoch_1.pth"], "the workload wrote no epoch_1.pth")
        ckpt_path = os.path.join(work, "epoch_1.pth")
        saved = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        aug_batch = loader_alone(cfg, card, "device aug")
        del ex

        cfg2 = workload_config(common, script, pack, device_aug=True, epochs=2)
        cfg2["resume_path"] = ckpt_path
        prof = ProfilerHook(os.path.join(tmp, "trace"), start_iter=4, num_iters=2)
        cfg2["extra_hooks"] = [prof]
        from lfdtpu_torch.execution import Executor

        resumed = Executor(cfg2)
        same = all(torch.equal(v.cpu(), saved["state_dict"][k])
                   for k, v in resumed.state.net.state_dict().items())
        counters_ok = (cfg2["epoch"], cfg2["train_iter"]) == (1, 3)
        print(f"resumed from epoch_1.pth: epoch {cfg2['epoch']}, train_iter "
              f"{cfg2['train_iter']}, params and BN stats equal the saved ones: {same}")
        check(same and counters_ok, "resume did not restore the checkpoint exactly")
        resumed.run()
        check(cfg2["train_iter"] == 6, "the resumed run did not train one more epoch")
        share = busy_share(prof.profile)
        print("device-busy share over train iterations 5-6, whose batches were "
              "already prefetched (torch.profiler, union of device intervals): "
              + ("not measured (no device events)" if share is None else f"{share:.3f}")
              + f" [{card}]")
        final = os.path.join(work, "final.pth")
        resumed.save(final)
        del resumed

        host_cfg = workload_config(common, script, pack, device_aug=False, epochs=2)
        host_ex, _ = run_workload(host_cfg, card, "host aug, 2 epochs")
        del host_ex
        host_batch = loader_alone(host_cfg, card, "host aug")

        check_aug_gpu_vs_cpu(cfg["device_augment"], aug_batch, device, card)
        for label, batch, keys in (("device aug", aug_batch, BATCH_KEYS + AUG_KEYS),
                                   ("host aug", host_batch, BATCH_KEYS)):
            ms, nbytes, pin_ms = h2d_ms(batch, keys, device)
            print(f"H2D {label}: {ms:.3f} ms per batch ({nbytes / 2 ** 20:.1f} MiB, "
                  f"pinned, {nbytes / ms / 1e6:.1f} GB/s); the host copy into pinned "
                  f"memory before it {pin_ms:.3f} ms [{card}]")

        print("hand-written kernel launches during training (its path runs none): "
              f"{ {c.__name__: c.launches for c in counters} }")
        det = zoo.widerface_lfd("L")
        det.net.load_state_dict(torch.load(final, map_location="cpu",
                                           weights_only=True)["state_dict"])
        det.net.to(device)
        # nine steps on noise leave every score under the detector's 0.05:
        # a lower threshold makes the engine emit rows to check
        rows = train_to_serve(det, device, counters, classification_threshold=SERVE_THRESHOLD)
        check(len(rows) > 0, "the trained checkpoint's engine returned no rows")
    finally:
        os.chdir(cwd)
        sys.excepthook = hook
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- timings

def _timing(name, shape, card, ms, cold, plain_ms, library_ms, residual=False, note="",
            library_call=None):
    """One kernel timing: printed beside its bound, and returned as the
    fields of the kernels line (the warm time is the one the line carries:
    in the engine a kernel reads what the previous launch just wrote)."""
    bound, by = kernel_bound_ms(name, shape, residual)
    pct = 100.0 * bound / ms
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms ({library_call})"
    print(f"kernel {name} {shape}{' +residual' if residual else ''}: {ms:.4f} ms warm, "
          f"{cold:.4f} ms cold; bound {bound:.4f} ms ({by}), {pct:.1f}% of it (warm); "
          f"plain {plain_ms:.4f} ms; library {lib}{note} [{card}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                pct_of_bound=pct, library_ms=library_ms, library_call=library_call)


def k3_library_ms(y, x, wk, s, b, w_cd, b_cd, shape, k3_ms, card):
    """K3's yardsticks at one shape, each a CUDA-graph time of cuDNN in bf16
    on channels_last with the BN folded into the weights: the bare conv2d
    (less work than K3: no bias, residual or ReLU), conv2d with the bias,
    that followed by the residual add and ReLU, and the fused call that
    computes K3's own function, cudnn_convolution_add_relu with the residual
    or cudnn_convolution_relu without. The fused call is the library call
    when cuDNN runs it and it agrees with K3's plain version; else the bare
    conv2d is. Returns (library ms, which call)."""
    import torch
    import torch.nn.functional as F

    from lfdtpu_torch.ops import conv_kernels as ck

    y_cl = y.permute(0, 3, 1, 2)
    x_cl = None if x is None else x.permute(0, 3, 1, 2)
    one = [1, 1]
    bare = graph_ms([lambda: F.conv2d(y_cl, w_cd, None, padding=1)])
    biased = graph_ms([lambda: F.conv2d(y_cl, w_cd, b_cd, padding=1)])
    times = [f"bare conv2d {bare:.4f}", f"conv2d + bias {biased:.4f}"]
    if x is not None:
        chain = graph_ms([lambda: torch.relu(F.conv2d(y_cl, w_cd, b_cd, padding=1) + x_cl)])
        times.append(f"+ residual add and ReLU unfused {chain:.4f}")
    name = "cudnn_convolution_relu" if x is None else "cudnn_convolution_add_relu"

    def fused_call():
        if x is None:
            return torch.cudnn_convolution_relu(y_cl, w_cd, b_cd, one, one, one, 1)
        return torch.cudnn_convolution_add_relu(y_cl, w_cd, x_cl, 1.0, b_cd, one, one, one, 1)

    # a yardstick the card may refuse: try it eagerly before timing it
    try:
        got = fused_call().permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        err = rel_err(got, ck.pair_conv3x3_plain(y, wk, s, b, residual=x))
        refusal = None if err < K3_TOL else f"{err:.3e} from K3's plain version"
    except RuntimeError as e:
        refusal = f"refused: {str(e).splitlines()[0][:120]}"
    if refusal is None:
        fused = graph_ms([fused_call])
        times.append(f"{name} (fused) {fused:.4f}")
        lib = (fused, f"cuDNN {name}, BN folded")
    else:
        times.append(f"{name} (fused) not timed, {refusal}")
        lib = (bare, "cuDNN bf16 conv2d alone, BN folded into the weights")
    print(f"  library calls pair_conv3x3 {shape}{' +residual' if x is not None else ''}, "
          f"ms: " + "; ".join(times) + f"; K3 {k3_ms:.4f} is "
          f"{'no slower than' if k3_ms <= bare else 'SLOWER than'} the bare conv2d [{card}]")
    return lib


def time_kernels(device, card, k2_in, k3_in):
    """Each kernel's device ms at the engine's shapes, warm (the same inputs
    every launch) and cold (rotating over more than COLD_BYTES); the plain
    versions eager (CUDA events, warmup excluded; K1's syncs on the host);
    K3's cuDNN yardsticks (k3_library_ms). Returns {kernel: fields of the
    kernels line} for the main shapes."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck
    from lfdtpu_torch.ops import nms_kernel

    g = torch.Generator(device=device).manual_seed(3)
    out = {}

    _, wk, s, b = k3_in
    w_cd = (wk.float() * s).bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b_cd = b.bfloat16()
    first = True
    for (hh, ww), residual in ((k3_shapes()[0], True), (k3_shapes()[0], False),
                               (k3_shapes()[1], True), (k3_shapes()[2], True)):
        shape = (1, hh, ww)
        sets = COLD_BYTES // kernel_work("pair_conv3x3", shape, residual)[0] + 2
        ys = [torch.randn(1, hh, ww, 64, generator=g, device=device).bfloat16()
              for _ in range(sets)]
        xs = [torch.randn(1, hh, ww, 64, generator=g, device=device).bfloat16()
              if residual else None for _ in range(sets)]
        warm = graph_ms([lambda: ck.pair_conv3x3(ys[0], wk, s, b, residual=xs[0])])
        cold = graph_ms([lambda i=i: ck.pair_conv3x3(ys[i], wk, s, b, residual=xs[i])
                         for i in range(sets)])
        plain = time_ms(lambda: ck.pair_conv3x3_plain(ys[0], wk, s, b, residual=xs[0]))
        lib_ms, call = k3_library_ms(ys[0], xs[0], wk, s, b, w_cd, b_cd, shape, warm, card)
        row = _timing("pair_conv3x3", shape, card, warm, cold, plain, lib_ms, residual,
                      library_call=call)
        if first:
            out["pair_conv3x3"] = row
            first = False
        del ys, xs

    frame, w2, mean, std, s2, b2 = k2_in
    sets = COLD_BYTES // kernel_work("stem_conv", tuple(frame.shape[:3]))[0] + 2
    frames_ = [frame] + [torch.randint(0, 256, tuple(frame.shape), generator=g,
                                       device=device, dtype=torch.uint8)
                         for _ in range(sets - 1)]
    warm = graph_ms([lambda: ck.stem_conv(frame, w2, mean, std, s2, b2)])
    cold = graph_ms([lambda f=f: ck.stem_conv(f, w2, mean, std, s2, b2) for f in frames_])
    plain = time_ms(lambda: ck.stem_conv_plain(frame, w2, mean, std, s2, b2))
    print("stem_conv library call: none (no single PyTorch call does the uint8 "
          "normalize, conv, BN and ReLU)")
    out["stem_conv"] = _timing("stem_conv", tuple(frame.shape[:3]), card, warm, cold,
                               plain, None)

    boxes = torch.rand(1, 1000, 4, generator=g, device=device) * 500
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 1000, dtype=torch.bool, device=device)
    out["nms_mask_sorted"] = time_k1(boxes, valid, g, card)
    return out


def time_k1(boxes, valid, g, card):
    """K1 at the engine's B=1, K=1000, thr 0.4 on the random boxes (rand*500)
    that earlier runs timed, then on the walk's hard cases
    (nms_kernel.walk_cases) and at B=4, each with its kept count. Returns the
    fields of the kernels line."""
    import torch

    from lfdtpu_torch.ops import nms_kernel

    device = boxes.device
    b4 = torch.rand(4, 1000, 4, generator=g, device=device) * 500
    b4[..., 2:] += b4[..., :2]
    inputs = {"random boxes (rand*500)": (boxes, valid),
              "random boxes (rand*500), B=4": (b4, torch.ones(4, 1000, dtype=torch.bool,
                                                                device=device))}
    for name, (b, v) in nms_kernel.walk_cases(1, 1000).items():
        inputs[name] = (b.to(device), v.to(device))
    case_ms = {}
    for name, (b, v) in inputs.items():
        kept = int(nms_kernel.nms_mask_sorted(b, v, 0.4).sum())
        case_ms[name] = graph_ms([lambda b=b, v=v: nms_kernel.nms_mask_sorted(b, v, 0.4)])
        print(f"K1 {name} K=1000: {case_ms[name]:.4f} ms, kept {kept}/{v.numel()} [{card}]")
    print(f"K1 all kept / all suppressed: "
          f"{case_ms['all kept'] / case_ms['all suppressed']:.2f}x")
    warm = case_ms["random boxes (rand*500)"]
    plain = time_ms(lambda: nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.4))
    print("nms_mask_sorted library call: none (torchvision's nms is not on the "
          "card's machine, and the port may not need it)")
    return _timing("nms_mask_sorted", (1, 1000), card, warm, warm, plain, None,
                   note=" (inputs of 17 KB: warm = cold)")


def profile_engine(engine, x, vhw, card, counters):
    """One frame of the bf16_kernels engine launches each kernel as the
    engine's levels say; then torch.profiler over PROFILED_FRAMES frames:
    each kernel's device ms per frame and the device's busiest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for c in counters:
        c.launches = 0
    engine(x, vhw)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"one frame of the bf16_kernels engine: launches {launches}")
    check(launches == ENGINE_LAUNCHES, f"one frame should launch {ENGINE_LAUNCHES}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_FRAMES):
            engine(x, vhw)
        torch.cuda.synchronize()
    by_name, calls = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            calls[e.name] = calls.get(e.name, 0) + 1
    per_frame = {}
    for kernel, keys in (("pair_conv3x3", ("pair_conv_kernel",)),
                         ("stem_conv", ("stem_conv_kernel",)),
                         ("nms_mask_sorted", ("nms_iou_kernel", "nms_walk_kernel"))):
        names = [n for n in by_name if any(k in n for k in keys)]
        per_frame[kernel] = (sum(by_name[n] for n in names) / PROFILED_FRAMES,
                             sum(calls[n] for n in names) / PROFILED_FRAMES)
    share = busy_share(prof)
    total = sum(by_name.values()) / PROFILED_FRAMES
    print(f"profile, {PROFILED_FRAMES} frames of the bf16_kernels engine {HW[0]}x{HW[1]}: "
          "device ms per frame " + ", ".join(
              f"{k} {ms:.4f} ({n:.0f} launches)" for k, (ms, n) in per_frame.items())
          + f"; all device work {total:.3f} ms per frame, busy share "
          + ("not measured" if share is None else f"{share:.3f}") + f" [{card}]")
    k1_names = {n: NMS_KERNEL_NAME.search(n).group(0) for n in by_name if "nms_" in n}
    print("  K1's kernels, ms per frame: " + ", ".join(
        f"{label} {by_name[n] / PROFILED_FRAMES:.4f}" for n, label in k1_names.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / PROFILED_FRAMES:8.4f} ms/frame  {calls[name] / PROFILED_FRAMES:5.1f}x  "
              f"{name[:110]}")
    check(all(n > 0 for _, n in per_frame.values()), "the profile lost a kernel")


# ------------------------------------------------------------------ main

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from lfdtpu_torch.ops import conv_kernels, kernel_lib, nms_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    t_start = time.time()

    card = card_line()
    print(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | TF32 off")

    t0 = time.time()
    lib_path = kernel_lib.build()
    kernel_lib.library()
    print(f"[2 build] {lib_path.relative_to(kernel_lib.BUILD_DIR.parents[1])} "
          f"in {time.time() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    print("[3 K1]")
    err1 = check_k1(device)
    print("[4 K2 K3]")
    errs, k2_in, k3_in = check_k2_k3(device)

    print("[5 engine]")
    det = build_detector(device)
    engines = compile_engines(det, HW, device)
    rng = np.random.RandomState(5)
    counters = (nms_kernel.nms_mask_sorted, conv_kernels.stem_conv,
                conv_kernels.pair_conv3x3)
    for c in counters:
        c.launches = 0
    rows_single, rows_batch = serve(det, engines, HW, rng)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"served 8 single frames ({sum(map(len, rows_single))} rows) and a batch "
          f"of 4 ({[len(r) for r in rows_batch]} rows); launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    imgs = check_engine_parity(det, engines, HW, rng)
    check_fp32_reference(det, device, rng)

    print("[6 train]")
    t0 = time.time()
    check_train_gpu_vs_cpu(device)
    for c in counters:
        c.launches = 0
    trained = train_full_width(device, card)
    torch.cuda.synchronize()
    print("hand-written kernel launches during training (its path runs none): "
          f"{ {c.__name__: c.launches for c in counters} }")
    train_to_serve(trained, device, counters)
    del trained
    torch.cuda.empty_cache()
    print(f"train phase {time.time() - t0:.1f} s")

    print(f"[7 timings] {card}")
    x = torch.as_tensor(imgs, device=device)
    vhw = torch.tensor([HW[0] - 8, HW[1]], dtype=torch.float32, device=device)
    # the eager engines are partly host bound, so their times move between
    # runs: each is timed twice, in the order A B C C B A, after a long warmup
    order = ("bf16_kernels", "bf16_plain", "fp32")
    engine_ms = {name: [] for name in order}
    for name in order + order[::-1]:
        engine_ms[name].append(time_ms(lambda e=engines[name]: e(x, vhw),
                                       iters=30, warmup=10))
    for name in order:
        runs = ", ".join(f"{t:.3f}" for t in engine_ms[name])
        print(f"engine {name} {HW[0]}x{HW[1]} batch 1: {runs} ms/frame [{card}]")
    timings = time_kernels(device, card, k2_in, k3_in)
    profile_engine(engines["bf16_kernels"], x, vhw, card, counters)
    sources = {
        "nms_mask_sorted": ("lfdtpu_torch/csrc/nms.cu", "lfdtpu/ops/nms_pallas.py:49", err1),
        "stem_conv": ("lfdtpu_torch/csrc/stem_conv.cu", "lfdtpu/ops/conv_pallas.py:359",
                      errs["stem_conv"]),
        "pair_conv3x3": ("lfdtpu_torch/csrc/pair_conv.cu", "lfdtpu/ops/conv_pallas.py:171",
                         errs["pair_conv3x3"]),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=tpu,
                    launches=launches[name], max_abs_err=err, **timings[name])
               for name, (src, tpu, err) in sources.items()]
    print(f"[8 workload] {card}")
    t0 = time.time()
    workload_phase(device, card, counters)
    print(f"workload phase {time.time() - t0:.1f} s")

    print(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
