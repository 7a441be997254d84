#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lfdtpu_torch) on one NVIDIA GPU.

Drives the port's paths at full width: the WIDERFACE-L inference engine
(random seeded weights with randomized BatchNorm statistics and affines and
head Scales, so the BN folding is exercised), captured into a CUDA graph as
a user gets it on the card, the WIDERFACE-L training step, the training
entry point with its val loop, and the evaluation script; then the TT100K
and TrafficLight workloads (serving, training entry points, evaluation) and
the LFDv2 family. It checks them:

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
  5. engine   engines at 1088x1920 (1080p padded to the stride-64
              multiple), built as a user builds them: on the card
              compile_inference returns a CAPTURED engine, one CUDA graph of
              net + decode + NMS that a call replays. Five of them (fp32,
              bf16 with lfdtpu's default switches, bf16 with K1-K3 at batch
              1 and 4, bf16 with the plain NMS); then 8 single frames
              through predict_for_single_image_with_engine and one batch of
              4 with different valid extents through
              predict_for_batch_with_engine, with all three kernels on. The
              kernels' launch counters (zeroed before the engines are
              built) tick in the warmup calls and during the capture, where
              the wrappers launch them; the 9 replays' launches are counted
              from a torch.profiler trace by kernel name and must be 9 x
              K1/K2/K3 = 1/1/10. Then: dense outputs of the kernel engine
              against the plain bf16 engine and both against fp32; decode + NMS on the same dense
              outputs, K1 against plain, rows identical; the fp32 engine on the
              GPU against the fp32 port on the CPU at 256x256, TF32 off;
              every captured engine (WIDERFACE-L: fp32, bf16, bf16 with
              K1-K3 at batch 1 and 4, bf16 with the plain NMS at batch 1;
              WIDERFACE-S: fp32 and bf16) against an EAGER engine of the
              same build (captured=False) on two different frames in a row:
              every output bit-equal, the first result unchanged by the
              second call, the two results different, and the launches each
              capture recorded;
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
  7. timings  CUDA events, warmup excluded: ms/frame of the eager and the
              captured engine of fp32, bf16 and bf16 with K1-K3, in A B B A
              order within the run, on a frame already on the card and from
              a numpy frame (the copy from host memory included), and at
              batch 4; the predict entry point around both (host clock);
              each
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
              and K3 10 times (the wrappers' counters for the eager engine,
              the capture's record and the profiled replays for the
              captured one); torch.profiler over 5 frames of each gives
              each kernel's device ms per frame and the device-busy share,
              eager against captured; then the latency sweep that the
              WIDERFACE timing_inference_latency.py script runs
              (inference_latency_evaluation: one captured engine per cell,
              each call timed by CUDA events and waited for) for
              WIDERFACE-L and -XS in bf16 at 640x480, 1280x720, 1920x1080
              and 3840x2160, 30 timed calls a cell (the script's 50); all
              beside the card's name and power limit;
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
              kernel launches). The first of these runs also validates: a
              val loader over the pack's first 24 images (whole images,
              batch 8), val_interval 1 and a COCOEvaluator over their boxes
              (one result list per val image, finite metrics, the net's
              weights, BN statistics and train mode untouched by the val
              pass); and the port's evaluation.py script runs its SIO
              evaluation on the final checkpoint over 6 JPEGs written from
              the pack into event folders (one txt per image, in the
              WIDERFACE format). Printed beside the card: loader-alone
              images/s of both paths (4 batches per worker thread with
              device augmentation, 2 with host augmentation, every
              image over the time from the workers' start to the last
              batch), Executor images/s after one warmup
              iteration (wall time ending in a synchronize), device-aug and
              H2D ms per batch (CUDA events) and the device-busy share of the
              two profiled iterations, whose batches were already prefetched.
  9. traffic  TT100K-L at 2048x2048 (45-class softmax head; batch 1 and 4)
     serve    and TL-L / TL-S at 768x1280 (720p padded; one class,
              class-agnostic, BGR -> RGB and the imagenet normalize), each
              with its classifier's output conv drawn at std 0.2 so the
              softmax is not near uniform. Each model's main path: counters
              zeroed, the captured engine with every kernel its net takes
              built (TL-S's 48-channel stem does not fit K2: its
              kernel_stem=True engine must raise, it serves K1 and K3),
              frames served through the predict entry points, the replays
              counted from a profile; launches against expected_launches,
              counted from the net (no hard-coded count). Then K2 with the
              engine's folded constants against its plain version; dense
              bf16 kernel outputs against the plain bf16 engine; decode +
              NMS with K1 (45 class offsets for TT100K) against the plain
              NMS, rows identical; the fp32 engine against the CPU at
              256x256; fp32, bf16 and the kernel variant captured against
              eager twins, bit-equal, and their ms per call; a 3-frame
              profile. Then K3 against its plain version at TT100K's
              levels (512x512, 256x256, 128x128, batch 1 and 4) and K2 at
              2048x2048; K3 timed at 512x512 with and without the residual
              and 256x256 with it (bound, plain, cuDNN), K2 at 2048x2048
              and with TL-L's folded constants at 768x1280;
 10. traffic  the TT100K_LFD_L and TL_LFD_L configs (their _common, as the
     train    scripts build them) trained end to end: 2 epochs with device
              augmentation, a resume from epoch_1.pth (exact), 2 epochs
              with host augmentation; losses finite, lr on the warmup. The
              packs are made by the port's own scripts from seeded files
              written here. TT100K: 100 2048x2048 JPEGs with 1-8 signs of
              8-200 px over the 45 classes, 8 without one, and the margins
              that generate_neg_images.py cuts (min_size_threshold 512),
              packed by pack_tt100k.py through TT100KParser: 2 iterations
              per epoch at batch 64 (cut: the dataset, 2 epochs). TL: 20
              720x1280 JPEGs, 16 with 1-6 lights of 8-80 px, and one of 24
              px height that pack_TL.py drops (COCOParser, filter_min_size
              32): 4 iterations per epoch at batch 4 (cut: the dataset, 2
              epochs). Each final checkpoint served through the captured
              kernel engine at 768x1280 and scored by the task's
              evaluation.py (TT100K: 4 images, minscore 0; TL: every image,
              COCOEvaluator); the TT100K-L train step at batch 64, crop 512,
              Nmax 100 in fp32 and bf16 (ms/step, images/s, peak memory)
              and the target assignment alone;
 11. LFDv2    LFDv2 on WIDERFACE-L's backbone, neck and head at 1088x1920:
              its main path (counters zeroed, the captured bf16 engine with
              K1-K3 built, two frames served, replays counted), the
              candidates K1's wrapper receives (at most nms_budget), the
              captured engine against an eager twin; two fp32 train steps of
              LFDv2 and of LFDv2Q on the GPU against the CPU (TRAIN_TOL).

The second-to-last line is a JSON object {"kernels": [...]} (each kernel's
launches on the WIDERFACE-L main path, and on every path in
launches_by_path; K2's and K3's times at the new shapes in other_shapes);
the last line is {"ok": true, "device": {...}}. Any failed check exits non-zero. Needs a
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
# the hand-written kernels' names in a profile, per wrapper (K1 launches two)
KERNEL_NAMES = {"pair_conv3x3": ("pair_conv_kernel",), "stem_conv": ("stem_conv_kernel",),
                "nms_mask_sorted": ("nms_iou_kernel", "nms_walk_kernel")}
# engine variants: compile_inference's switches (lfdtpu's defaults: K1 on, K2
# and K3 off); expected_launches counts what one capture of a net launches
VARIANTS = {
    "fp32": dict(precision="fp32"),
    "bf16": dict(precision="bf16"),
    "bf16_kernels": dict(precision="bf16", kernel_convs=True, kernel_stem=True),
    "bf16_plain": dict(precision="bf16", nms_use_kernel=False),
    # a net whose stem K2 does not take (TL-S: 48 channels) serves K1 and K3
    "bf16_k1_k3": dict(precision="bf16", kernel_convs=True),
}
SWEEP_LOOPS = 30            # timed calls per cell of the latency sweep (the script's: 50)
VAL_IMAGES, VAL_BATCH = 24, 8  # the val loader: the pack's first images
SIO_IMAGES = 6              # JPEGs written from the pack for the SIO evaluation
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
LOADER_BATCHES_PER_WORKER = {"device aug": 4, "host aug": 2}  # loader-alone run length
SERVE_THRESHOLD = 1e-4      # the workload checkpoint's engine, see workload_phase
# the traffic workloads (phases 9 and 10)
TT_HW = (2048, 2048)        # a TT100K frame, a multiple of every stride
TL_HW = (768, 1280)         # 720p padded to the stride-64 multiple
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
CLS_STD = 0.2               # the traffic classifiers' output conv, see build_detector
TRAFFIC = {  # zoo name: (frame, the workload's normalize and BGR -> RGB, engine switches,
    #                     batches)
    "TT100K-L": (TT_HW, (MEAN, STD, False), dict(), (1, 4)),
    "TL-L": (TL_HW, (*IMAGENET, True), dict(class_agnostic=True), (1,)),
    "TL-S": (TL_HW, (*IMAGENET, True), dict(class_agnostic=True), (1,)),
}
SERVED_FRAMES = 3           # frames each traffic main path serves
TT_PACK_POS, TT_PACK_BARE = 100, 8  # 2 iterations of 58 positives (+ 6 negatives) at batch 64
TL_PACK_IMAGES = 20         # 16 with lights: 4 iterations at batch 4
EVAL_IMAGES = 4             # TT100K images scored by evaluation.py
TRAIN_SERVE_HW = (768, 1280)  # the trained traffic nets' engines
TT_TRAIN_HW, TT_TRAIN_NMAX = (512, 512), 100  # the TT100K workload's crop and GT rows


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

def build_detector(device, seed=0, size="L", name=None, cls_std=None):
    """WIDERFACE-L (or `size`, or the zoo's `name`) at full width, seeded
    init, randomized norms and Scales; with `cls_std`, the classifier's
    output conv drawn at that std (a 45-class softmax of the init's N(0,
    0.01) head is near uniform on any frame: every score a near tie)."""
    import torch
    from torch import nn

    from lfdtpu_torch import zoo
    from lfdtpu_torch.models.layers import Scale

    det = zoo.ZOO[name]() if name else zoo.widerface_lfd(size)
    g = torch.Generator().manual_seed(seed)
    det.init(g)
    with torch.no_grad():
        if cls_std is not None:
            det.net._head.head0_classification_path[-1].weight.normal_(0.0, cls_std,
                                                                       generator=g)
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


def expected_launches(det, switches):
    """K1/K2/K3 launches of one captured frame of an engine of `det` with
    compile_inference's `switches`, counted from the net: K1 once unless
    the NMS kernel is off, K2 once with the stem kernel, K3 twice for each
    FasterBlock that deploy/kernel_net.py::eligible_faster_block routes
    (bf16 kernel_convs engines). A batch launches each as often as a frame."""
    from lfdtpu_torch.deploy.kernel_net import eligible_faster_block

    blocks = sum(map(eligible_faster_block, det.net.modules()))
    convs = switches.get("kernel_convs", False) and switches.get("precision") == "bf16"
    return {"nms_mask_sorted": int(switches.get("nms_use_kernel", True)),
            "stem_conv": int(switches.get("kernel_stem", False)),
            "pair_conv3x3": 2 * blocks if convs else 0}


def kernel_variant(det):
    """The bf16 variant with every kernel `det`'s net takes: K2 only where
    deploy/kernel_net.py::eligible_stem holds (TL-S's stem is 48 wide: its
    engines run K1 and K3)."""
    from lfdtpu_torch.deploy.kernel_net import eligible_stem

    return "bf16_kernels" if eligible_stem(det.net) else "bf16_k1_k3"


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

def compile_engine(det, hw, device, variant, batch_size=1, captured=None, preprocess=None,
                   **kw):
    """One engine of VARIANTS: captured (the default on the card) or eager;
    WIDERFACE's device preprocess unless another is given."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    return compile_inference(det, hw, preprocess=preprocess or make_device_preprocess(MEAN, STD),
                             batch_size=batch_size, device=device, captured=captured,
                             **VARIANTS[variant], **kw)


def compile_engines(det, hw, device):
    """The captured engines the later phases serve, check and time."""
    engines = {name: compile_engine(det, hw, device, name)
               for name in ("fp32", "bf16", "bf16_kernels", "bf16_plain")}
    engines["bf16_kernels_b4"] = compile_engine(det, hw, device, "bf16_kernels", batch_size=4)
    for name, engine in engines.items():
        check(engine.captured, f"compile_inference returned an eager {name} engine on the card")
    return engines


PROFILE_MARK = "lfd_counted_window"
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel: the device-side bracket
SPIN_CYCLES = 1000


def profiled(warm, work):
    """torch.profiler over `work()`, which ends synchronized. The trace has
    been seen to miss a kernel launched right after it starts (one K2 launch
    of five, on the eager and on the captured engine), so `warm()` runs
    first inside the trace and the device drains. Then `work()` runs inside
    a record_function range named PROFILE_MARK, bracketed on the device by
    two torch.cuda._sleep kernels: device_events returns what started
    between them, on the device's own clock (the host's range start has
    been seen to fall after the first kernels of a replay that began at
    once, so a window on the host's clock lost them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm()
        torch.cuda.synchronize()
        time.sleep(0.005)
        with record_function(PROFILE_MARK):
            torch.cuda._sleep(SPIN_CYCLES)
            out = work()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
    return prof, out


def device_events(prof):
    """(device events in the counted window, the window (start, end), what
    the window is). A trace from profiled (one PROFILE_MARK range): what
    started between its two spin kernels, on the device's own clock; a
    trace without the spin pair fails. A trace without the mark (the
    Executor's profiler hook): every device event and the whole trace."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    spins = sorted((e.time_range.start, e.time_range.end) for e in cuda
                   if SPIN_KERNEL in e.name)
    if any(e.name == PROFILE_MARK and e.device_type == DeviceType.CPU for e in events):
        check(len(spins) == 2, f"a profiled trace holds {len(spins)} {SPIN_KERNEL} events, "
              "not the 2 that bracket its window on the device")
        lo, hi = spins[0][1], spins[1][0]
        what = f"window: device clock between the spin kernels, {(hi - lo) / 1e3:.3f} ms"
    else:
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
        what = f"window: the whole trace, {(hi - lo) / 1e3:.3f} ms"
    # (the range itself also shows up as a device-side annotation: not work)
    dev = [e for e in cuda if e.name != PROFILE_MARK and SPIN_KERNEL not in e.name
           and lo <= e.time_range.start <= hi]
    return dev, (lo, hi), what


def kernel_launches_in(prof):
    """({wrapper name: launches}, the window it was counted in) from a
    profile's device events by kernel name: what a CUDA graph's replays
    launch, which the wrappers' host counters do not see (K1's two kernels
    count as one launch)."""
    counts = {name: 0 for name in KERNEL_NAMES}
    events, _, what = device_events(prof)
    for e in events:
        for name, keys in KERNEL_NAMES.items():
            if keys[0] in e.name:
                counts[name] += 1
    return counts, what


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
        check(((arr[:, 0] >= 0) & (arr[:, 0] < det.num_classes)
               & (arr[:, 0] == np.round(arr[:, 0]))).all(), "label outside the classes")
        check(((arr[:, 1] > 0) & (arr[:, 1] <= 1)).all(), "score outside (0, 1]")
        x2 = arr[:, 2] + arr[:, 4] - 1
        y2 = arr[:, 3] + arr[:, 5] - 1
        check((arr[:, 2] >= 0).all() and (x2 <= img.shape[1] + 1e-3).all()
              and (arr[:, 3] >= 0).all() and (y2 <= img.shape[0] + 1e-3).all(),
              "box outside the image's valid extent")


def check_engine_parity(det, engines, hw, rng, label="WIDERFACE-L"):
    import torch

    imgs = frames(rng, 1, hw)
    vhw = np.asarray([hw[0] - 8, hw[1]], np.float32)
    ck, rk = engines["bf16_kernels"].dense(imgs)
    cp, rp = engines["bf16_plain"].dense(imgs)
    cf, rf = engines["fp32"].dense(imgs)
    ec, er = rel_err(ck, cp), rel_err(rk, rp)
    kc, kr = rel_err(ck, cf), rel_err(rk, rf)
    pc, pr = rel_err(cp, cf), rel_err(rp, rf)
    print(f"{label} engine bf16 dense max|err|/max|ref|: kernels vs plain cls {ec:.3e} reg "
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
    print(f"{label} decode + NMS on the same dense outputs, K1 vs plain: "
          f"{int(dk['count'][0])} rows, labels {sorted(set(dk['labels'][0].tolist()))[:12]}, "
          f"identical={same}")
    check(same, "decode with K1 differs from decode with the plain NMS")
    return imgs


def check_captured_engines(det, det_s, engines, device, rng):
    """Every captured engine against an eager engine of the same build, on
    two different frames in a row: the same count and labels, boxes and
    scores bit-equal (the same kernels in the same order on the same
    inputs); the first result survives the second call; each capture
    recorded the K1/K2/K3 launches of its variant. WIDERFACE-L at batch 1 in
    every variant and at batch 4 in fp32, bf16 and bf16 with K1-K3;
    WIDERFACE-S in fp32 and bf16."""
    cases = [("L", det, name, 1) for name in ("fp32", "bf16", "bf16_kernels", "bf16_plain")]
    cases += [("L", det, name, 4) for name in ("fp32", "bf16", "bf16_kernels")]
    cases += [("S", det_s, name, 1) for name in ("fp32", "bf16")]
    for size, d, name, batch in cases:
        key = name if batch == 1 else f"{name}_b{batch}"
        captured_vs_eager(d, HW, device, rng, name, batch, f"WIDERFACE-{size}",
                          captured=engines.get(key) if size == "L" else None)


def captured_vs_eager(det, hw, device, rng, name, batch, label, captured=None,
                      preprocess=None, timed=False, **kw):
    """A captured engine of variant `name` (built here unless given)
    against an eager engine of the same build on two different frames in a
    row: the same count and labels, boxes and scores bit-equal; the first
    result survives the second call; its capture recorded the launches that
    expected_launches counts from the net. With `timed`, returns the
    captured engine's ms per call on frames on the card (CUDA events, 10
    calls after 3)."""
    import torch

    if captured is None:
        captured = compile_engine(det, hw, device, name, batch_size=batch,
                                  preprocess=preprocess, **kw)
    eager = compile_engine(det, hw, device, name, batch_size=batch, captured=False,
                           preprocess=preprocess, **kw)
    check(captured.captured and not eager.captured, "wrong engine form")
    want = expected_launches(det, VARIANTS[name])
    got = captured.captured_launches
    f1, f2 = frames(rng, batch, hw), frames(rng, batch, hw)
    vhw = np.asarray([[hw[0] - 8 * i, hw[1] - 16 * i] for i in range(batch)], np.float32)
    r1 = captured(f1, vhw)
    kept = {k: v.clone() for k, v in r1.items()}
    r2 = captured(torch.as_tensor(f2, device=device), torch.as_tensor(vhw, device=device))
    e1, e2 = eager(f1, vhw), eager(f2, vhw)
    torch.cuda.synchronize()
    survived = all(torch.equal(r1[k], kept[k]) for k in kept)
    differ = not torch.equal(r1["scores"], r2["scores"])
    same = all(torch.equal(r[k], e[k]) for r, e in ((r1, e1), (r2, e2)) for k in r)
    key = f"{label} {name} batch {batch}"
    print(f"captured vs eager {key}: rows {r1['count'].tolist()} and "
          f"{r2['count'].tolist()}, bit-equal={same}, first result survives={survived}, "
          f"frames differ={differ}, K1/K2/K3 per capture {tuple(got.values())} "
          f"(counted from the net {tuple(want.values())})")
    check(got == want, f"{key}: a capture should launch {want}")
    check(int(r1["count"].sum()) > 0 and int(r2["count"].sum()) > 0, f"{key}: no rows")
    check(same, f"{key}: the captured engine's rows differ from the eager engine's")
    check(survived, f"{key}: a result did not survive the next call")
    check(differ, f"{key}: two different frames gave the same result")
    ms = None
    if timed:
        x, vt = torch.as_tensor(f1, device=device), torch.as_tensor(vhw, device=device)
        ms = time_ms(lambda: captured(x, vt), iters=10, warmup=3)
    del captured, eager
    torch.cuda.empty_cache()
    return ms


def check_fp32_reference(det, device, rng, preprocess=None, **kw):
    """The fp32 engine on the GPU against the fp32 port on the CPU."""
    from lfdtpu_torch.deploy import compile_inference, make_device_preprocess

    pre = preprocess or make_device_preprocess(MEAN, STD)
    gpu = compile_inference(det, SMALL_HW, "fp32", preprocess=pre, device=device, **kw)
    cpu = compile_inference(det, SMALL_HW, "fp32", preprocess=pre, device="cpu", **kw)
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


def train_batch(rng, n, hw, nmax, num_classes=1, top=None):
    """Seeded uint8 frames and GT padded to `nmax` rows: 0 to 30 boxes per
    image (about 20% of images none, the sampler's neg_ratio 0.2), sides
    log-uniform over 4 px to `top` (default: the WIDERFACE scales' 320,
    capped at 0.8 of the crop), aspect 0.7..1.3, inside the crop, labels
    drawn over `num_classes`."""
    images = frames(rng, n, hw)
    gt = np.zeros((n, nmax, 4), np.float32)
    labels = np.zeros((n, nmax), np.int32)
    mask = np.zeros((n, nmax), bool)
    top = top or min(320.0, 0.8 * min(hw))
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
        if num_classes > 1:
            labels[i, :k] = rng.randint(0, num_classes, k)
    return images, gt, labels, mask


def init_weights(seed, name="WIDERFACE-L"):
    """The zoo model's state_dict from lfdtpu's initializers, seeded."""
    import torch

    from lfdtpu_torch import zoo

    det = zoo.ZOO[name]()
    det.init(torch.Generator().manual_seed(seed))
    return det.net.state_dict()


def make_trainer(device, hw, weights, mixed_precision=False, factory=None):
    """A fresh WIDERFACE-L (or factory()) with `weights`, its TrainState on
    `device` and the train step: SGD momentum 0.9, wd 1e-4, clip 10, uint8
    frames through the (0.5, 0.5) device preprocess."""
    from lfdtpu_torch import zoo
    from lfdtpu_torch.deploy import make_device_preprocess
    from lfdtpu_torch.execution import SGD
    from lfdtpu_torch.parallel import create_train_state, make_train_step

    det = factory() if factory else zoo.widerface_lfd("L")
    det.net.load_state_dict(weights)
    state = create_train_state(det, SGD(momentum=0.9, weight_decay=1e-4), device=device)
    step = make_train_step(det, state.optimizer, hw, clip_max_norm=10.0,
                           preprocess=make_device_preprocess(MEAN, STD),
                           mixed_precision=mixed_precision)
    return det, step


def check_train_gpu_vs_cpu(device, factory=None, label="WIDERFACE-L"):
    """Two fp32 steps at 128x128, batch 2, on the GPU and on the CPU from
    the same weights and batch. The weights have randomized norm affines and Scales (build_detector): a
    parameter that starts at zero would be held to the relative error of
    its update alone. factory: a detector with such weights (WIDERFACE-L's
    by default)."""
    weights = (factory() if factory else build_detector("cpu", seed=7)).net.state_dict()
    batch = train_batch(np.random.RandomState(7), 2, TRAIN_SMALL_HW, TRAIN_NMAX)
    sched = train_schedule()
    runs = {}
    for dev in (device, "cpu"):
        det, step = make_trainer(dev, TRAIN_SMALL_HW, weights, factory=factory)
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
    print(f"train fp32 GPU vs CPU, {label} {TRAIN_SMALL_HW[0]}x{TRAIN_SMALL_HW[1]} "
          "batch 2, 2 steps, "
          "max|err|/max|ref|: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (tol {TRAIN_TOL}, TF32 off)")
    check(gm[0]["num_pos"].item() > 0, "the small training batch has no positives")
    check(max(worst.values()) < TRAIN_TOL, f"{label}: GPU train steps disagree with the CPU")


def train_full_width(device, card, model="WIDERFACE-L", hw=TRAIN_HW, nmax=TRAIN_NMAX):
    """The zoo `model` at full width on its workload's batch (GT padded to
    `nmax` rows, labels over its classes): TRAIN_STEPS steps in fp32 and in
    bf16 on one fixed batch, then the target assignment alone on its GT
    (CUDA events, 5 calls after 1). Returns the bf16-trained detector."""
    import torch

    from lfdtpu_torch import zoo

    weights = init_weights(11, model)
    factory = zoo.ZOO[model]
    batch = [torch.as_tensor(a, device=device) for a in train_batch(
        np.random.RandomState(11), TRAIN_BATCH, hw, nmax,
        num_classes=factory().num_classes)]
    n_boxes = int(batch[3].sum())
    sched = train_schedule()
    for name, mp in (("fp32", False), ("bf16", True)):
        det, step = make_trainer(device, hw, weights, mixed_precision=mp, factory=factory)
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
        print(f"train {name} {model} batch {TRAIN_BATCH} {hw[0]}x{hw[1]} "
              f"({n_boxes} GT boxes, Nmax {nmax}): {ms:.2f} ms/step, "
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
    info = det.level_arrays(hw, device)
    assign = lambda: det._assign(info, *batch[1:3], batch[3].bool())
    ms = time_ms(assign, iters=5, warmup=1)
    P, C = assign()[0].shape[1:]
    print(f"target assignment alone, {model} batch {TRAIN_BATCH} {hw[0]}x{hw[1]}: {ms:.2f} ms "
          f"({P} points x {C} classes: {TRAIN_BATCH * P * C * 4 / 2 ** 20:.0f} MiB of score "
          f"targets) [{card}]")
    return det


def train_to_serve(det, device, counters, classification_threshold=None, preprocess=None,
                   hw=SERVE_HW, **engine_kw):
    """The trained net (left in train mode) into the bf16 engine with every
    kernel its net takes, one frame served; then predict_for_single_image on
    the net itself must leave its running stats and its mode alone. Returns
    the engine's rows."""
    import torch

    from lfdtpu_torch.deploy import make_device_preprocess

    preprocess = preprocess or make_device_preprocess(MEAN, STD)
    variant = kernel_variant(det)
    for c in counters:  # they tick while the engine is built and captured
        c.launches = 0
    engine = compile_engine(det, hw, device, variant, preprocess=preprocess,
                            classification_threshold=classification_threshold, **engine_kw)
    frame = frames(np.random.RandomState(13), 1, (hw[0] - 24, hw[1] - 8))[0]
    rows = det.predict_for_single_image_with_engine(engine, frame)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    want = expected_launches(det, VARIANTS[variant])
    print(f"trained net served through the captured {variant} engine {hw}: "
          f"{len(rows)} rows; launches at build and capture {launches}, per capture "
          f"{engine.captured_launches} (counted from the net {want})")
    for name, n in want.items():
        check(n == 0 or launches[name] > 0, f"the trained net's engine never launched {name}")
    check(engine.captured and engine.captured_launches == want,
          "the trained net's engine did not capture every kernel")
    check_rows(det, rows, frame)
    check(det.net.training, "the trained net left train mode")
    before = {k: v.clone() for k, v in det.net.state_dict().items()}
    image = copy.deepcopy(preprocess)(torch.as_tensor(frame)).numpy()  # the host's normalize
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


def script_path(task, script):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "lfdtpu_torch",
                        "workloads", task, script)


def load_script(task, script):
    """A port workload script as a module under a name of its own (every
    task directory holds a _common.py, an evaluation.py, ...)."""
    spec = importlib.util.spec_from_file_location(f"{task}_{script[:-3]}",
                                                  script_path(task, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload_config(task, script, pack, device_aug, epochs=2, size="L"):
    """config_dict of a port training script (its task's _common, as the
    script builds it) with the environment overrides of a smoke run."""
    os.environ.update(LFD_DEVICE_AUG=str(int(device_aug)), LFD_EPOCHS=str(epochs),
                      LFD_DATASET_PATH=pack, LFD_DEVICE="cuda")
    common, cfg = load_script(task, "_common.py"), {}
    common.prepare_common_settings(cfg, script_path(task, script))
    common.prepare_model(cfg, size)
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

        def images_per_s(self, batch, minus_s=0.0):
            return (len(self.lrs) - 1) * batch / (self.t1 - self.t0 - minus_s)

        def values(self, key):
            return torch.stack([m[key] for m in self.metrics]).cpu().numpy()

    return Record()


def run_workload(cfg, card, label, watch=None):
    """Run the config through the Executor. `watch` (add_val_loop's hook):
    its val passes' seconds are taken out of the images/s, which stays the
    train loop's as in earlier runs."""
    from lfdtpu_torch.execution import Executor

    rec = _record_hook()
    cfg["extra_hooks"] = cfg.get("extra_hooks", []) + [rec]
    ex = Executor(cfg)
    ex.run()
    val_s = sum(p["seconds"] for p in watch.passes) if watch else 0.0
    loss = rec.values("loss")
    sched = cfg["lr_schedule"]
    want = [0.1 * (1 - (1 - (i + 1) / 200) * 0.9) for i in range(len(rec.lrs))]
    print(f"workload {label}: {len(rec.lrs)} iterations, loss "
          + " ".join(f"{v:.4f}" for v in loss)
          + f", lr {rec.lrs[0]:.6f} -> {rec.lrs[-1]:.6f}; Executor "
          f"{rec.images_per_s(cfg['batch_size'], val_s):.1f} images/s after one warmup "
          f"iteration (wall, synchronized{', val passes taken out' if watch else ''}) "
          f"[{card}]")
    check(np.isfinite(loss).all() and np.isfinite(rec.values("grad_norm")).all(),
          f"non-finite losses ({label})")
    check(loss[-1] <= LOSS_BLOWUP * loss[0], f"the loss blew up ({label})")
    check(np.allclose(rec.lrs, want, rtol=1e-12, atol=0)
          and rec.lrs == [sched(0, i) for i in range(len(rec.lrs))],
          f"the lr does not follow the warmup ({label})")
    return ex, rec


def busy_share(prof):
    """Union of the device's kernel and copy intervals over device_events'
    window (profiled's spin-kernel bracket, or the whole trace): each
    device interval counted once, whatever the ops above it."""
    events, (lo, hi), _ = device_events(prof)
    dev = sorted((e.time_range.start, e.time_range.end) for e in events)
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
    LOADER_BATCHES_PER_WORKER[label] batches per worker thread: every image over
    the wall time from the start of the iteration (the workers start there)
    to the last batch."""
    from lfdtpu_torch.data import DataLoader, RandomWithNegDatasetSampler

    src = cfg["train_data_loader"]
    workers = src._num_workers
    k = 0
    sampler = []
    while len(sampler) < LOADER_BATCHES_PER_WORKER[label] * workers:
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


class _ValSet:
    """The pack's first VAL_IMAGES images with the image ids that a
    COCOEvaluator matches on."""

    def __init__(self, dataset):
        self._ds, self._indexes = dataset, dataset.get_indexes()[:VAL_IMAGES]

    def __getitem__(self, i):
        sample = dict(self._ds[i])
        sample["image_id"] = int(i) + 1
        return sample

    def __len__(self):
        return len(self._indexes)

    def get_indexes(self):
        return list(self._indexes)


def add_val_loop(cfg, tmp):
    """val_interval 1, a val loader over _ValSet (whole images, padded to
    the batch's largest, the workload's val pipeline) and a COCOEvaluator
    over its boxes. Returns the hook that watches the val passes."""
    import torch

    from lfdtpu_torch.data import (DataLoader, IdleRegionSampler, RandomDatasetSampler,
                                   simple_widerface_val_pipeline)
    from lfdtpu_torch.evaluation import COCOEvaluator
    from lfdtpu_torch.execution import Hook

    val = _ValSet(cfg["train_data_loader"]._dataset)
    images, annotations = [], []
    for i in val.get_indexes():
        s = val[i]
        h, w = s["image"].shape[:2]
        images.append({"id": s["image_id"], "height": h, "width": w, "file_name": f"{i}.jpg"})
        for x, y, bw, bh in s.get("bboxes", []):
            annotations.append({"id": len(annotations) + 1, "image_id": s["image_id"],
                                "category_id": 1, "bbox": [x, y, bw, bh], "iscrowd": 0,
                                "area": bw * bh})
    ann_path = os.path.join(tmp, "val.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "face"}]}, f)
    # a few steps on noise may leave every score under the detector's 0.05:
    # a lower threshold makes the val pass emit rows to evaluate
    cfg["model"].classification_threshold = SERVE_THRESHOLD
    cfg["val_interval"] = 1
    cfg["val_data_loader"] = DataLoader(
        val, RandomDatasetSampler(val, batch_size=VAL_BATCH, shuffle=False), IdleRegionSampler(),
        augmentation_pipeline=simple_widerface_val_pipeline, num_workers=2, pad_divisor=64)
    cfg["evaluator"] = COCOEvaluator(ann_path, {0: 1})

    class WatchVal(Hook):
        """Per val pass: its seconds (synchronized), the result lists by
        image id, and whether the net's state (weights, BN statistics) and
        mode came through unchanged."""

        def __init__(self):
            super().__init__()
            self.passes = []

        def before_val_epoch(self, executor):
            torch.cuda.synchronize()
            net = executor.state.net
            self._t0 = time.perf_counter()
            self._before = {k: v.clone() for k, v in net.state_dict().items()}
            self._results = {}

        def after_val_iter(self, executor):
            c = executor.config_dict
            for rows, meta in zip(c["eval_results"], c["eval_meta"]):
                self._results[meta["image_id"]] = rows

        def after_val_epoch(self, executor):
            torch.cuda.synchronize()
            net = executor.state.net
            same = all(torch.equal(v, self._before[k]) for k, v in net.state_dict().items())
            self.passes.append(dict(seconds=time.perf_counter() - self._t0,
                                    results=self._results, untouched=same and net.training,
                                    metrics=dict(executor.config_dict["evaluator"].metrics)))

    watch = WatchVal()
    cfg["extra_hooks"] = cfg.get("extra_hooks", []) + [watch]
    return watch, len(annotations)


def check_val_loop(watch, n_boxes, card):
    check(len(watch.passes) == 2, "val_interval 1 over 2 epochs should validate twice")
    for i, p in enumerate(watch.passes):
        rows = sum(len(r) for r in p["results"].values())
        print(f"val pass {i + 1}: {len(p['results'])} images ({n_boxes} GT boxes) in "
              f"{p['seconds']:.2f} s (fp32 eval forward, batch {VAL_BATCH}, decode, "
              f"COCOEvaluator; wall, synchronized), {rows} result rows, metrics "
              + ", ".join(f"{k} {v:.4f}" for k, v in p["metrics"].items())
              + f", net state and train mode untouched={p['untouched']} [{card}]")
        check(sorted(p["results"]) == list(range(1, VAL_IMAGES + 1)),
              "not one result list per val image")
        check(p["metrics"] and np.isfinite(list(p["metrics"].values())).all(),
              "non-finite evaluation metrics")
        check(p["untouched"], "the val pass changed the net's state or mode")


def check_sio_evaluation(pack, ckpt, tmp):
    """The port's evaluation.py script over SIO_IMAGES JPEGs written from the
    pack into two event folders: one txt per image, in the WIDERFACE
    format."""
    from lfdtpu_torch.data import Dataset, jpeg_encode

    ds = Dataset(load_path=pack)
    val_root, out_root = os.path.join(tmp, "WIDER_val"), os.path.join(tmp, "sio")
    want = []
    for n, i in enumerate(ds.get_indexes()[:SIO_IMAGES]):
        event = f"{n % 2}--Event{n % 2}"
        os.makedirs(os.path.join(val_root, event), exist_ok=True)
        with open(os.path.join(val_root, event, f"img_{n}.jpg"), "wb") as f:
            f.write(jpeg_encode(ds[i]["image"], quality=90))
        want.append(os.path.join(event, f"img_{n}.txt"))
    script = load_script("WIDERFACE_train", "evaluation.py")
    t0 = time.time()
    n = script.run_SIO_evaluation("L", ckpt, val_root, out_root,
                                  classification_threshold=SERVE_THRESHOLD)
    got = sorted(os.path.relpath(os.path.join(d, f), out_root)
                 for d, _, files in os.walk(out_root) for f in files)
    rows = 0
    for rel in got:
        with open(os.path.join(out_root, rel)) as f:
            lines = f.read().splitlines()
        ok = (lines[0] == os.path.basename(rel)[:-4] and int(lines[1]) == len(lines) - 2
              and lines[2] == "0 0 0 0 0.001")
        for line in lines[3:]:
            parts = line.split(" ")
            ok = ok and len(parts) == 5 and all(p.lstrip("-").isdigit() for p in parts[:4]) \
                and re.fullmatch(r"[01]\.\d{3}", parts[4]) is not None
        check(ok, f"{rel} is not in the WIDERFACE result format")
        rows += len(lines) - 3
    print(f"SIO evaluation script: {n} JPEGs (quality 90, from the pack) in "
          f"{time.time() - t0:.1f} s, {len(got)} txt files, {rows} rows")
    check(n == SIO_IMAGES and got == sorted(want) and rows > 0,
          "the SIO evaluation did not write one txt per image")


def workload_phase(device, card, counters):
    """Phase 8: the WIDERFACE training entry point, end to end."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.data import AUG_KEYS
    from lfdtpu_torch.execution import ProfilerHook
    from lfdtpu_torch.parallel import BATCH_KEYS

    task, script = "WIDERFACE_train", "WIDERFACE_LFD_L.py"
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

        cfg = workload_config(task, script, pack, device_aug=True)
        watch, n_boxes = add_val_loop(cfg, tmp)
        ex, rec = run_workload(cfg, card, "device aug, 2 epochs, a val pass after each", watch)
        check_val_loop(watch, n_boxes, card)
        work = cfg["work_dir"]
        ckpts = sorted(f for f in os.listdir(work) if f.endswith(".pth"))
        print(f"checkpoints: {ckpts}")
        check(ckpts == ["epoch_1.pth"], "the workload wrote no epoch_1.pth")
        ckpt_path = os.path.join(work, "epoch_1.pth")
        saved = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        aug_batch = loader_alone(cfg, card, "device aug")
        del ex

        cfg2 = workload_config(task, script, pack, device_aug=True)
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

        host_cfg = workload_config(task, script, pack, device_aug=False)
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
        check_sio_evaluation(pack, final, tmp)
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

    l0, l1, l2 = k3_shapes()
    out["pair_conv3x3"] = time_k3(device, card, k3_in[1:], g, ((l0, True), (l0, False),
                                                               (l1, True), (l2, True)))[0]
    out["stem_conv"] = time_k2(device, card, k2_in, g)

    boxes = torch.rand(1, 1000, 4, generator=g, device=device) * 500
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 1000, dtype=torch.bool, device=device)
    out["nms_mask_sorted"] = time_k1(boxes, valid, g, card)
    return out


def time_k3(device, card, consts, g, cases):
    """K3 at each (H, W), residual case of `cases`, batch 1: warm and cold
    CUDA-graph ms, its bound, its plain version and cuDNN's yardsticks.
    Returns the fields of the kernels line per case, in order."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    wk, s, b = consts
    w_cd = (wk.float() * s).bfloat16().permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b_cd = b.bfloat16()
    rows = []
    for (hh, ww), residual in cases:
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
        rows.append(dict(shape=list(shape), residual=residual, **_timing(
            "pair_conv3x3", shape, card, warm, cold, plain, lib_ms, residual,
            library_call=call)))
        del ys, xs
    return rows


def time_k2(device, card, k2_in, g):
    """K2 on k2_in's frame and constants: warm and cold CUDA-graph ms, its
    bound and its plain version. Returns the fields of the kernels line."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

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
    return _timing("stem_conv", tuple(frame.shape[:3]), card, warm, cold, plain, None)


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


def profile_engine(engine, x, vhw, card, label, counters, want, frames_=PROFILED_FRAMES):
    """One frame of a kernel engine launches each kernel as `want` (from
    expected_launches) says: counted by the wrappers for the eager engine, and
    for the captured one at its capture and, over the profiled replays, by
    kernel name. Then torch.profiler over PROFILED_FRAMES frames: each
    kernel's device ms per frame, all device work per frame, the device-busy
    share and the busiest kernels. Returns the busy share and all device ms
    per frame."""
    import torch

    for c in counters:
        c.launches = 0
    engine(x, vhw)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"one frame of the {label} kernel engine: the wrappers counted {launches}"
          + (f", the capture {engine.captured_launches}" if engine.captured else "")
          + f" (counted from the net {want})")
    check(launches == ({k: 0 for k in launches} if engine.captured else want)
          and (not engine.captured or engine.captured_launches == want),
          f"one {label} frame should launch {want}")
    prof, _ = profiled(lambda: engine(x, vhw),
                       lambda: [engine(x, vhw) for _ in range(frames_)])
    by_name, calls = {}, {}
    events, _, window = device_events(prof)
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        calls[e.name] = calls.get(e.name, 0) + 1
    per_frame = {}
    for kernel, keys in KERNEL_NAMES.items():
        names = [n for n in by_name if any(k in n for k in keys)]
        per_frame[kernel] = (sum(by_name[n] for n in names) / frames_,
                             sum(calls[n] for n in names) / frames_ / len(keys))
    share = busy_share(prof)
    total = sum(by_name.values()) / frames_
    hw = engine.input_resolution
    print(f"profile, {frames_} frames of the {label} kernel engine "
          f"{hw[0]}x{hw[1]}: device ms per frame " + ", ".join(
              f"{k} {ms:.4f} ({n:.0f} launches)" for k, (ms, n) in per_frame.items())
          + f"; all device work {total:.3f} ms per frame, busy share "
          + ("not measured" if share is None else f"{share:.3f}") + f" ({window}) [{card}]")
    k1_names = {n: NMS_KERNEL_NAME.search(n).group(0) for n in by_name if "nms_" in n}
    print("  K1's kernels, ms per frame: " + ", ".join(
        f"{kname} {by_name[n] / frames_:.4f}" for n, kname in k1_names.items()))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / frames_:8.4f} ms/frame  {calls[name] / frames_:5.1f}x  "
              f"{name[:110]}")
    counted, _ = kernel_launches_in(prof)  # a replay's launches are visible only here
    check(counted == {k: frames_ * v for k, v in want.items()},
          f"{frames_} {label} frames launched {counted}, not {want} each")
    return share, total


def time_engines(det, det_s, engines, imgs, device, card):
    """ms/frame of the eager (A) and the captured (B) engine of each variant
    at batch 1, CUDA events around 30 calls after 10, in the order A B B A
    within this one run (eager times move between runs: the host sets their
    pace); first on a frame already on the card, then from a numpy frame
    (the copy from host memory included). Then the captured engines alone
    of bf16 with the plain NMS (the oracle's price) and of WIDERFACE-S, and
    the bf16_kernels engines at batch 4, per batch."""
    import torch

    x = torch.as_tensor(imgs, device=device)
    vhw_np = np.asarray([HW[0] - 8, HW[1]], np.float32)
    vhw = torch.as_tensor(vhw_np, device=device)
    for name in ("bf16_kernels", "bf16", "fp32"):
        pair = {"eager": compile_engine(det, HW, device, name, captured=False),
                "captured": engines[name]}
        for source, args in (("frame on the card", (x, vhw)), ("numpy frame", (imgs, vhw_np))):
            ms = {k: [] for k in pair}
            for k in ("eager", "captured", "captured", "eager"):
                ms[k].append(time_ms(lambda e=pair[k]: e(*args), iters=30, warmup=10))
            print(f"engine {name} {HW[0]}x{HW[1]} batch 1, {source}: eager "
                  + ", ".join(f"{t:.3f}" for t in ms["eager"]) + " ms/frame; captured "
                  + ", ".join(f"{t:.3f}" for t in ms["captured"]) + f" ms/frame [{card}]")
        if name == "bf16_kernels":
            # the predict entry point around it: pad into the bucket, the
            # engine, the results to the host, rows (host clock: every call
            # ends in the copy of its rows to the host)
            frame = imgs[0, :1080]
            ms = {k: [] for k in pair}
            for k in ("eager", "captured", "captured", "eager"):
                det.predict_for_single_image_with_engine(pair[k], frame)
                t0 = time.perf_counter()
                for _ in range(20):
                    det.predict_for_single_image_with_engine(pair[k], frame)
                ms[k].append((time.perf_counter() - t0) * 1e3 / 20)
            print(f"predict_for_single_image_with_engine, {name}, a 1080x1920 uint8 frame to "
                  "rows on the host: eager " + ", ".join(f"{t:.3f}" for t in ms["eager"])
                  + " ms/frame; captured " + ", ".join(f"{t:.3f}" for t in ms["captured"])
                  + f" ms/frame (host clock, 20 calls after 1) [{card}]")
        del pair
    alone = {"WIDERFACE-L bf16_plain (K - 1 fixed NMS rounds)": engines["bf16_plain"]}
    for name in ("bf16", "fp32"):
        alone[f"WIDERFACE-S {name}"] = compile_engine(det_s, HW, device, name)
    for label, engine in alone.items():
        ms = [time_ms(lambda: engine(x, vhw), iters=15, warmup=5) for _ in range(2)]
        print(f"engine {label} {HW[0]}x{HW[1]} batch 1, frame on the card: captured "
              + ", ".join(f"{t:.3f}" for t in ms) + f" ms/frame [{card}]")
    del alone, engine
    x4 = torch.as_tensor(np.concatenate([imgs] * 4), device=device)
    pair = {"eager": compile_engine(det, HW, device, "bf16_kernels", batch_size=4,
                                    captured=False),
            "captured": engines["bf16_kernels_b4"]}
    ms = {k: [] for k in pair}
    for k in ("eager", "captured", "captured", "eager"):
        ms[k].append(time_ms(lambda e=pair[k]: e(x4, vhw), iters=15, warmup=5))
    print(f"engine bf16_kernels {HW[0]}x{HW[1]} batch 4, frames on the card: eager "
          + ", ".join(f"{t:.3f}" for t in ms["eager"]) + " ms/batch; captured "
          + ", ".join(f"{t:.3f}" for t in ms["captured"]) + f" ms/batch [{card}]")


def latency_sweep(device, card):
    """The port's inference_latency_evaluation (what the WIDERFACE
    timing_inference_latency.py script runs) for WIDERFACE-L and -XS in bf16
    at the script's four resolutions, SWEEP_LOOPS timed calls per cell (the
    script's default is 50), each call waited for."""
    import torch

    from lfdtpu_torch import zoo
    from lfdtpu_torch.deploy import inference_latency_evaluation, make_device_preprocess

    for size in ("L", "XS"):
        det = zoo.widerface_lfd(size)
        det.init(torch.Generator().manual_seed(0))
        res = inference_latency_evaluation(
            det, precisions=("bf16",), preprocess=make_device_preprocess(MEAN, STD),
            timing_loops=SWEEP_LOOPS, verbose=False, device=device)
        check(len(res) == 4, "the sweep should give four cells")
        for (precision, (h, w)), r in res.items():
            print(f"sweep WIDERFACE-{size} {precision} {w}x{h}: median "
                  f"{r['ms_per_image']:.3f} ms/image, p25 {r['ms_p25']:.3f}, p75 "
                  f"{r['ms_p75']:.3f}, p95 {r['ms_p95']:.3f}, min {r['ms_min']:.3f}, "
                  f"{r['fps']:.1f} FPS, {r['loops']} calls, {r['method']} [{card}]")
            check(r["method"] == "cuda_events_per_call" and r["loops"] == SWEEP_LOOPS
                  and np.isfinite(list(v for v in r.values() if not isinstance(v, str))).all()
                  and 0 < r["ms_min"] <= r["ms_per_image"] <= r["ms_p95"],
                  f"bad latency cell {precision} {w}x{h}")
        torch.cuda.empty_cache()


# ------------------------------------------------------------- traffic serve

def traffic_preprocess(name):
    """The workload's device normalize: TT100K's (0.5, 0.5), TL's imagenet
    constants after BGR -> RGB (which K2 folds into its weights)."""
    from lfdtpu_torch.deploy import make_device_preprocess

    mean, std, swap = TRAFFIC[name][1]
    return make_device_preprocess(mean, std, bgr2rgb=swap)


def serve_traffic(name, device, card, counters, rng):
    """Phase 9, one traffic model at its frame size. Its main path first:
    the counters zeroed, the captured engine with every kernel the net takes
    built (batch 1, and 4 for TT100K), SERVED_FRAMES frames (and a batch of
    4) through the predict entry points, the replays counted from a profile;
    K1/K2/K3 launched as expected_launches counts from the net. Then: K2
    with the engine's folded constants against its plain version; the
    kernel engine's dense outputs against the plain bf16 engine, decode and
    NMS with K1 against the plain NMS (rows identical); the fp32 engine
    against the CPU; every captured variant against an eager twin (and its
    ms/frame); a profile of the kernel engine. Returns (the main path's
    launches at build and capture, its replayed launches, K2's max abs
    error)."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    hw, _, extra, batches = TRAFFIC[name]
    det = build_detector(device, seed=len(name), name=name, cls_std=CLS_STD)
    pre = traffic_preprocess(name)
    kv = kernel_variant(det)
    want = expected_launches(det, VARIANTS[kv])
    print(f"{name} {hw[0]}x{hw[1]}: {det.num_classes} classes, strides {det.point_strides}, "
          f"levels {det.level_sizes(hw)} points; {kv} engines launch {want} per frame "
          f"(counted from the net)")
    if kv != "bf16_kernels":
        try:
            compile_engine(det, hw, device, "bf16_kernels", preprocess=pre, **extra)
            refusal = None
        except ValueError as e:
            refusal = str(e)
        print(f"{name} with kernel_stem=True: {refusal}")
        check(refusal is not None and "stem0" in refusal,
              f"{name}: a kernel_stem engine of a 48-channel stem should raise")

    for c in counters:
        c.launches = 0
    engines = {b: compile_engine(det, hw, device, kv, batch_size=b, preprocess=pre, **extra)
               for b in batches}
    h, w = hw
    singles = [frames(rng, 1, (h - 8 * i - 7, w - 16 * i))[0] for i in range(SERVED_FRAMES)]
    batch4 = [frames(rng, 1, (h - h // 8 * i, w - w // 6 * i))[0] for i in range(4)]

    def work():
        rows = [det.predict_for_single_image_with_engine(engines[1], f) for f in singles]
        if 4 in engines:
            rows += det.predict_for_batch_with_engine(engines[4], batch4)
        return rows

    prof, rows = profiled(lambda: engines[1](frames(rng, 1, hw), hw), work)
    launches = {c.__name__: c.launches for c in counters}
    replays = SERVED_FRAMES + (4 in engines)
    replayed, window = kernel_launches_in(prof)
    print(f"{name} main path: {replays} replays served {[len(r) for r in rows]} rows; "
          f"launches at build and capture {launches}; by the replays (profile) {replayed} "
          f"({window})")
    for k, v in want.items():
        check((launches[k] > 0) == (v > 0), f"{name}: {k} launched {launches[k]} times "
              f"at build and capture, the net takes it {v} times a frame")
    check(all(e.captured_launches == want for e in engines.values()),
          f"{name}: a capture did not record {want}")
    check(replayed == {k: replays * v for k, v in want.items()},
          f"{name}: the replays did not launch each kernel as captured")
    for r, img in zip(rows, singles + batch4):
        check_rows(det, r, img)
    check(sum(map(len, rows)) > 0, f"{name}: the main path returned no rows")

    k2_err = 0.0
    if want["stem_conv"]:
        pack = engines[1].net._backbone.fused_stem.pack
        for b in batches:
            x = torch.as_tensor(frames(rng, b, hw), device=device)
            got, ref = ck.stem_conv(x, *pack), ck.stem_conv_plain(x, *pack)
            err = rel_err(got, ref)
            k2_err = max(k2_err, float((got.float() - ref.float()).abs().max()))
            print(f"K2 {name} engine constants (mean {[round(v, 2) for v in pack[1].tolist()]}, "
                  f"std {[round(v, 2) for v in pack[2].tolist()]}, bgr2rgb "
                  f"{TRAFFIC[name][1][2]}) {tuple(x.shape)}: max|err|/max|ref| {err:.3e} "
                  f"(tol {K2_TOL})")
            check(err < K2_TOL, f"{name}: K2 disagrees with its plain version")

    eager = {"bf16_kernels": kv, "bf16_plain": "bf16_plain", "fp32": "fp32"}
    check_engine_parity(det, {k: compile_engine(det, hw, device, v, captured=False,
                                                preprocess=pre, **extra)
                              for k, v in eager.items()}, hw, rng, label=name)
    check_fp32_reference(det, device, rng, preprocess=pre, **extra)
    x = torch.as_tensor(frames(rng, 1, hw), device=device)
    vhw = torch.tensor([h - 8, w], dtype=torch.float32, device=device)
    profile_engine(engines[1], x, vhw, card, name, counters, want, frames_=3)
    ms = {}
    for b in batches:
        for variant in ("fp32", "bf16", kv):
            ms[(variant, b)] = captured_vs_eager(
                det, hw, device, rng, variant, b, name,
                captured=engines.pop(b) if variant == kv else None, preprocess=pre,
                timed=True, **extra)
    print(f"{name} {hw[0]}x{hw[1]} captured engines, frame on the card, ms per call: "
          + ", ".join(f"{v} batch {b} {t:.3f}" for (v, b), t in ms.items()) + f" [{card}]")
    torch.cuda.empty_cache()
    return launches, replayed, k2_err


def check_k3_new_shapes(device, card):
    """K3 at TT100K's 2048x2048 levels (512x512, 256x256, 128x128, batch 1
    and 4) against its plain version, and K2 at 2048x2048; then times K3 at
    512x512 with and without the residual and 256x256 with it, and K2 at
    2048x2048 and at TL's 768x1280 with TL-L's folded constants. Returns
    (max abs errors, the timing rows)."""
    import torch

    from lfdtpu_torch.deploy import compile_inference

    errs, k2_in, k3_in = check_k2_k3(device, TT_HW)
    g = torch.Generator(device=device).manual_seed(4)
    l0, l1, _ = k3_shapes(TT_HW)
    rows = time_k3(device, card, k3_in[1:], g, ((l0, True), (l0, False), (l1, True)))
    rows.append(dict(shape=[1, *TT_HW], **time_k2(device, card, k2_in, g)))
    det = build_detector(device, seed=2, name="TL-L")
    eng = compile_inference(det, TL_HW, "bf16", preprocess=traffic_preprocess("TL-L"),
                            kernel_stem=True, device=device, captured=False)
    frame = torch.randint(0, 256, (1, *TL_HW, 3), generator=g, device=device,
                          dtype=torch.uint8)
    rows.append(dict(shape=[1, *TL_HW], bgr2rgb=True,
                     **time_k2(device, card, (frame, *eng.net._backbone.fused_stem.pack), g)))
    return errs, rows


# ---------------------------------------------------------- traffic training

def write_frame(path, hw, rng, boxes=()):
    """A smooth seeded BGR frame (random 32x32-pixel cells, linearly
    upsampled) with each xyxy box filled in a flat color, as a JPEG of
    quality 90."""
    from lfdtpu_torch.data import jpeg_encode, resize_linear

    cells = rng.randint(0, 256, (hw[0] // 32 + 1, hw[1] // 32 + 1, 3)).astype(np.uint8)
    img = resize_linear(cells, size=(hw[1], hw[0]))
    for x0, y0, x1, y1 in boxes:
        img[int(y0):int(y1) + 1, int(x0):int(x1) + 1] = rng.randint(0, 256, 3)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(jpeg_encode(img, quality=90))


def build_tt100k_pack(tmp, seed=19):
    """A TT100K-like data root (annotations.json, train/ids.txt,
    test/ids.txt, 2048x2048 JPEGs): TT_PACK_POS images with type45 signs of
    8-200 px (log-uniform): every tenth image 1-8 of them in the middle
    1024 px, so its four margins become negatives, the others 2-8 anywhere
    with one in the top-left and one in the bottom-right 400 px, so they
    give none; TT_PACK_BARE images without a type45 sign. The port's
    generate_neg_images.py cuts the negatives (min_size_threshold 512) and
    its pack_tt100k.py packs through TT100KParser. Returns (pack path, data
    root)."""
    from lfdtpu_torch.data import TT100K_TYPE45

    rng = np.random.RandomState(seed)
    root = os.path.join(tmp, "TT100K", "data")
    imgs, ids = {}, []
    for i in range(TT_PACK_POS + TT_PACK_BARE):
        iid = str(10000 + i)
        objs = []
        central = i % 10 == 0
        for k in range(rng.randint(1 if central else 2, 9) if i < TT_PACK_POS else 0):
            side = float(np.exp(rng.uniform(np.log(8.0), np.log(200.0))))
            lo, hi = (512, 1536 - side) if central else (
                (0, 400 - side) if k == 0 else (TT_HW[0] - 400, TT_HW[0] - side - 1)
                if k == 1 else (0, TT_HW[0] - side - 1))
            x0, y0 = rng.uniform(lo, hi, 2)
            objs.append(dict(category=TT100K_TYPE45[rng.randint(45)],
                             bbox=dict(xmin=x0, ymin=y0, xmax=x0 + side, ymax=y0 + side)))
        if i >= TT_PACK_POS:  # a sign outside the 45 classes: an image without one
            objs.append(dict(category="pl0", bbox=dict(xmin=40, ymin=50, xmax=90, ymax=99)))
        imgs[iid] = dict(path=f"train/{iid}.jpg", objects=objs)
        ids.append(iid)
        write_frame(os.path.join(root, "train", f"{iid}.jpg"), TT_HW, rng,
                    [tuple(o["bbox"].values()) for o in objs])
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump({"imgs": imgs}, f)
    for split, chosen in (("train", ids), ("test", ids[:EVAL_IMAGES])):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        with open(os.path.join(root, split, "ids.txt"), "w") as f:
            f.write("\n".join(chosen))
    n_neg = load_script("TT100K_train", "generate_neg_images.py").generate_neg_images(
        root, "train", "train_neg", min_size_threshold=512)
    pack = os.path.join(tmp, "tt100k_train.pkl")
    ds = load_script("TT100K_train", "pack_tt100k.py").pack(
        root, os.path.join(root, "annotations.json"), os.path.join(root, "train", "ids.txt"),
        neg_image_root=os.path.join(root, "train_neg"), save_path=pack)
    print(f"TT100K pack: {len(ds)} samples ({TT_PACK_POS} with signs, {TT_PACK_BARE} without, "
          f"{n_neg} negatives cut by generate_neg_images.py), {TT_HW[0]}x{TT_HW[1]} JPEGs")
    return pack, root


def build_tl_pack(tmp, seed=23):
    """A TrafficLight-like COCO set: TL_PACK_IMAGES 720x1280 JPEGs, all but
    every fifth with 1-6 lights of 4-80 px (aspect 0.3-0.5, as lights
    stand), one category; one image of 24 px height that the pack drops
    (filter_min_size 32). The port's pack_TL.py packs it through COCOParser
    (images without boxes kept). Returns (pack path, annotation json, image
    root)."""
    rng = np.random.RandomState(seed)
    root = os.path.join(tmp, "TL", "images")
    images, anns = [], []
    for i in range(TL_PACK_IMAGES + 1):
        hw = (720, 1280) if i < TL_PACK_IMAGES else (24, 128)
        boxes = []
        for _ in range(rng.randint(1, 7) if i % 5 != 4 and i < TL_PACK_IMAGES else 0):
            bh = float(np.exp(rng.uniform(np.log(8.0), np.log(80.0))))
            bw = max(4.0, bh * rng.uniform(0.3, 0.5))
            x0, y0 = rng.uniform(0, hw[1] - bw - 1), rng.uniform(0, hw[0] - bh - 1)
            boxes.append([x0, y0, bw, bh])
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                             bbox=[x0, y0, bw, bh], area=bw * bh, iscrowd=0))
        images.append(dict(id=i + 1, file_name=f"{i}.jpg", height=hw[0], width=hw[1]))
        write_frame(os.path.join(root, f"{i}.jpg"), hw, rng,
                    [(x, y, x + bw, y + bh) for x, y, bw, bh in boxes])
    ann = os.path.join(tmp, "TL", "train.json")
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="traffic_light")]), f)
    pack = os.path.join(tmp, "tl_train.pkl")
    ds = load_script("TrafficLight_train", "pack_TL.py").pack(ann, root, save_path=pack)
    check(len(ds) == TL_PACK_IMAGES, "pack_TL.py should drop the image under 32 px")
    print(f"TL pack: {len(ds)} samples of 720x1280 JPEGs, {len(anns)} lights")
    return pack, ann, root


def train_entry_point(task, script, size, pack, card):
    """A port workload script's config trained end to end through the
    Executor: 2 epochs with device augmentation, a resume from epoch_1.pth
    (counters and params exact) for the last epoch, then 2 epochs with host
    augmentation. Returns the final checkpoint."""
    import torch

    from lfdtpu_torch.execution import Executor

    label = script[:-3]
    cfg = workload_config(task, script, pack, device_aug=True, size=size)
    iters = len(cfg["train_data_loader"])
    check(iters >= 2, f"{label}: the pack gives {iters} iterations per epoch, not 2 or more")
    ex, rec = run_workload(cfg, card, f"{label}, device aug, 2 epochs of {iters} iterations")
    ckpt = os.path.join(cfg["work_dir"], "epoch_1.pth")
    check(os.path.isfile(ckpt), f"{label}: no epoch_1.pth")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    del ex
    cfg2 = workload_config(task, script, pack, device_aug=True, size=size)
    cfg2["resume_path"] = ckpt
    resumed = Executor(cfg2)
    same = all(torch.equal(v.cpu(), saved["state_dict"][k])
               for k, v in resumed.state.net.state_dict().items())
    print(f"{label} resumed from epoch_1.pth: epoch {cfg2['epoch']}, train_iter "
          f"{cfg2['train_iter']}, params and BN stats equal the saved ones: {same}")
    check(same and (cfg2["epoch"], cfg2["train_iter"]) == (1, iters),
          f"{label}: resume did not restore the checkpoint exactly")
    resumed.run()
    check(cfg2["train_iter"] == 2 * iters, f"{label}: the resumed run did not train an epoch")
    final = os.path.join(cfg2["work_dir"], "final.pth")
    resumed.save(final)
    del resumed
    host_cfg = workload_config(task, script, pack, device_aug=False, size=size)
    host_ex, _ = run_workload(host_cfg, card, f"{label}, host aug, 2 epochs")
    del host_ex
    torch.cuda.empty_cache()
    return final


def train_traffic(device, card, counters, tmp):
    """Phase 10: the TT100K and TrafficLight training entry points, end to
    end (train_entry_point on packs made by the port's own pack scripts),
    then each final checkpoint served through the kernel engine and scored
    by the port's evaluation.py; and the TT100K-L train step at the
    workload's batch 64, crop 512."""
    import torch

    from lfdtpu_torch import zoo

    t0 = time.time()
    tt_pack, tt_root = build_tt100k_pack(tmp)
    print(f"TT100K data written and packed in {time.time() - t0:.1f} s")
    for c in counters:
        c.launches = 0
    final = train_entry_point("TT100K_train", "TT100K_LFD_L.py", "L", tt_pack, card)
    print("hand-written kernel launches during TT100K training (its path runs none): "
          f"{ {c.__name__: c.launches for c in counters} }")
    det = zoo.tt100k_lfd("L")
    det.net.load_state_dict(torch.load(final, map_location="cpu",
                                       weights_only=True)["state_dict"])
    det.net.to(device)
    rows = train_to_serve(det, device, counters, classification_threshold=SERVE_THRESHOLD,
                          preprocess=traffic_preprocess("TT100K-L"), hw=TRAIN_SERVE_HW)
    check(len(rows) > 0, "the trained TT100K checkpoint's engine returned no rows")
    t0 = time.time()
    summary = load_script("TT100K_train", "evaluation.py").evaluate(
        "L", final, data_root=tt_root, annotation_json=os.path.join(tt_root, "annotations.json"),
        test_id_file=os.path.join(tt_root, "test", "ids.txt"),
        classification_threshold=SERVE_THRESHOLD, minscore=0)
    print(f"TT100K evaluation.py on {EVAL_IMAGES} {TT_HW[0]}x{TT_HW[1]} images in "
          f"{time.time() - t0:.1f} s: accuracy {summary['accuracy']:.4f}, recall "
          f"{summary['recall']:.4f} (minscore 0)")
    check(0 <= summary["accuracy"] <= 1 and 0 <= summary["recall"] <= 1
          and len(summary["wrong"]["imgs"]) == EVAL_IMAGES, "bad TT100K evaluation summary")
    del det
    train_full_width(device, card, "TT100K-L", TT_TRAIN_HW, TT_TRAIN_NMAX)
    torch.cuda.empty_cache()

    tl_pack, tl_ann, tl_root = build_tl_pack(tmp)
    final = train_entry_point("TrafficLight_train", "TL_LFD_L.py", "L", tl_pack, card)
    det = zoo.trafficlight_lfd("L")
    det.net.load_state_dict(torch.load(final, map_location="cpu",
                                       weights_only=True)["state_dict"])
    det.net.to(device)
    rows = train_to_serve(det, device, counters, classification_threshold=SERVE_THRESHOLD,
                          preprocess=traffic_preprocess("TL-L"), hw=TRAIN_SERVE_HW,
                          class_agnostic=True)
    check(len(rows) > 0, "the trained TL checkpoint's engine returned no rows")
    t0 = time.time()
    metrics = load_script("TrafficLight_train", "evaluation.py").evaluate(
        "L", final, val_annotation_path=tl_ann, val_image_root=tl_root,
        val_dataset_pkl=tl_pack, classification_threshold=SERVE_THRESHOLD)
    print(f"TL evaluation.py on {TL_PACK_IMAGES + 1} images in {time.time() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    check(metrics and np.isfinite(list(metrics.values())).all(), "non-finite TL metrics")


# ------------------------------------------------------------------- LFDv2

def k1_inputs(fn):
    """(fn(), the shape of the boxes each call of K1's wrapper got while fn
    ran): what reaches K1, read where ops/nms.py calls the wrapper (a
    capture calls it on the host, so this reads a captured engine too)."""
    from lfdtpu_torch.ops import nms

    shapes, wrapper = [], nms.nms_mask_sorted

    def recorded(boxes_sorted, valid_sorted, iou_thr):
        shapes.append(tuple(boxes_sorted.shape))
        return wrapper(boxes_sorted, valid_sorted, iou_thr)

    nms.nms_mask_sorted = recorded
    try:
        return fn(), shapes
    finally:
        nms.nms_mask_sorted = wrapper


def lfdv2_detector(cls, device, seed=31, **kw):
    """LFDv2 or LFDv2Q on WIDERFACE-L's backbone, neck and head
    (build_detector's seeded, randomized weights), WIDERFACE's classes,
    scales and strides; LFDv2Q classifies with QualityFocalLoss."""
    from lfdtpu_torch import zoo
    from lfdtpu_torch.ops.loss_wrappers import FocalLoss, IoULoss, QualityFocalLoss

    base = build_detector(device, seed=seed)
    net = base.net
    q = cls.__name__ == "LFDv2Q"
    cls_loss = QualityFocalLoss(beta=2.0) if q else FocalLoss()
    if not q:  # LFDv2Q decodes 'exp' only
        kw.setdefault("distance_to_bbox_mode", "sigmoid")
    det = cls(net._backbone, net._neck, net._head, num_classes=1,
              regression_ranges=zoo.WIDERFACE_SCALES, point_strides=base.point_strides,
              classification_loss_func=cls_loss, regression_loss_func=IoULoss(eps=1e-6), **kw)
    det.net.to(device).eval()
    return det


def serve_and_train_lfdv2(device, card, counters, rng):
    """Phase 11: LFDv2 on WIDERFACE-L's parts at 1088x1920. Its main path:
    the counters zeroed, the captured bf16 engine with K1-K3 built and two
    frames served, the replays counted from a profile; then the captured
    engine against an eager twin (bit-equal, launches counted from the
    net), the candidates that reach K1 as read from its wrapper's input;
    then two fp32 train steps
    of LFDv2 and of LFDv2Q on the GPU against the CPU. Returns (the main
    path's launches, its replayed launches)."""
    from lfdtpu_torch.models import LFDv2, LFDv2Q

    det = lfdv2_detector(LFDv2, device)
    want = expected_launches(det, VARIANTS["bf16_kernels"])
    spec = det.decode_spec()
    sizes = det.level_sizes(HW)
    for c in counters:
        c.launches = 0
    engine, k1_shapes = k1_inputs(lambda: compile_engine(det, HW, device, "bf16_kernels"))
    print(f"LFDv2 {HW[0]}x{HW[1]}: levels {sizes} points, per-level limit "
          f"{spec.per_level_limit} -> {sum(min(n, spec.per_level_limit) for n in sizes)} "
          f"points to stage 2 (computed); K1's boxes at build and capture (read) "
          f"{sorted(set(k1_shapes))} (nms_budget {spec.nms_budget})")
    check(k1_shapes and all(k[1] <= spec.nms_budget == det.pre_nms_bbox_limit
                            for k in k1_shapes),
          "LFDv2 passes K1 more candidates than its budget")
    imgs = [frames(rng, 1, (HW[0] - 8 * i, HW[1]))[0] for i in range(2)]
    prof, rows = profiled(lambda: engine(frames(rng, 1, HW), HW),
                          lambda: [det.predict_for_single_image_with_engine(engine, f)
                                   for f in imgs])
    launches = {c.__name__: c.launches for c in counters}
    replayed, window = kernel_launches_in(prof)
    print(f"LFDv2 main path: 2 replays served {[len(r) for r in rows]} rows; launches at "
          f"build and capture {launches}; by the replays (profile) {replayed} ({window})")
    for k, v in want.items():
        check(launches[k] > 0, f"LFDv2's main path never launched {k}")
    check(replayed == {k: 2 * v for k, v in want.items()},
          "LFDv2's replays did not launch each kernel as captured")
    for r, img in zip(rows, imgs):
        check_rows(det, r, img)
    captured_vs_eager(det, HW, device, rng, "bf16_kernels", 1, "LFDv2 (WIDERFACE-L parts)",
                      captured=engine)
    for cls in (LFDv2, LFDv2Q):
        check_train_gpu_vs_cpu(device, lambda cls=cls: lfdv2_detector(cls, "cpu"),
                               cls.__name__)
    return launches, replayed


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
    rng = np.random.RandomState(5)
    counters = (nms_kernel.nms_mask_sorted, conv_kernels.stem_conv,
                conv_kernels.pair_conv3x3)
    # The main path: compile_inference (the wrappers launch their kernels in
    # the warmup calls and while the graph is captured; that is where the
    # host counters tick), then the predict entry points, whose calls replay
    # the graphs: those launches are counted from a profile by kernel name.
    for c in counters:
        c.launches = 0
    t0 = time.time()
    engines = compile_engines(det, HW, device)
    print(f"compiled {len(engines)} captured engines {HW[0]}x{HW[1]} in "
          f"{time.time() - t0:.1f} s; launches per capture "
          f"{ {k: e.captured_launches for k, e in engines.items()} }")
    warm = frames(rng, 1, HW)
    prof, (rows_single, rows_batch) = profiled(
        lambda: engines["bf16_kernels"](warm, HW), lambda: serve(det, engines, HW, rng))
    launches = {c.__name__: c.launches for c in counters}
    replayed, window = kernel_launches_in(prof)
    print(f"served 8 single frames ({sum(map(len, rows_single))} rows) and a batch "
          f"of 4 ({[len(r) for r in rows_batch]} rows); launches at build and capture "
          f"{launches}; launches by the 9 replays (profile, by kernel name) {replayed} "
          f"({window})")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched {name}")
    want = expected_launches(det, VARIANTS["bf16_kernels"])
    check(replayed == {k: 9 * v for k, v in want.items()},
          "the served replays did not launch each kernel as captured")
    imgs = check_engine_parity(det, engines, HW, rng)
    check_fp32_reference(det, device, rng)
    t0 = time.time()
    det_s = build_detector(device, seed=1, size="S")
    check_captured_engines(det, det_s, engines, device, rng)
    print(f"captured engines checked in {time.time() - t0:.1f} s")

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
    time_engines(det, det_s, engines, imgs, device, card)
    timings = time_kernels(device, card, k2_in, k3_in)
    x = torch.as_tensor(imgs, device=device)
    vhw = torch.tensor([HW[0] - 8, HW[1]], dtype=torch.float32, device=device)
    eager = compile_engine(det, HW, device, "bf16_kernels", captured=False)
    share = {"eager": profile_engine(eager, x, vhw, card, "eager WIDERFACE-L", counters,
                                     want)[0],
             "captured": profile_engine(engines["bf16_kernels"], x, vhw, card,
                                        "captured WIDERFACE-L", counters, want)[0]}
    del eager
    check(share["captured"] is not None, "the profiler saw no device time")
    print(f"device-busy share, bf16_kernels engine, frame on the card: eager "
          f"{share['eager']:.3f}, captured {share['captured']:.3f} [{card}]")
    latency_sweep(device, card)
    print(f"[8 workload] {card}")
    t0 = time.time()
    workload_phase(device, card, counters)
    print(f"workload phase {time.time() - t0:.1f} s")

    # each further path is driven with the counters zeroed just before it
    # and read just after (its launches at build and capture, and its
    # replays counted from a profile)
    paths = {"WIDERFACE-L": (launches, replayed)}
    print(f"[9 traffic serve] {card}")
    t0 = time.time()
    for name in TRAFFIC:
        launches_n, replayed_n, k2_err = serve_traffic(name, device, card, counters, rng)
        paths[name] = (launches_n, replayed_n)
        errs["stem_conv"] = max(errs["stem_conv"], k2_err)
    new_errs, new_rows = check_k3_new_shapes(device, card)
    for k, v in new_errs.items():
        errs[k] = max(errs[k], v)
    print(f"traffic serve phase {time.time() - t0:.1f} s")
    print(f"[10 traffic train] {card}")
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="lfd_traffic_")
    cwd, hook, env = os.getcwd(), sys.excepthook, dict(os.environ)
    try:
        os.chdir(tmp)  # the scripts' work dirs go under the temp dir
        train_traffic(device, card, counters, tmp)
    finally:
        os.chdir(cwd)
        sys.excepthook = hook
        os.environ.clear()
        os.environ.update(env)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"traffic train phase {time.time() - t0:.1f} s")
    print(f"[11 LFDv2] {card}")
    t0 = time.time()
    paths["LFDv2 (WIDERFACE-L parts)"] = serve_and_train_lfdv2(device, card, counters, rng)
    print(f"LFDv2 phase {time.time() - t0:.1f} s")

    sources = {
        "nms_mask_sorted": ("lfdtpu_torch/csrc/nms.cu", "lfdtpu/ops/nms_pallas.py:49", err1),
        "stem_conv": ("lfdtpu_torch/csrc/stem_conv.cu", "lfdtpu/ops/conv_pallas.py:359",
                      errs["stem_conv"]),
        "pair_conv3x3": ("lfdtpu_torch/csrc/pair_conv.cu", "lfdtpu/ops/conv_pallas.py:171",
                         errs["pair_conv3x3"]),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=tpu,
                    launches=launches[name], replayed_launches=replayed[name],
                    max_abs_err=err, **timings[name],
                    launches_by_path={p: dict(build_and_capture=ln[name], replayed=rp[name])
                                      for p, (ln, rp) in paths.items()},
                    other_shapes=[{k: v for k, v in r.items() if k != "library_call"}
                                  for r in new_rows
                                  if (name == "pair_conv3x3") == ("residual" in r)
                                  and name != "nms_mask_sorted"])
               for name, (src, tpu, err) in sources.items()]

    print(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
