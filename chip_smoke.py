#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lfdtpu_torch) on one NVIDIA GPU.

Drives the port's main path, the WIDERFACE-L inference engine at full width
(random seeded weights with randomized BatchNorm statistics and affines and
head Scales, so the BN folding is exercised), and checks it:

  1. card     the GPU's name and power limit (nvidia-smi);
  2. build    the hand-written kernels from lfdtpu_torch/csrc/*.cu (nvcc);
  3. K1       NMS keep mask against its plain version, EXACT, at K = 1000 and
              1536: random boxes, valid holes, tied scores, integer boxes whose
              IoUs hit the threshold exactly;
  4. K2, K3   stem and 3x3 conv against their plain versions at the engine's
              1088x1920 shapes, max|err| / max|ref| < 0.03 (K2), 0.02 (K3):
              both are bf16 out of fp32 accumulation in another order;
  5. engine   bf16 engines at 1088x1920 (1080p padded to the stride-64
              multiple): 8 single frames through
              predict_for_single_image_with_engine and one batch of 4 with
              different valid extents through predict_for_batch_with_engine,
              with all three kernels on; every kernel's launch counter must
              grow during that run. Then: dense outputs of the kernel engine
              against the plain bf16 engine and both against fp32; decode + NMS on the same dense
              outputs, K1 against plain, rows identical; the fp32 engine on the
              GPU against the fp32 port on the CPU at 256x256, TF32 off;
  6. timings  CUDA events, warmup excluded: ms/frame of the three engines and
              each kernel against its plain version, beside the card's name
              and power limit.

The second-to-last line is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Any failed check exits non-zero. Needs a
CUDA device: without one it exits 1 and prints no result.

Run from the root of a checkout:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
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
    """K2 and K3 against their plain versions at the engine's shapes.
    Returns ({name: max abs err}, the inputs for timing)."""
    import torch

    from lfdtpu_torch.ops import conv_kernels as ck

    g = torch.Generator(device=device).manual_seed(2)
    frame = torch.randint(0, 256, (1,) + tuple(hw) + (3,), generator=g,
                          device=device, dtype=torch.uint8)
    w = torch.randn(3, 3, 3, 64, generator=g, device=device) * 0.2
    mean = torch.tensor([127.5] * 3, device=device)
    std = torch.tensor([127.5] * 3, device=device)
    s = torch.rand(64, generator=g, device=device) + 0.5
    b = torch.randn(64, generator=g, device=device) * 0.1
    got = ck.stem_conv(frame, w, mean, std, s, b)
    ref = ck.stem_conv_plain(frame, w, mean, std, s, b)
    e2 = rel_err(got, ref)
    abs2 = float((got.float() - ref.float()).abs().max())
    print(f"K2 {tuple(frame.shape)} -> {tuple(got.shape)}: max|err|/max|ref| "
          f"{e2:.3e} (tol {K2_TOL})")
    check(got.shape == ref.shape and e2 < K2_TOL, "K2 disagrees with its plain version")

    abs3 = 0.0
    k3_inputs = None
    h, w_ = (hw[0] + 3) // 4, (hw[1] + 3) // 4
    for (hh, ww) in ((h, w_), ((h + 1) // 2, (w_ + 1) // 2),
                     ((h + 3) // 4, (w_ + 3) // 4)):
        x = torch.randn(1, hh, ww, 64, generator=g, device=device).bfloat16()
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
    return {"stem_conv": abs2, "pair_conv3x3": abs3}, (frame, w, mean, std, s, b), k3_inputs


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
    return rows_single, rows_batch


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

    print(f"[6 timings] {card}")
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
    boxes = torch.rand(1, 1000, 4, device=device) * 500
    boxes[..., 2:] += boxes[..., :2]
    valid = torch.ones(1, 1000, dtype=torch.bool, device=device)
    k1 = (time_ms(lambda: nms_kernel.nms_mask_sorted(boxes, valid, 0.4)),
          time_ms(lambda: nms_kernel.nms_mask_sorted_plain(boxes, valid, 0.4)))
    k2 = (time_ms(lambda: conv_kernels.stem_conv(*k2_in)),
          time_ms(lambda: conv_kernels.stem_conv_plain(*k2_in)))
    k3 = (time_ms(lambda: conv_kernels.pair_conv3x3(*k3_in, residual=k3_in[0])),
          time_ms(lambda: conv_kernels.pair_conv3x3_plain(*k3_in, residual=k3_in[0])))
    # cuDNN's own bf16 conv at K3's shape (not the plain version, which runs
    # in fp32): the library bar the hand kernel is measured against
    xin = k3_in[0].permute(0, 3, 1, 2)
    wcd = k3_in[1].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    k3_cudnn = time_ms(lambda: torch.nn.functional.conv2d(xin, wcd, padding=1))
    for name, (ms, plain_ms), shape in (
            ("nms_mask_sorted", k1, "B=1 K=1000"),
            ("stem_conv", k2, f"{tuple(k2_in[0].shape)}"),
            ("pair_conv3x3", k3, f"{tuple(k3_in[0].shape)} +residual")):
        print(f"kernel {name} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
    print(f"cuDNN bf16 conv2d at {tuple(k3_in[0].shape)} (no epilogue): "
          f"{k3_cudnn:.4f} ms [{card}]")

    kernels = [
        dict(name="nms_mask_sorted", route="cuda", source="lfdtpu_torch/csrc/nms.cu",
             replaces="lfdtpu/ops/nms_pallas.py:49",
             launches=launches["nms_mask_sorted"], max_abs_err=err1,
             ms=k1[0], plain_ms=k1[1]),
        dict(name="stem_conv", route="cuda", source="lfdtpu_torch/csrc/stem_conv.cu",
             replaces="lfdtpu/ops/conv_pallas.py:359",
             launches=launches["stem_conv"], max_abs_err=errs["stem_conv"],
             ms=k2[0], plain_ms=k2[1]),
        dict(name="pair_conv3x3", route="cuda", source="lfdtpu_torch/csrc/pair_conv.cu",
             replaces="lfdtpu/ops/conv_pallas.py:171",
             launches=launches["pair_conv3x3"], max_abs_err=errs["pair_conv3x3"],
             ms=k3[0], plain_ms=k3[1]),
    ]
    print(f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
