# Latency measurement (`lfdtpu/deploy/latency.py`, reference
# `lfd/deployment/tensorrt/inference_latency_evaluation.py:19-127`,
# `timing_engine`).
#
# The reference's protocol: warmup loops (the engine's build excluded), then
# N timed loops with a device sync per loop; ms/image and FPS. As in lfdtpu,
# and unlike the reference, the engine timed here includes the on-device
# decode and NMS.
#
# On a CUDA device each call is timed by a pair of CUDA events around it,
# the second one waited for before the next call starts (the reference's
# stream synchronize per loop); on the CPU by time.perf_counter. lfdtpu's
# own workarounds for a remote device whose calls return when they are
# queued (an output fetch as the barrier, a slope over two queue depths, and
# a device-only time from an on-device loop) have no counterpart here: a
# CUDA event's elapsed time is the device's own clock.

from __future__ import annotations

import time

import numpy as np
import torch


def timing_inference(engine, images, valid_hw, warmup_loops=10, timing_loops=None,
                     distinct_inputs=8, target_s=2.0):
    """Time a compiled engine call by call.

    - rotates over `distinct_inputs` frames already on the engine's device
      (the first is `images`, the rest seeded noise), so the copy from host
      memory is not in the number and no call sees the input of the one
      before;
    - `warmup_loops` calls (at least one per input) come first and are not
      timed, as in the reference's `timing_engine`;
    - each timed call is waited for before the next one starts.

    timing_loops: the number of timed calls; None sizes it so that they
    take about `target_s` seconds (20 to 1000 calls).

    Returns dict(ms_per_image=median, fps, ms_mean, ms_min, ms_p25, ms_p75,
    ms_p95, loops, method): per image, a call's time over the batch size.
    """
    images = np.asarray(images)
    batch = images.shape[0]
    device = engine.device
    on_card = device.type == "cuda"
    g = torch.Generator(device=device).manual_seed(0)
    variants = [torch.as_tensor(images).to(device)]
    for _ in range(max(distinct_inputs - 1, 0)):  # made on the device
        variants.append(torch.randint(0, 255, images.shape, generator=g, device=device,
                                      dtype=variants[0].dtype))
    vhw = torch.as_tensor(np.asarray(valid_hw, np.float32)).to(device)

    def timed_call(i):
        x = variants[i % len(variants)]
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            engine(x, vhw)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        engine(x, vhw)
        return (time.perf_counter() - t0) * 1e3

    for i in range(max(warmup_loops, len(variants))):
        engine(variants[i % len(variants)], vhw)
    if on_card:
        torch.cuda.synchronize(device)
    if timing_loops is None:
        est = max(float(np.mean([timed_call(i) for i in range(5)])) / 1e3, 1e-5)
        timing_loops = int(np.clip(target_s / est, 20, 1000))
    ms = np.asarray([timed_call(i) for i in range(int(timing_loops))]) / batch
    med = float(np.median(ms))
    return dict(
        ms_per_image=med,
        fps=1000.0 / med,
        ms_mean=float(ms.mean()),
        ms_min=float(ms.min()),
        ms_p25=float(np.percentile(ms, 25)),
        ms_p75=float(np.percentile(ms, 75)),
        ms_p95=float(np.percentile(ms, 95)),
        loops=int(timing_loops),
        method="cuda_events_per_call" if on_card else "perf_counter_per_call",
    )


def inference_latency_evaluation(
    detector,
    resolutions=((480, 640), (720, 1280), (1080, 1920), (2160, 3840)),
    precisions=("fp32", "bf16"),
    preprocess=None,
    batch_size=1,
    warmup_loops=10,
    timing_loops=300,
    size_divisor=None,
    verbose=True,
    device=None,
):
    """Resolution x precision latency sweep (the reference's
    `timing_inference_latency.py` benchmark across 640x480..4K): one engine
    per cell, built by compile_inference on `device` (the card unless the
    caller asks for another), timed by timing_inference on seeded uint8
    noise. Returns {(precision, (h, w)): timing_inference's dict}."""
    from .compile import compile_inference

    divisor = size_divisor or max(detector.point_strides)
    rng = np.random.RandomState(0)
    results = {}
    for precision in precisions:
        for (h, w) in resolutions:
            ph = (h + divisor - 1) // divisor * divisor
            pw = (w + divisor - 1) // divisor * divisor
            engine = compile_inference(
                detector, (ph, pw), precision=precision, preprocess=preprocess,
                batch_size=batch_size, device=device)
            images = rng.randint(0, 255, (batch_size, ph, pw, 3), dtype=np.uint8)
            r = timing_inference(engine, images, (h, w), warmup_loops, timing_loops)
            del engine  # a captured engine's graph and buffers go with it
            results[(precision, (h, w))] = r
            if verbose:
                print(
                    f"[{precision}] {w}x{h}: median {r['ms_per_image']:.2f} ms/image "
                    f"(IQR {r['ms_p25']:.2f}-{r['ms_p75']:.2f}), "
                    f"{r['fps']:.1f} FPS (end-to-end incl. decode+NMS, {r['method']})"
                )
    return results
