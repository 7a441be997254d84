"""Where a block of K1, K2 or K3 spends its cycles, on the card.

Builds `csrc/nms.cu`, `csrc/pair_conv.cu` or `csrc/stem_conv.cu` alone with
-DLFD_TRACE, which turns the kernel's LFD_TR(k) marks into clock64() stamps of
thread 0 of every block (`csrc/trace.cuh`), runs it at the engine's shapes and
prints, for each stamp, the median and largest cycle count since the block's
start over the blocks that reached it. For K1 (whose walk block stamps once
per 64-box chunk) it also prints the cycles of each chunk step. The traced
libraries go to `build/kernels/trace/`; the package's own library is
untouched.

    python3 -m lfdtpu_torch.tools.kernel_trace
"""

from __future__ import annotations

import ctypes
import subprocess

from lfdtpu_torch.ops import kernel_lib

SLOTS, BLOCKS = 32, 4096  # LFD_TRACE_SLOTS, LFD_TRACE_BLOCKS of csrc/trace.cuh
# the names of a kernel's stamps: 0 and 1 before its loop, then
# 2 + len(per_item) i + k for its item, tile or chunk i
STAMPS = {
    "nms": ("entry", "chunk 0's words in", ("chunk done",)),
    "pair_conv": ("entry", "copies issued", ("window ready", "math done", "epilogue done")),
    "stem_conv": ("entry", "constants in", ("raw rows in", "strip normalized", "tile done")),
}


def slot_names(kernel):
    first, second, per_item = STAMPS[kernel]
    return [first, second] + [f"{name} {i}" for i in range((SLOTS - 2) // len(per_item))
                              for name in per_item]


def build(kernel, entry):
    """Compile one kernel's source with its stamps; returns the loaded library
    with its C entry point `entry` typed as the package's."""
    so = kernel_lib.BUILD_DIR / "trace" / f"lib{kernel}_trace.so"
    kernel_lib.compile_sources([kernel_lib.CSRC_DIR / f"{kernel}.cu"], so, "-DLFD_TRACE")
    lib = ctypes.CDLL(str(so))
    getattr(lib, entry).argtypes = list(kernel_lib._SIGNATURES[entry])
    getattr(lib, entry).restype = ctypes.c_int
    lib.lfd_trace_read.argtypes = [ctypes.c_void_p]
    lib.lfd_trace_clear.argtypes = []
    lib.lfd_trace_read.restype = lib.lfd_trace_clear.restype = ctypes.c_int
    return lib


def report(lib, kernel, label):
    """Prints the stamps; returns the blocks' cycles since their start."""
    import numpy as np

    t = np.zeros(BLOCKS * SLOTS, np.int64)
    if lib.lfd_trace_read(t.ctypes.data) != 0:
        raise RuntimeError("reading the trace failed")
    t = t.reshape(BLOCKS, SLOTS)
    t = t[t[:, 0] != 0]
    rel = t - t[:, :1]
    print(f"{kernel} {label}: {len(t)} blocks, cycles since the block's start")
    for k, name in enumerate(slot_names(kernel)):
        ok = t[:, k] != 0
        if ok.any():
            print(f"  {name:20s} median {np.median(rel[ok, k]):9.0f}  max {rel[ok, k].max():9.0f}"
                  f"  ({ok.sum()} blocks)")
    return np.where(t != 0, rel, -1)


def run(lib, launch):
    """Three launches, the stamps of the last one kept."""
    import torch

    for _ in range(3):
        if lib.lfd_trace_clear() != 0:
            raise RuntimeError("clearing the trace failed")
        rc = launch()
        if rc != 0:
            raise RuntimeError(f"traced launch failed: CUDA error {rc}")
    torch.cuda.synchronize()


def k1_inputs(dev, g, K=1000):
    """K1's traced inputs, B=1: random boxes drawn the way chip_smoke.py
    phase 7 draws them (rand*500, about 30% kept; another seed), and the
    walk's all-kept and chain cases (`nms_kernel.walk_cases`)."""
    import torch

    from lfdtpu_torch.ops import nms_kernel

    rand = torch.rand(1, K, 4, generator=g, device=dev) * 500
    rand[..., 2:] += rand[..., :2]
    cases = nms_kernel.walk_cases(1, K)
    return {"random boxes (rand*500)": rand,
            "all kept": cases["all kept"][0].to(dev), "chain": cases["chain"][0].to(dev)}


def trace_k1(dev, stream):
    """K1 at B=1, K=1000, thr 0.4: the walk's cycles per 64-box chunk step
    on each input."""
    import numpy as np
    import torch

    from lfdtpu_torch.ops import nms_kernel

    lib = build("nms", "lfd_nms_mask_sorted")
    g = torch.Generator(device=dev).manual_seed(3)
    for label, boxes in k1_inputs(dev, g).items():
        B, K = boxes.shape[:2]
        valid = torch.ones(B, K, dtype=torch.bool, device=dev)
        keep = torch.empty(B, K, dtype=torch.bool, device=dev)
        scratch = torch.empty(nms_kernel.scratch_words(B, K), dtype=torch.int64, device=dev)
        run(lib, lambda: lib.lfd_nms_mask_sorted(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
            B, K, 0.4, stream))
        if not torch.equal(keep, nms_kernel.nms_mask_sorted(boxes, valid, 0.4)):
            raise RuntimeError("the traced K1 differs from the package's")
        rel = report(lib, "nms", f"B={B} K={K} {label}, {int(keep.sum())} kept")
        chunks = (K + 63) // 64
        done = rel[:, 2:2 + chunks]
        steps = np.diff(done, axis=1)[(done[:, 1:] >= 0) & (done[:, :-1] >= 0)]
        print(f"  chunk steps 1..{chunks - 1}: median {np.median(steps):.0f}, min {steps.min()}, "
              f"max {steps.max()} cycles; chunk 0 done at {np.median(done[:, 0]):.0f}, "
              f"{np.median(done[:, 0] - rel[:, 1]):.0f} after its words came in")


def main():
    import torch

    from lfdtpu_torch.ops.conv_kernels import pair_conv3x3, stem_conv

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    trace_k1(dev, stream)
    lib = build("pair_conv", "lfd_pair_conv3x3")
    w = (torch.randn(3, 3, 64, 64, generator=g, device=dev) * 0.05).bfloat16()
    s = torch.rand(64, generator=g, device=dev) + 0.5
    b = torch.randn(64, generator=g, device=dev) * 0.1
    for hw in ((272, 480), (136, 240), (68, 120)):
        x = torch.randn(1, *hw, 64, generator=g, device=dev).bfloat16()
        out = torch.empty_like(x)
        run(lib, lambda: lib.lfd_pair_conv3x3(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                              b.data_ptr(), x.data_ptr(), out.data_ptr(), 1,
                                              *hw, 1, stream))
        if not torch.equal(out, pair_conv3x3(x, w, s, b, residual=x)):
            raise RuntimeError("the traced K3 differs from the package's")
        report(lib, "pair_conv", f"1x{hw[0]}x{hw[1]}x64 +residual")
    lib = build("stem_conv", "lfd_stem_conv")
    frame = torch.randint(0, 256, (1, 1088, 1920, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    w2 = torch.randn(3, 3, 3, 64, generator=g, device=dev) * 0.2
    mean = torch.tensor([127.5] * 3, device=dev)
    std = torch.tensor([127.5] * 3, device=dev)
    out = torch.empty(1, 544, 960, 64, dtype=torch.bfloat16, device=dev)
    run(lib, lambda: lib.lfd_stem_conv(frame.data_ptr(), w2.data_ptr(), mean.data_ptr(),
                                       std.data_ptr(), s.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), 1, 1088, 1920, 1, stream))
    if not torch.equal(out, stem_conv(frame, w2, mean, std, s, b)):
        raise RuntimeError("the traced K2 differs from the package's")
    report(lib, "stem_conv", "1x1088x1920x3")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
