"""Where a block of K1, K2, K3 or K4 spends its cycles, on the card.

Builds `csrc/nms.cu`, `csrc/pair_conv.cu`, `csrc/stem_conv.cu`,
`csrc/int8_conv_wgmma32.cu`, `csrc/int8_conv_wgmma64.cu`,
`csrc/int8_conv_wgmma128.cu` or `csrc/int8_conv_stem.cu` (K4's routes of the
int8 chains, each called
through the C entry point its traced build exports) alone with
-DLFD_TRACE, which turns the kernel's LFD_TR(k) marks into clock64() stamps of
thread 0 of every block (`csrc/trace.cuh`), runs it at the engine's shapes and
prints, for each stamp, the median and largest cycle count since the block's
start over the blocks that reached it. For K1 (whose walk block stamps once
per 64-box chunk) it also prints the cycles of each chunk step. The traced
libraries go to `build/kernels/trace/`; the package's own library is
untouched.

    python3 -m lfdtpu_torch.tools.kernel_trace       # K1, K2, K3, K4
    python3 -m lfdtpu_torch.tools.kernel_trace k4    # K4 alone
"""

from __future__ import annotations

import ctypes
import subprocess

from lfdtpu_torch.ops import kernel_lib

SLOTS, BLOCKS = 32, 4096  # LFD_TRACE_SLOTS, LFD_TRACE_BLOCKS of csrc/trace.cuh
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K4's routes as C entry points of their traced builds (LFD_TRACED_ENTRY):
# x, w, mult, bias, residual, res_kind, res_scale, out, out_int8, inv_out,
# relu, N, H, W, then Cin, Cout, ksize, stride, Ho, Wo (wgmma) or Cout
# (stem), Kpad, stream
_K4_HEAD = (_P, _P, _P, _P, _P, _I, _F, _P, _I, _F, _I, _I, _I, _I)
_WGMMA = _K4_HEAD + (_I,) * 7 + (_P,)
SIGNATURES = dict(kernel_lib._SIGNATURES, lfd_int8_conv_wgmma32=_WGMMA,
                  lfd_int8_conv_wgmma64=_WGMMA, lfd_int8_conv_wgmma128=_WGMMA,
                  lfd_int8_conv_stem=_K4_HEAD + (_I, _I, _P))
# the names of a kernel's stamps: 0 and 1 before its loop, then
# 2 + len(per_item) i + k for its item, tile or chunk i
STAMPS = {
    "nms": ("entry", "chunk 0's words in", ("chunk done",)),
    "pair_conv": ("entry", "copies issued", ("window ready", "math done", "epilogue done")),
    "stem_conv": ("entry", "constants in", ("raw rows in", "strip normalized", "tile done")),
    "int8_conv_wgmma": ("entry", "copies issued", ("window ready", "math done",
                                                   "epilogue done")),
    "int8_conv_stem": ("entry", "constants in", ("raw rows in", "strip ready", "tile done")),
}
# K4's traced shapes, WIDERFACE-L's at 1088x1920, then WIDERFACE-XS's and
# TL-S's (768x1280) narrow ones: (label, N, H, W, Cin, Cout, k, stride, mode)
K4_TRACED = (
    ("stage 0 3x3 64->64", 1, 272, 480, 64, 64, 3, 1, "a"),
    ("stage 0 3x3 64->64, int8 residual", 1, 272, 480, 64, 64, 3, 1, "c8"),
    ("s0.0 conv1 3x3/s2", 1, 544, 960, 64, 64, 3, 2, "a"),
    ("s0.0 shortcut 1x1/s2, f32 out", 1, 544, 960, 64, 64, 1, 2, "b"),
    ("stem1 1x1 64->64", 1, 544, 960, 64, 64, 1, 1, "a"),
    ("neck 1x1 64->128", 1, 272, 480, 64, 128, 1, 1, "a"),
    ("stage 4 3x3 128->128, f32 residual", 1, 17, 30, 128, 128, 3, 1, "cf"),
    ("stem0 3x3/s2 3->64", 1, 1088, 1920, 3, 64, 3, 2, "a"),
    ("XS stem1 1x1 32->32", 1, 544, 960, 32, 32, 1, 1, "a"),
    ("XS stem2 3x3/s2 32->32", 1, 544, 960, 32, 32, 3, 2, "a"),
    ("TL-S stage 0 3x3 48->48", 1, 192, 320, 48, 48, 3, 1, "a"),
    ("TL-S stage 0 3x3 48->48, int8 residual", 1, 192, 320, 48, 48, 3, 1, "c8"),
    ("XS stem0 3x3/s2 3->32", 1, 1088, 1920, 3, 32, 3, 2, "a"),
    ("TL-S stem0 3x3/s2 3->48", 1, 768, 1280, 3, 48, 3, 2, "a"),
)


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
    getattr(lib, entry).argtypes = list(SIGNATURES[entry])
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


def k4_case(dev, g, n, h, w, cin, cout, k, stride, mode):
    """Seeded inputs of one K4 call, as the wrapper's keyword arguments."""
    import torch

    from lfdtpu_torch.ops import int8_conv as k4

    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, device=dev, dtype=torch.int8)
    q, w_scale = k4.quantize_weights(torch.randn(cout, cin, k, k, generator=g, device=dev))
    ho, wo = k4.out_hw(h, w, k, stride)
    call = dict(x=x, wpack=k4.pack_int8_weight(q), mult=(w_scale * 0.02 / (cin * k * k) ** 0.5)
                .float().contiguous(), bias=torch.randn(cout, generator=g, device=dev) * 0.1,
                kernel_size=k, stride=stride, relu=mode == "a", out_scale=None if mode == "b"
                else 0.02)
    if mode == "c8":
        call["residual"] = torch.randint(-127, 128, (n, ho, wo, cout), generator=g, device=dev,
                                         dtype=torch.int8)
        call["residual_scale"] = 0.013
    elif mode == "cf":
        call["residual"] = torch.randn(n, ho, wo, cout, generator=g, device=dev)
    return call


def trace_k4(dev, stream):
    """K4's wgmma and stem routes at WIDERFACE-L's main shapes (K4_TRACED),
    each traced launch held equal to the package's K4."""
    import numpy as np
    import torch

    from lfdtpu_torch.ops import int8_conv as k4

    libs = {f"wgmma{row}": build(f"int8_conv_wgmma{row}", f"lfd_int8_conv_wgmma{row}")
            for row in (32, 64, 128)}
    libs["stem"] = build("int8_conv_stem", "lfd_int8_conv_stem")
    g = torch.Generator(device=dev).manual_seed(4)
    for label, n, h, w, cin, cout, k, stride, mode in K4_TRACED:
        c = k4_case(dev, g, n, h, w, cin, cout, k, stride, mode)
        ho, wo = k4.out_hw(h, w, k, stride)
        out = torch.empty((n, ho, wo, cout), device=dev,
                          dtype=torch.float32 if mode == "b" else torch.int8)
        res = c.get("residual")
        head = (c["x"].data_ptr(), c["wpack"].data_ptr(), c["mult"].data_ptr(),
                c["bias"].data_ptr(), None if res is None else res.data_ptr(),
                {"c8": 1, "cf": 2}.get(mode, 0), float(np.float32(c.get("residual_scale") or 0)),
                out.data_ptr(), int(mode != "b"), 0.0 if mode == "b" else float(np.float32(50.0)),
                int(c["relu"]))
        route = k4.route_of(cin, cout, k, stride)
        if route == "wgmma":
            row = k4.cin_pad(cin)  # the tap row: 32, 64 (Cin 48, 64) or 128
            lib = libs[f"wgmma{row}"]
            entry = getattr(lib, f"lfd_int8_conv_wgmma{row}")
            run(lib, lambda: entry(*head, n, h, w, cin, cout, k, stride, ho, wo,
                                   c["wpack"].shape[1], stream))
        else:
            lib = libs[route]
            run(lib, lambda: lib.lfd_int8_conv_stem(*head, n, h, w, cout, c["wpack"].shape[1],
                                                    stream))
        if not torch.equal(out, k4.int8_conv(**c)):
            raise RuntimeError(f"the traced K4 differs from the package's at {label}")
        report(lib, f"int8_conv_{route}", f"{n}x{h}x{w}x{cin} -> {cout} {k}x{k}/s{stride} "
               f"mode {mode} ({label})")


def main():
    import sys

    import torch

    from lfdtpu_torch.ops.conv_kernels import pair_conv3x3, stem_conv

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    if sys.argv[1:] == ["k4"]:  # K4 alone
        trace_k4(dev, stream)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
              .stdout.strip())
        return
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
    trace_k4(dev, stream)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
