"""The extra memory and time of one fp32 conv call by input shape, on the card:
cuDNN's (through nn.Conv2d, TF32 off, its heuristics' engine) beside the
spatial module's row-chunked im2col GEMM (parallel/spatial.py::_conv_rows)
on the same input.

cuDNN's heuristics pick an engine by shape. For some fp32 3x3/s1 64->64
shapes they pick one with a workspace of 0.5-2.1 GiB that also runs far
slower, with no rule in the shape that a caller could follow: the sweep
prints, for each conv and width, the heights where that happens (extra
memory above 4x the input plus 8 MiB). The named shapes are the strips a
spatial rank of WIDERFACE-L runs (3840x2160 on spatial 2: 68 and 69 rows of
stage 2, 240 wide; 1088x1920: 69 rows of stage 1) and the whole maps one
process runs.

    python3 -m lfdtpu_torch.tools.cudnn_workspace            # named shapes and the sweep
    python3 -m lfdtpu_torch.tools.cudnn_workspace --named    # the named shapes alone
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from lfdtpu_torch.parallel.spatial import _conv_rows

# (in, out, kernel, stride): the sweep's convs, its widths and heights
SWEEP = (((64, 64, 3, 1), (30, 60, 120, 240, 480, 960), range(4, 280)),
         ((128, 128, 3, 1), (15, 30, 60, 120, 240), range(4, 140)),
         ((64, 64, 3, 2), (120, 240, 480, 960, 1920), range(8, 560)),
         ((64, 128, 3, 2), (30, 60, 120, 240, 480), range(8, 280)),
         ((128, 128, 3, 2), (15, 30, 60, 120, 240), range(8, 140)))
# 3x3/s1 64->64 inputs (height, width): a spatial rank's strips, then whole maps
NAMED = ((69, 240), (68, 240), (135, 240), (69, 120), (68, 120), (136, 240), (271, 960),
         (540, 960))


def _conv(cin, cout, k, s, device):
    g = torch.Generator().manual_seed(cin * 1000 + cout * 10 + k + s)
    conv = torch.nn.Conv2d(cin, cout, k, s, k // 2, bias=False).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
    return conv.to(device=device, memory_format=torch.channels_last)


def extra(fn, x, reps=0):
    """(MiB the call allocates above its output at its peak, ms a call over
    `reps` calls after it, or None)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        y = fn(x)
    torch.cuda.synchronize()
    mib = (torch.cuda.max_memory_allocated() - base - y.numel() * y.element_size()) / 2 ** 20
    ms = None
    if reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            start.record()
            for _ in range(reps):
                fn(x)
            end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    return mib, ms


def _input(c, h, w, device, g):
    return torch.randn((1, c, h, w), device=device, generator=g).contiguous(
        memory_format=torch.channels_last)


def named(device="cuda", reps=20):
    """[(height, width, cuDNN (MiB, ms), the GEMM (MiB, ms))] for NAMED."""
    conv = _conv(64, 64, 3, 1, device)
    g = torch.Generator(device=device).manual_seed(0)
    rows = []
    for h, w in NAMED:
        x = _input(64, h, w, device, g)
        rows.append((h, w, extra(conv, x, reps),
                     extra(lambda t: _conv_rows(conv, t, 0, h), x, reps)))
    return rows


def sweep(device="cuda"):
    """{(in, out, kernel, stride): {width: [(height, MiB)]}}: the shapes
    where cuDNN's call takes more than 4x its input plus 8 MiB."""
    g = torch.Generator(device=device).manual_seed(0)
    out = {}
    for (cin, cout, k, s), widths, heights in SWEEP:
        conv = _conv(cin, cout, k, s, device)
        big = out.setdefault((cin, cout, k, s), {})
        for w in widths:
            for h in heights:
                mib, _ = extra(conv, _input(cin, h, w, device, g))
                if mib > 4 * cin * h * w * 4 / 2 ** 20 + 8:
                    big.setdefault(w, []).append((h, round(mib, 1)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--named", action="store_true", help="the named shapes alone")
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"fp32, TF32 off, 3x3/s1 64->64, batch 1, channels_last [{card}]")
    rows = named()
    for h, w, (cm, cms), (gm, gms) in rows:
        print(f"  {h}x{w}: cuDNN +{cm:.1f} MiB {cms:.4f} ms; the strip GEMM +{gm:.1f} MiB "
              f"{gms:.4f} ms")
    result = dict(card=card, named=[dict(h=h, w=w, cudnn=c, gemm=g) for h, w, c, g in rows])
    if not args.named:
        t0 = time.time()
        big = sweep()
        for (cin, cout, k, s), by_width in big.items():
            print(f"{cin}->{cout} {k}x{k}/s{s}: "
                  + ("; ".join(f"width {w}: {len(v)} heights, {v[0][0]}-{v[-1][0]}, "
                               f"+{min(m for _, m in v):.0f} to +{max(m for _, m in v):.0f} MiB"
                               for w, v in by_width.items()) or "no shape above 4x its input"))
        print(f"sweep {time.time() - t0:.1f} s")
        result["sweep"] = {f"{cin}->{cout} {k}x{k}/s{s}": by_width
                           for (cin, cout, k, s), by_width in big.items()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
