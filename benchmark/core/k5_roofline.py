"""K5's yardstick (GroupNorm + ReLU, lfdtpu_torch/csrc/group_norm.cu), beside
benchmark/core/roofline.py, which holds K1-K3's: what one launch must move,
and the least time an H100 could take for it. The map is read twice
(statistics, then normalize) and written once, the affine parameters read
once, at 3.35 TB/s; its operations (a few a value) are far below the bf16
peak's share, so bytes bound it.

A served FCOS-R50-FPN frame launches K5 on every GroupNorm -> ReLU pair of
its two towers at every level: 2 x conv_layers x 5 launches, each over the
level's whole (1, h, w, 256) bf16 map.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

KERNEL_NAMES = ("group_norm_stats_kernel", "group_norm_relu_kernel")


def k5_bytes(n, h, w, c):
    """Bytes of one launch over an (n, h, w, c) bf16 map and its float32
    gamma and beta."""
    return 3 * n * h * w * c * 2 + 2 * c * 4


def frame_launches(cfg, pad, batch=1):
    """[(n, h, w, c)] of one served call's K5 launches at the padded size."""
    h = cfg["head"]
    out = []
    for s in cfg["strides"]:
        shape = (batch, -(-pad[0] // s), -(-pad[1] // s), h["channels"])
        out += [shape] * (2 * h["conv_layers"])
    return out


def frame_bound_s(cfg, pad, batch=1):
    """Seconds of the bound of one call's K5 launches, summed."""
    return sum(k5_bytes(*shape) for shape in frame_launches(cfg, pad, batch)) / HBM_BYTES_PER_S


def share(run):
    """% of roofline of K5: its bound for the calls in the profiled segment
    over the two kernels' profiled time. The normalize kernel is a
    programmatic dependent launch whose span starts while the statistics
    end, so that overlap counts twice and the share reads low, never high."""
    seg, bound = run.get("segment"), run.get("k5_bound_s")
    if not seg or not bound or not seg["calls"]:
        return None
    spent = sum(v for k, v in seg["ops"].items() if any(n in k for n in KERNEL_NAMES))
    return 100.0 * bound * seg["calls"] / spent if spent > 0 else None
