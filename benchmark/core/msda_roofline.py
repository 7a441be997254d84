"""The yardstick of multi-scale deformable attention's sampling
(lfdtpu_torch/ops/msda.py::ms_deform_attn, a later hand-written kernel's
function), beside benchmark/core/roofline.py and k5_roofline.py: what one
call must move, whatever implements it, and the least time an H100 could
take for it. A call reads the bf16 value map once (tokens x 256 x 2 bytes),
12 bytes a sample (float32 x, y and weight) and writes the bf16 output once
(queries x 256 x 2); its operations (a few a sampled channel) are far below
the peak's share, so bytes bound it, at 3.35 TB/s.

A served Deformable DETR frame calls it 12 times: each encoder layer with
every token as a query, each decoder layer with the 300 queries, over the
tokens of the 4 levels (strides 8, 16, 32 and 64 of the frame, each a ceil
of halvings: 16,700 + 4,200 + 1,050 + 273 = 22,223 at 800x1333).
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S

SAMPLE_BYTES = 12   # float32 x, y and weight
VALUE_BYTES = 2     # bf16 value map and output


def level_shapes(hw, levels=4):
    """The (h, w) of the levels at a frame of hw: ResNet's stride-2 stem,
    pool and stages (each a ceil of a halving) to stride 8, then one
    halving a level."""
    h, w = hw
    out = []
    for i in range(2 + levels):
        h, w = -(-h // 2), -(-w // 2)
        if i >= 2:
            out.append((h, w))
    return out


def call_bytes(tokens, queries, t):
    samples = queries * t["heads"] * t["levels"] * t["points"]
    return (tokens + queries) * t["embed_dims"] * VALUE_BYTES + samples * SAMPLE_BYTES


def frame_calls(cfg, hw):
    """[(value tokens, queries)] of one frame's calls."""
    t = cfg["transformer"]
    tokens = sum(h * w for h, w in level_shapes(hw, t["levels"]))
    return [(tokens, tokens)] * t["encoder_layers"] + \
        [(tokens, cfg["num_queries"])] * t["decoder_layers"]


def frame_samples(cfg, hw):
    t = cfg["transformer"]
    return sum(q for _, q in frame_calls(cfg, hw)) * t["heads"] * t["levels"] * t["points"]


def frame_bound_s(cfg, hw):
    """Seconds of the bound of one frame's calls, summed."""
    t = cfg["transformer"]
    return sum(call_bytes(s, q, t) for s, q in frame_calls(cfg, hw)) / HBM_BYTES_PER_S


def share(run):
    """% of roofline: the frame's bound over the measured ms of its calls
    replayed alone (engine.msda_ms)."""
    bound, ms = run.get("msda_bound_s"), run.get("msda_ms")
    return 100.0 * bound * 1e3 / ms if bound and ms else None
