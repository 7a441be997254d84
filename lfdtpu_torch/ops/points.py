# Point-grid generation for anchor-free dense detection.
#
# Reference behavior: every feature-map location (i, j) of a level with stride
# `s` maps to image coordinates (j*s, i*s) — NO half-stride offset
# (reference `lfd/model/lfd.py:84-107`, `lfd/model/fcos.py:96-97`).
#
# Point grids, per-point strides and regression ranges are static functions
# of the (padded) input resolution, so they are computed once with numpy and
# uploaded once per engine (a copy of `lfdtpu/ops/points.py`, which cannot be
# imported without jax).

from __future__ import annotations

import numpy as np


def feature_map_sizes_for_input(input_hw, strides):
    """Compute per-level feature-map (h, w) for a given input size.

    Every conv in the LFD family is shape-preserving ('SAME'); each stride-2
    stage therefore produces ceil(h/2) — the same analytic rule the reference
    uses for its TensorRT path (`lfd/model/lfd.py:712-720`).
    """
    h, w = int(input_hw[0]), int(input_hw[1])
    sizes = []
    for s in strides:
        s = int(s)
        sizes.append(((h + s - 1) // s, (w + s - 1) // s))
    return tuple(sizes)


def generate_point_coordinates(feature_map_sizes, strides, dtype=np.float32):
    """Per-level point coordinate arrays.

    Returns a list of (H*W, 2) float arrays of [x, y] image coordinates in
    row-major (y-outer) order, matching the NCHW->(H*W) flattening of head
    outputs (reference `lfd/model/lfd.py:91-107`).
    """
    assert len(feature_map_sizes) == len(strides)
    out = []
    for (h, w), s in zip(feature_map_sizes, strides):
        xs = np.arange(w, dtype=dtype) * s
        ys = np.arange(h, dtype=dtype) * s
        xg, yg = np.meshgrid(xs, ys)  # (h, w) each; x varies fastest
        out.append(np.stack([xg.reshape(-1), yg.reshape(-1)], axis=-1))
    return out


def concat_level_info(
    feature_map_sizes,
    strides,
    regression_ranges,
    gray_ranges=None,
    dtype=np.float32,
):
    """Concatenate per-level constants across levels.

    Returns a dict of numpy arrays (all length P = sum of level sizes):
      points      (P, 2) [x, y]
      strides     (P,)
      ranges      (P, 2) regression range (low, up) of the owning level
      gray_ranges (P, 2) gray ignore band of the owning level (if given)
      level_ids   (P,)   int32 owning level index
    These are trace-time constants for any fixed input resolution.
    """
    pts = generate_point_coordinates(feature_map_sizes, strides, dtype)
    sizes = [p.shape[0] for p in pts]
    points = np.concatenate(pts, axis=0)
    stride_arr = np.concatenate(
        [np.full((n,), s, dtype=dtype) for n, s in zip(sizes, strides)]
    )
    range_arr = np.concatenate(
        [np.tile(np.asarray(r, dtype=dtype)[None, :], (n, 1)) for n, r in zip(sizes, regression_ranges)]
    )
    level_ids = np.concatenate(
        [np.full((n,), i, dtype=np.int32) for i, n in enumerate(sizes)]
    )
    info = dict(points=points, strides=stride_arr, ranges=range_arr, level_ids=level_ids)
    if gray_ranges is not None:
        info["gray_ranges"] = np.concatenate(
            [np.tile(np.asarray(g, dtype=dtype)[None, :], (n, 1)) for n, g in zip(sizes, gray_ranges)]
        )
    return info


def compute_gray_ranges(regression_ranges, gray_range_factors):
    """Gray ignore bands, int-truncated like the reference (`lfd.py:48-49`)."""
    lo_f, up_f = min(gray_range_factors), max(gray_range_factors)
    return tuple(
        (int(low * lo_f), int(up * up_f)) for (low, up) in regression_ranges
    )
