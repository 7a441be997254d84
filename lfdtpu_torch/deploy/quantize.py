# INT8 quantization tools (`lfdtpu/deploy/quantize.py`, reference
# `lfd/deployment/tensorrt/build_engine.py:22-71`, INT8Calibrator).
#
# quantize_net_int8 is the light fake-quant tool: a copy of the net whose
# conv weights carry int8 precision loss and run through the normal float
# engine. The true int8 path (int8 x int8 -> int32 convs, per-channel weight
# scales, calibrated static activation scales) is deploy/int8_net.py, what
# compile_inference(precision="int8") builds.

from __future__ import annotations

import copy
import os

import numpy as np
import torch
from torch import nn


def quantize_net_int8(net, per_channel=True):
    """A copy of `net` whose every 4-D conv weight is quantized to int8 and
    dequantized back (fake-quant), in the weight's own dtype
    (`quantize.py:28-48`): per output channel, the amax is taken over torch
    dims (1, 2, 3), lfdtpu's HWIO axes (0, 1, 2); else over the whole
    weight. scale = max(amax, 1e-8) / 127, w = clip(round(w / scale)) * scale."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        for m in out.modules():
            if isinstance(m, nn.Conv2d) and m.weight.ndim == 4:
                w = m.weight
                amax = (w.abs().amax(dim=(1, 2, 3), keepdim=True) if per_channel
                        else w.abs().amax())
                scale = amax.clamp_min(1e-8) / 127.0
                q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
                w.copy_(q.to(w.dtype) * scale)
    return out


class Int8Calibrator:
    """Collects the input's activation range over real batches and caches it
    (`quantize.py:51-87`, the reference's `build_engine.py:22-71`). The cache
    is lfdtpu's: one float32 amax written by np.save, so a cache written by
    either package loads in the other.

    Usage:
        calib = Int8Calibrator(cache_path)
        if not calib.has_cache():
            for batch in crops: calib.update(batch)  # batch: (B, H, W, C)
            calib.save()
        amax = calib.input_amax
    """

    def __init__(self, cache_file=None):
        self._cache_file = cache_file
        self._amax = 0.0
        self._count = 0
        if cache_file is not None and os.path.exists(cache_file):
            self._amax = float(np.load(cache_file))
            self._count = 1

    def has_cache(self):
        return self._count > 0 and self._cache_file is not None

    def update(self, batch):
        self._amax = max(self._amax, float(np.max(np.abs(batch))))
        self._count += 1

    def save(self):
        if self._cache_file is not None:
            np.save(self._cache_file, np.float32(self._amax))

    @property
    def input_amax(self):
        return self._amax
