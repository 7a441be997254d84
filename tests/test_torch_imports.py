# The port stands alone: importing lfdtpu_torch (every module, the WIDERFACE
# workload's _common included) pulls in neither jax, flax, lfdtpu nor cv2,
# and the kernel modules import and run their plain versions on a machine
# with no nvcc and no GPU, building nothing. cv2 is imported only inside the
# functions that need it (JPEG coding, image paths, the pack checker).
import json
import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib.util, json, sys
import torch
torch.set_num_threads(1)
import lfdtpu_torch
from lfdtpu_torch import zoo
from lfdtpu_torch.data import (augmentation, dataset, dataset_samplers, device_aug, jpeg,
                               loader, pack, parsers, region_samplers, resize, sample)
from lfdtpu_torch.deploy import compile, kernel_net
from lfdtpu_torch.execution import (executor, hooks, jax_convert, optim, schedules,
                                    utils)
from lfdtpu_torch.ops import (assign, boxes, conv_kernels, decode, kernel_lib, loss_wrappers,
                              losses, nms, nms_kernel, points)
from lfdtpu_torch.parallel import data_parallel, prefetch
from lfdtpu_torch import device
from lfdtpu_torch.tools import kernel_trace
spec = importlib.util.spec_from_file_location(
    "widerface_common", "lfdtpu_torch/workloads/WIDERFACE_train/_common.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))

det = zoo.widerface_lfd("L")
det.init(torch.Generator().manual_seed(0))
eng = compile.compile_inference(
    det, (64, 64), "bf16", preprocess=compile.make_device_preprocess((0.5,) * 3, (0.5,) * 3),
    kernel_convs=True, kernel_stem=True, device="cpu")
out = eng(torch.zeros(1, 64, 64, 3, dtype=torch.uint8), [64, 64])
print(json.dumps({
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "lfdtpu", "cv2")),
    "built": kernel_lib.library.cache_info().currsize,
    "launches": [conv_kernels.stem_conv.launches, conv_kernels.pair_conv3x3.launches,
                 nms_kernel.nms_mask_sorted.launches],
    "count": int(out["count"][0]),
}))
"""


def test_port_imports_without_jax_and_builds_nothing_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PATH"] = os.pathsep.join(  # no nvcc anywhere on PATH
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc")))
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["foreign"] == [], res["foreign"]
    assert res["built"] == 0
    assert res["launches"] == [0, 0, 0]
    assert res["count"] >= 0


def test_no_source_file_imports_jax():
    pkg = os.path.join(ROOT, "lfdtpu_torch")
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|lfdtpu)\b", re.M)
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    offenders += [(f, m.group(0)) for m in bad.finditer(fh.read())]
    assert not offenders, offenders


def test_no_source_file_imports_cv2_at_module_level():
    pkg = os.path.join(ROOT, "lfdtpu_torch")
    bad = re.compile(r"^(import|from)\s+cv2\b", re.M)  # unindented: runs at import
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    offenders += [(f, m.group(0)) for m in bad.finditer(fh.read())]
    assert not offenders, offenders
