# The port stands alone: importing lfdtpu_torch (every module, the FCOS
# family's and the int8 engine's included, and every script of the
# WIDERFACE, TT100K and TrafficLight workloads, and the synthetic learning
# tools) and predicting with an LFD (bf16 and int8 engines) and an FCOS, and
# the host and multiclass NMS, pulls in
# neither jax, flax, lfdtpu nor cv2,
# and the kernel modules import and run their plain versions on a machine
# with no nvcc and no GPU, building nothing. cv2 is imported only inside the
# functions that need it (JPEG coding, image paths, the pack checker). The
# serving layer (engine_io, serving, buckets) imports neither jax nor lfdtpu,
# and a process that imports only engine_io (and serving) to serve an engine
# file imports none of the port's model code (lfdtpu_torch.models, .zoo).
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
from lfdtpu_torch.deploy import (buckets, compile, engine_io, int8_net, kernel_net, latency,
                                 quantize, runner, serving)
from lfdtpu_torch.evaluation import base, coco_eval, tt100k, widerface
from lfdtpu_torch.execution import (executor, hooks, jax_convert, optim, schedules,
                                    torch_convert, utils)
from lfdtpu_torch.ops import (assign, boxes, conv_kernels, decode, int8_conv, kernel_lib,
                              loss_wrappers, losses, nms, nms_kernel, points)
from lfdtpu_torch.parallel import data_parallel, distributed, mesh, prefetch, spatial
from lfdtpu_torch import device
from lfdtpu_torch.models import fcos, heads, lfdv2, necks, resnet
from lfdtpu_torch.tools import int8_quality_cell, kernel_trace, synthetic_e2e
common = ("_common", "predict", "predict_engine", "evaluation", "timing_inference_latency")
for task, scripts in (
        ("WIDERFACE_train", common + ("pack_widerface", "generate_neg_images")),
        ("TT100K_train", common + ("pack_tt100k", "generate_neg_images",
                                   "TT100K_augmentation_pipeline")),
        ("TrafficLight_train", common + ("pack_TL", "EDA", "TL_augmentation_pipeline"))):
    for script in scripts:
        spec = importlib.util.spec_from_file_location(
            task + "_" + script, "lfdtpu_torch/workloads/" + task + "/" + script + ".py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))

det = zoo.widerface_lfd("L")
det.init(torch.Generator().manual_seed(0))
eng = compile.compile_inference(
    det, (64, 64), "bf16", preprocess=compile.make_device_preprocess((0.5,) * 3, (0.5,) * 3),
    kernel_convs=True, kernel_stem=True, device="cpu")
out = eng(torch.zeros(1, 64, 64, 3, dtype=torch.uint8), [64, 64])
timing = latency.timing_inference(eng, torch.zeros(1, 64, 64, 3, dtype=torch.uint8).numpy(),
                                  [64, 64], warmup_loops=1, timing_loops=2, distinct_inputs=2)
eng8 = compile.compile_inference(
    det, (64, 64), "int8", preprocess=compile.make_device_preprocess((0.5,) * 3, (0.5,) * 3),
    device="cpu")
out8 = eng8(torch.zeros(1, 64, 64, 3, dtype=torch.uint8), [64, 64])
rows = det.get_results(torch.zeros(1, 64, 64, 3), [None])
rn = resnet.ResNet(depth=18, base_channels=8, out_indices=((2, 1), (3, 1), (4, 1)))
fdet = fcos.FCOS(rn, necks.FPN(rn.num_output_channels_list, rn.num_output_strides_list, 16, 5),
                 heads.FCOSHead(2, 16, 5, 16, 1), num_classes=2)
fdet.init(torch.Generator().manual_seed(0))
fcos_rows = fdet.predict_for_single_image(torch.zeros(60, 70, 3).numpy())
from lfdtpu_torch import ops
mc_keep, _, mc_count = ops.multiclass_nms(torch.tensor([[0., 0, 10, 10], [1, 1, 11, 11]]),
                                          torch.tensor([0.9, 0.8]), 0.05, 0.5)
host_kept = ops.nms(ops.soft_nms(torch.zeros(0, 5).numpy(), 0.5)[0], 0.5)[1]
print(json.dumps({
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "lfdtpu", "cv2")),
    "built": kernel_lib.library.cache_info().currsize,
    "launches": [conv_kernels.stem_conv.launches, conv_kernels.pair_conv3x3.launches,
                 nms_kernel.nms_mask_sorted.launches, int8_conv.int8_conv.launches],
    "int8_units": len(eng8.int8_chain.units),
    "count8": int(out8["count"][0]),
    "count": int(out["count"][0]),
    "captured": eng.captured,
    "method": timing["method"],
    "result_lists": len(rows),
    "fcos_rows": isinstance(fcos_rows, list),
    "fcos_launches": nms_kernel.nms_mask_sorted.launches,
    "multiclass_nms": [mc_keep.tolist(), int(mc_count), len(host_kept)],
    "scenes": synthetic_e2e.scenes(zoo_model="WIDERFACE-L")[2],
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
    assert res["launches"] == [0, 0, 0, 0]
    assert res["int8_units"] == 32 and res["count8"] >= 0
    assert res["count"] >= 0
    assert res["captured"] is False and res["method"] == "perf_counter_per_call"
    assert res["result_lists"] == 1
    assert res["fcos_rows"] and res["fcos_launches"] == 0
    assert res["multiclass_nms"] == [[True, False], 1, 0] and res["scenes"] == 1


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


_SERVE_PROBE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from lfdtpu_torch.deploy import engine_io, serving
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "lfdtpu", "cv2")
                        or m.startswith(("lfdtpu_torch.models", "lfdtpu_torch.zoo")))))
"""


def test_engine_io_imports_no_model_code():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", _SERVE_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
