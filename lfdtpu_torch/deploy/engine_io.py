# Engine files: build once, write to disk, serve from the file in a process
# that never builds the model (`lfdtpu/deploy/engine_io.py`, the counterpart
# of the reference's TensorRT engine files: `build_engine.py:141-152`
# serializes the built engine, `predict_tensorrt.py` deserializes it).
#
# The file is a zip of two members:
#   meta.json    the port's magic string, the precision, input resolution,
#                batch size, valid-extent and frame shapes, pack_output,
#                output_dtype, the kernel-stem flag, the device it was built
#                on, the TF32 switches its float32 math ran under, the torch
#                version that wrote it, and the lfd ops the program calls
#                (with their counts);
#   program.pt2  the torch.export archive of Engine.program (the engine's
#                whole device side: preprocess, net or int8 chain, decode,
#                NMS, pack, cast), its weights as raw bytes.
# The program is stored on the CPU and moved to the loading device with
# move_to_device_pass. The hand-written kernels are custom ops
# (torch.ops.lfd.*, registered by the ops modules this module imports), so
# the loaded program launches them as the built engine does.
#
# Loading runs no pickle: the archive is checked to hold raw tensor bytes
# only, and is saved without its sample inputs (torch.export would unpickle
# those). A loaded engine runs under the file's TF32 switches, not the
# loading process's, so its float32 math is the built engine's. A file
# written by another torch version loads with a warning: torch.export does
# not promise its archives across versions. This module imports no model
# code (neither lfdtpu_torch.models nor lfdtpu_torch.zoo): the file is
# self-contained.

from __future__ import annotations

import io
import json
import warnings
import zipfile

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from ..device import resolve_device
from ..ops import (conv_kernels, group_norm, int8_conv,  # noqa: F401  (register torch.ops.lfd)
                   nms_kernel)
from .runner import GraphRunner

MAGIC = "lfdtpu-torch-engine-v1"
_DTYPE_NAMES = {torch.float16: "float16", torch.bfloat16: "bfloat16", torch.uint8: "uint8",
                torch.float32: "float32"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def lfd_ops(program):
    """{op name: calls} of the torch.ops.lfd.* nodes of an exported program."""
    counts = {}
    for node in program.graph.nodes:
        target = node.target
        if (node.op == "call_function" and isinstance(target, torch._ops.OpOverload)
                and target.namespace == "lfd"):
            counts[target.name()] = counts.get(target.name(), 0) + 1
    return dict(sorted(counts.items()))


def export_engine(engine):
    """The engine's program (torch.export.ExportedProgram of
    Engine.program on Engine.example_args), traced on its device."""
    with torch.no_grad():
        return torch.export.export(engine.program, engine.example_args(), strict=False)


def save_engine(engine, path):
    """Serialize a compiled inference engine (compile_inference's) to one
    file at `path`. Returns path. A mesh engine of several ranks is bound to
    its process group and raises ValueError, as lfdtpu's export_parts
    refuses an SPMD engine."""
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and mesh.world_size > 1:
        raise ValueError("a mesh engine of several ranks is bound to its process group and "
                         "cannot be saved; save an engine built with mesh=None")
    program = export_engine(engine)
    frames, vhw = engine.example_args()
    meta = dict(
        magic=MAGIC,
        precision=engine.precision_mode,
        input_resolution=list(engine.input_resolution),
        batch_size=engine.batch_size,
        frame_dtype=_DTYPE_NAMES[frames.dtype],
        vhw_shape=list(vhw.shape),
        pack_output=bool(engine.pack_output),
        output_dtype=_DTYPE_NAMES.get(engine.output_dtype),
        kernel_stem=bool(engine.kernel_stem),
        device=str(engine.device),
        tf32=list(engine.tf32),
        ops=lfd_ops(program),
        torch=torch.__version__,
    )
    if engine.device.type != "cpu":
        program = move_to_device_pass(program, "cpu")
    program.example_inputs = None  # kept out: torch.export pickles them
    blob = io.BytesIO()
    with warnings.catch_warnings():
        # channels_last weights are dense but not contiguous, which the
        # packer reports as "no complete tensor" before it stores their whole
        # storage with their strides
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, blob)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("program.pt2", blob.getvalue())
    return path


def _check_pickle_free(blob):
    """Refuse a torch.export archive that holds anything loading would
    unpickle: pickled weights or constants, custom objects, sample inputs.
    An archive whose weights config is not where this looks for it is
    refused too: nothing was checked."""
    weights_config = False
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        for name in z.namelist():
            if name.endswith("_config.json") and "/data/" in name:
                weights_config |= "/data/weights/" in name
                for fqn, entry in json.loads(z.read(name))["config"].items():
                    if entry.get("use_pickle") or not entry.get("tensor_meta"):
                        raise ValueError(f"engine file: {fqn} is not stored as raw tensor bytes")
            elif "/data/sample_inputs/" in name and z.getinfo(name).file_size:
                raise ValueError("engine file: the program carries pickled sample inputs")
    if not weights_config:
        raise ValueError("engine file: the program has no weights config (an archive layout "
                         "this torch does not write)")


def read_meta(path):
    """The metadata of an engine file; raises for a file that is not one."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    if meta.get("magic") != MAGIC:
        raise ValueError(f"not an lfdtpu_torch engine file: {path}")
    return meta


class LoadedEngine(GraphRunner):
    """An engine restored from a file, with compile_inference's call
    surface: engine(images, valid_hw) -> detections on its device. On a
    CUDA device it is captured as the built engine is (GraphRunner: a graph
    per frame dtype, the uint8 one captured at load, pinned staging), and
    `captured_launches` counts its kernel launches; on the CPU it is eager.
    A capture that fails raises. It runs under the file's TF32 switches."""

    def __init__(self, program, meta, device):
        self.meta = meta
        self.precision_mode = meta["precision"]
        self.input_resolution = tuple(meta["input_resolution"])
        self.batch_size = int(meta["batch_size"])
        self.pack_output = bool(meta["pack_output"])
        self.output_dtype = _DTYPES.get(meta["output_dtype"])
        self.kernel_stem = bool(meta["kernel_stem"])
        self.device = device
        self._program_dtype = _DTYPES[meta["frame_dtype"]]
        self._vhw_shape = tuple(meta["vhw_shape"])
        self.program = program
        self._module = program.module()
        self._init_runner(device.type == "cuda", tf32=meta["tf32"])

    @torch.inference_mode()
    def _forward(self, x, vhw):
        if x.dtype != self._program_dtype:
            if self.kernel_stem:
                raise ValueError("the stem kernel consumes raw uint8 frames")
            x = x.to(self._program_dtype)  # uint8 frames reach these nets as float32
        return self._module(x, vhw.reshape(self._vhw_shape))


def load_engine(path, device=None):
    """Restore an engine written by save_engine, on `device`: the card
    ("cuda") unless the caller asks for another (device="cpu"), captured on
    a CUDA device and eager on the CPU. No model code is needed."""
    meta = read_meta(path)
    if meta["torch"] != torch.__version__:
        warnings.warn(f"engine file {path} was written by torch {meta['torch']}, "
                      f"this is torch {torch.__version__}")
    device = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        blob = z.read("program.pt2")
    _check_pickle_free(blob)
    with warnings.catch_warnings():
        # some torch versions wrap the archive's read-only bytes without a
        # copy and say so; the program only reads its weights
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        program = torch.export.load(io.BytesIO(blob))
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return LoadedEngine(program, meta, device)


def predict_padded(engine, image):
    """Run one HWC image through an engine (built or loaded), zero-padded to
    its input resolution as the engine stages it: the
    predict-through-an-engine-file flow of the workloads'
    predict_engine.py (`lfdtpu/deploy/engine_io.py:129`)."""
    h, w = image.shape[:2]
    eh, ew = engine.input_resolution
    if h > eh or w > ew:
        raise ValueError(f"image {h}x{w} exceeds engine resolution {eh}x{ew}")
    return engine([image], np.asarray([h, w], np.float32))
