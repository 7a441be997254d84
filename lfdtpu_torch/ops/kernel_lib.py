# Build and load the hand-written CUDA kernels (`lfdtpu_torch/csrc/*.cu`).
#
# The sources compile with nvcc into ONE shared library with a plain C
# interface, loaded with ctypes: no PyTorch headers, so a cold build takes
# seconds. Each source compiles in its own nvcc process, all started
# together, and the objects are linked into the library. The build happens
# at the first kernel launch, never at import
# (the CPU-only test machines have no nvcc), into `<checkout>/build/kernels/`
# under a file name that carries a hash of the sources and flags, so a stale
# library is never loaded.

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# no --use_fast_math: the NMS kernel's IoU must round exactly like the
# reference's float32 expression (see csrc/nms.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # boxes, valid, keep, scratch, B, K, thr, stream
    "lfd_nms_mask_sorted": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _P),
    # x, w, mean, std, scale, bias, out, N, H, W, relu, stream
    "lfd_stem_conv": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w, scale, bias, residual, out, N, H, W, relu, stream
    "lfd_pair_conv3x3": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, w, mult, bias, residual, res_kind, res_scale, out, out_int8, inv_out,
    # relu, N, H, W, Cin, Cout, ksize, stride, route, stream
    "lfd_int8_conv": (_P, _P, _P, _P, _P, _I, ctypes.c_float, _P, _I, ctypes.c_float,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, part, N, HW, C, G, S, fp32, stream
    "lfd_group_norm_stats": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, part, gamma, beta, out, N, HW, C, G, S, eps, fp32, stream
    "lfd_group_norm_relu": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P),
    # points, strides, ranges, gray, gt, labels, mask, cls, reg, B, P, N, C,
    # mode, normalize, stream
    "lfd_assign": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path():
    """Content-addressed path of the built library for the current sources
    (and the headers they include)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblfd_kernels_{h.hexdigest()[:16]}.so"


def compile_sources(sources, out, *flags):
    """Compile `sources` with NVCC_FLAGS (and `flags`), one nvcc process per
    source, all at once, and link them into the shared library `out`.
    Returns the compilers' output (register and shared memory use per
    kernel, from -Xptxas=-v), which is kept beside it as `.log`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f"{out.stem}.{Path(src).stem}.{tag}.o" for src in sources]
    cmds = [[_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [" ".join(cmd) + "\n" + proc.communicate()[0] for cmd, proc in zip(cmds, procs)]
    tmp = out.with_suffix(f".{tag}")
    failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
    if not failed:
        link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(" ".join(link) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed = logs[-1:]
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return log


def build(verbose=False):
    """Compile the kernels if the library for these sources is missing.
    Returns the library path."""
    out = library_path()
    if out.exists():
        return out
    log = compile_sources(_sources(), out)
    if verbose:
        print(log)
    return out


@functools.cache
def library():
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lfd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lfd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(name, *args):
    """Call one C entry point; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.lfd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def stream_of(tensor):
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def check_cuda(name, t, dtype, shape, device, align=16):
    """Validate a tensor handed to a kernel: on `device` (a CUDA device),
    dtype, shape, contiguity and `align`-byte alignment (the widest vector
    access the kernel makes to it; most kernels use 16-byte ones)."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer is not {align}-byte aligned")
