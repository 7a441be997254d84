# lfdtpu_torch — the LFD detection system in PyTorch and CUDA for one NVIDIA
# H100 (or several), beside the JAX package `lfdtpu`, which stays the
# reference it is tested against. This package imports torch and numpy,
# never jax or lfdtpu.
#
# It does all that lfdtpu does, under lfdtpu's package names: the detectors
# and their zoo (`models`, `zoo`), target assignment, losses, decode and NMS
# (`ops`), the data pipeline and loaders (`data`), training (`execution`:
# the Executor, optimizers, schedules, hooks), data and spatial parallelism
# (`parallel`), the inference engines in fp32, bf16 and int8 with engine
# files, streams and resolution buckets (`deploy`), evaluation and the
# workload scripts. Its four hand-written Hopper kernels live in `csrc/` and
# run as torch.library ops: the NMS keep mask (K1), the fused uint8 stem
# (K2), the FasterBlock 3x3 conv (K3) and the int8 conv (K4). The names of
# lfdtpu that the port does not carry, and why, are listed in
# tests/test_torch_namespaces.py.

from . import ops  # noqa: F401  (lfdtpu/__init__.py imports its ops too)

__version__ = "0.1.0"
