# lfdtpu_torch — the LFD detection system in PyTorch and CUDA for one NVIDIA
# H100, beside the JAX package `lfdtpu`, which stays the reference it is
# tested against. This package imports torch and numpy, never jax or lfdtpu.
#
# Ported so far: the WIDERFACE inference engine (models, decode, NMS, the
# compiled engine) with its three hand-written Hopper kernels in `csrc/`:
# NMS keep mask (K1), fused uint8 stem (K2) and the FasterBlock 3x3 conv (K3).

__version__ = "0.1.0"
