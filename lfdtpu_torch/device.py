# Where the port's entry points run: on the card unless the caller asks for
# another device. An omitted device means "cuda"; without a CUDA device that
# raises, rather than quietly running on the CPU.

from __future__ import annotations

import torch


def resolve_device(device=None, what="device"):
    """torch.device for `device` ("cuda" when None). Raises RuntimeError for
    a CUDA device when torch sees none; `what` names the argument."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} is {device} but torch sees no CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return device
