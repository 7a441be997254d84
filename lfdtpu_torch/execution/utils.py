# Execution utilities, the port of `lfdtpu/execution/utils.py` (reference
# `lfd/execution/utils.py`): metering, logging, environment summary, seeds,
# the exception hook and checkpoint IO.
#
# Checkpoints use the upstream reference's layout, written by torch.save:
#   {"state_dict": net.state_dict(), "optimizer": optimizer.state_dict(),
#    "meta": {basic-typed config, epoch, train_iter}}
# with the reference's module names, so
# `lfdtpu/execution/torch_convert.py::load_reference_checkpoint` reads a port
# checkpoint into lfdtpu unchanged.

from __future__ import annotations

import logging
import os
import random
import subprocess
import sys
import traceback

import numpy as np
import torch

__all__ = [
    "AverageMeter",
    "get_root_logger",
    "collect_envs",
    "customize_exception_hook",
    "set_random_seed",
    "save_checkpoint",
    "load_checkpoint",
    "load_backbone_weights",
]


class AverageMeter:
    """Named running averages with weighted / sum modes
    (`lfd/execution/utils.py:276-321`).

    update(name, value, weight): accumulates value*weight and weight.
    get_average(name, 'weighted_sum') -> sum(v*w)/sum(w)
    get_average(name, 'sum')          -> sum(v*w)/count   (used for speed)
    """

    def __init__(self):
        self._sums = {}
        self._weights = {}
        self._counts = {}

    def update(self, name, value, weight=1.0):
        value = float(value)
        weight = float(weight)
        self._sums[name] = self._sums.get(name, 0.0) + value * weight
        self._weights[name] = self._weights.get(name, 0.0) + weight
        self._counts[name] = self._counts.get(name, 0) + 1

    def get_all_names(self):
        return list(self._sums.keys())

    def get_average(self, name, avg_mode="weighted_sum"):
        if name not in self._sums:
            return 0.0
        if avg_mode == "weighted_sum":
            w = self._weights[name]
            return self._sums[name] / w if w else 0.0
        if avg_mode == "sum":
            c = self._counts[name]
            return self._sums[name] / c if c else 0.0
        raise ValueError(f"unknown avg_mode {avg_mode}")

    def clear(self):
        self._sums.clear()
        self._weights.clear()
        self._counts.clear()


def _rank():
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_root_logger(log_path=None, level=logging.INFO, name="lfdtpu_torch"):
    """Console + optional file logger; only rank 0 logs below ERROR
    (the reference's rank-aware handlers, `utils.py:148-239`)."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    is_primary = _rank() == 0
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    sh.setLevel(level if is_primary else logging.ERROR)
    logger.addHandler(sh)
    if log_path and is_primary:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def _card_line():
    """nvidia-smi's name and power limit of every card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e!r})"
    if out.returncode != 0:
        return f"unavailable (nvidia-smi exit {out.returncode})"
    return "; ".join(out.stdout.strip().splitlines())


def collect_envs():
    """Environment summary (`utils.py:125-145`), PyTorch edition: torch,
    CUDA and cuDNN versions, the devices, the cards' power limits and the
    process group's world size (1 without one)."""
    dist = torch.distributed
    envs = {
        "python": sys.version.replace("\n", ""),
        "torch": torch.__version__,
        "numpy": np.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None,
        "cuda_device_count": torch.cuda.device_count(),
        "cpu_count": os.cpu_count(),
        "world_size": (dist.get_world_size()
                       if dist.is_available() and dist.is_initialized() else 1),
    }
    if torch.cuda.is_available():
        envs["devices"] = ", ".join(torch.cuda.get_device_name(i)
                                    for i in range(torch.cuda.device_count()))
        envs["name, power limit"] = _card_line()
    return envs


def customize_exception_hook(exception_log_path):
    """sys.excepthook that appends tracebacks to a file
    (`utils.py:242-257`)."""

    def hook(exc_type, exc_value, exc_traceback):
        os.makedirs(os.path.dirname(os.path.abspath(exception_log_path)), exist_ok=True)
        with open(exception_log_path, "a") as f:
            f.write("".join(traceback.format_exception(exc_type, exc_value, exc_traceback)))
        sys.__excepthook__(exc_type, exc_value, exc_traceback)

    return hook


def set_random_seed(seed):
    """Seed `random` (the region samplers draw from it), numpy and torch;
    returns a torch.Generator seeded with `seed` for the weight init. Every
    rank of a data mesh takes the same seed: one init (rank 0's weights are
    broadcast as well) and one sampler stream, which the ranks shard."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def save_checkpoint(path, net, optimizer=None, meta=None):
    """Write the reference's checkpoint layout with torch.save (through a
    temporary file, so a crash never leaves half a checkpoint)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    payload = {"state_dict": net.state_dict(), "meta": meta or {}}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path):
    """The checkpoint dict ({"state_dict", "optimizer"?, "meta"}) on the
    CPU. weights_only: a checkpoint holds tensors and basic types only."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_weights(module, state_dict, strict, logger=None):
    """load_state_dict, reporting missing / unexpected keys when not
    strict (the reference loader's report, `utils.py:19-72`)."""
    result = module.load_state_dict(state_dict, strict=strict)
    if not strict and (result.missing_keys or result.unexpected_keys):
        msg = (f"missing keys: {sorted(result.missing_keys)[:8]} "
               f"({len(result.missing_keys)}), unexpected keys: "
               f"{sorted(result.unexpected_keys)[:8]} ({len(result.unexpected_keys)})")
        (logger.warning if logger else print)(msg)
    return result


def load_backbone_weights(backbone, ckpt_path, prefix="_backbone.", logger=None):
    """Initialize `backbone` (an nn.Module) from a full-model checkpoint,
    taking its entries under `prefix` with the prefix stripped (the
    reference strips the backbone prefix from pretrained state_dicts,
    `lfd_resnet.py:314-340`); non-strict, reported. Returns the
    load_state_dict result."""
    ckpt = load_checkpoint(ckpt_path)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return load_weights(backbone, sd, strict=False, logger=logger)
