# Executor, the port of `lfdtpu/execution/executor.py` (reference
# `lfd/execution/executor.py:13-259`): owns the config_dict, the hook
# registry, the train and val loops, checkpoint save / resume and weight
# loading.
#
# One device, named by config_dict["device"] (default "cuda"; a missing CUDA
# device raises, the run never moves to the CPU). The train step
# (parallel.make_train_step) updates the net and its torch optimizer in
# place; lr and the clip-window flag are host values fed in each iteration,
# and the metrics stay 0-d device tensors until display time, so the loop
# makes no host sync per step.
#
# Data parallel: config_dict["mesh"] (a parallel.Mesh), or a process group
# of several ranks (torchrun; parallel.initialize_distributed), makes the
# Executor one rank of a data mesh, one process per device, as lfdtpu's
# Executor over its `data` mesh:
#   - the rank's device (cuda:LOCAL_RANK for "cuda", or the mesh's);
#   - batch_size stays the global batch; the train loader yields this rank's
#     rows of each global batch (DataLoader.shard), every rank drawing rank
#     0's index stream;
#   - the mesh step (sync-BN, global loss normalizers, DDP) from rank 0's
#     weights; the metrics are the global batch's;
#   - the val loop: each rank runs and decodes its rows of each val batch
#     and the rows are gathered in the global order, so the evaluator (on
#     rank 0) sees what a one-process pass sees;
#   - only rank 0 writes checkpoints, the log file and the evaluation.
# A list of devices in one process raises: a torch process drives one
# device (a list would be DataParallel, which lfdtpu replaced).
#
# config_dict keys consumed (as lfdtpu's):
#   model (LFD from zoo / models), optimizer (execution.optim config),
#   lr_schedule, optimizer_grad_clip_cfg {max_norm, duration}?,
#   train_data_loader, val_data_loader?, evaluator?, training_epochs,
#   work_dir, log_path?, display_interval, save_interval, val_interval,
#   seed?, batch_size, input_hw, weight_path?, resume_path?,
#   device_preprocess?, device_augment?, device_prefetch?, extra_hooks?,
#   device?
# The val loop (every val_interval epochs, over val_data_loader) runs the net
# in eval mode without touching its BN statistics, decodes each batch once
# and hands the per-image rows to the evaluator through EvaluationHook.

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..data.device_aug import AUG_KEYS
from ..device import resolve_device
from ..parallel.distributed import rank_device
from ..parallel.mesh import make_mesh
from .hooks import (CheckpointHook, EvaluationHook, Hook, LoggerHook, LrSchedulerHook,
                    OptimizerHook, SpeedHook, get_priority)
from .utils import (AverageMeter, get_root_logger, load_checkpoint, load_weights,
                    save_checkpoint, set_random_seed)

_BASIC_TYPES = (str, int, float, bool, type(None))


def _basic(v):
    """True for str/int/float/bool/None and lists, tuples and str-keyed
    dicts of them: what a weights_only torch.load reads back."""
    if isinstance(v, _BASIC_TYPES):
        return True
    if isinstance(v, (list, tuple)):
        return all(_basic(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _basic(x) for k, x in v.items())
    return False


def _placement(cfg):
    """(device, mesh or None): config_dict['mesh'], else a mesh over a
    process group of several ranks on the rank's device, else one device."""
    device = cfg.get("device", "cuda")
    if isinstance(device, (list, tuple)):
        raise ValueError("config_dict['device'] is a list: a torch process drives one "
                         "device; launch one process per device (torchrun)")
    mesh = cfg.get("mesh")
    if mesh is None and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        device = resolve_device(device, "config_dict['device']")
        mesh = make_mesh(rank_device() if device == torch.device("cuda") else device)
    if mesh is not None:
        return mesh.device, mesh
    return resolve_device(device, "config_dict['device']"), None


def _shard(loader, mesh):
    """The train loader yields this rank's rows of each global batch. Every
    rank draws the index batches from rank 0's sampler stream, so the
    ranks' rows make up one global batch however the sampler was seeded."""
    rng = getattr(loader._dataset_sampler, "_rng", None)
    if rng is not None:
        state = [rng.getstate()]
        dist.broadcast_object_list(state, src=0, group=mesh.group)
        rng.setstate(state[0])
    loader.shard(mesh.rank, mesh.size)


class Executor:
    def __init__(self, config_dict):
        # imported here: parallel.data_parallel imports execution.optim,
        # so a module-level import would close a cycle through __init__
        from ..parallel.data_parallel import create_train_state, make_train_step

        self.config_dict = config_dict
        cfg = self.config_dict
        self.device, self.mesh = _placement(cfg)
        self.rank = self.mesh.rank if self.mesh is not None else 0

        cfg.setdefault("work_dir", "./work_dir")
        os.makedirs(cfg["work_dir"], exist_ok=True)
        cfg["logger"] = get_root_logger(cfg.get("log_path"))

        cfg.setdefault("display_interval", 100)
        cfg.setdefault("save_interval", 1)
        cfg.setdefault("val_interval", 0)
        cfg.setdefault("mode", "train")
        cfg["epoch"] = 0
        cfg["train_iter"] = 0
        cfg["inner_train_iter"] = 0
        cfg["inner_val_iter"] = 0
        cfg["train_average_meter"] = AverageMeter()
        cfg["val_average_meter"] = AverageMeter()
        if "batch_size" not in cfg and "train_data_loader" in cfg:
            cfg["batch_size"] = cfg["train_data_loader"].batch_size

        self.detector = cfg["model"]
        generator = set_random_seed(cfg.get("seed", 0))
        input_hw = cfg.get("input_hw")
        if input_hw is None:
            raise ValueError("config_dict['input_hw'] (train crop size) is required")
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        if self.mesh is not None and self.mesh.size > 1 and "train_data_loader" in cfg:
            _shard(cfg["train_data_loader"], self.mesh)
        self.state = create_train_state(self.detector, cfg["optimizer"], generator,
                                        self.device, mesh=self.mesh)

        # weight init / resume (`executor.py:32-36,134-176`)
        if cfg.get("resume_path"):
            self.resume(cfg["resume_path"])
        elif cfg.get("weight_path"):
            ckpt = load_checkpoint(cfg["weight_path"])
            load_weights(self.state.net, ckpt.get("state_dict", ckpt), strict=False,
                         logger=cfg["logger"])

        clip_cfg = cfg.get("optimizer_grad_clip_cfg")
        # cfg['device_preprocess']: normalize on the device, the loader
        # ships raw uint8 crops. cfg['device_augment']: the whole
        # augmentation on the device (data.DeviceAugment); the loader (a
        # DeviceAugRegionSampler) ships raw uint8 source windows and
        # per-image aug params, and the step's images are the dict
        # {buffer, scale, translation, flip}.
        self._aug_on_device = cfg.get("device_augment") is not None
        self._train_step = make_train_step(
            self.detector, self.state.optimizer, self.input_hw,
            clip_max_norm=float(clip_cfg["max_norm"]) if clip_cfg else 0.0,
            preprocess=cfg.get("device_augment") or cfg.get("device_preprocess"),
            mesh=self.mesh,
        )

        self._eval_step = None
        self._pending_metrics = []
        self.last_metrics = None
        self._hooks = []
        self._register_default_hooks()
        for h in cfg.get("extra_hooks", []):
            self.register_hook(h)

    # ------------------------------------------------------------- hooks
    def register_hook(self, hook, priority=None):
        assert isinstance(hook, Hook)
        if priority is not None:
            hook.priority = priority
        p = get_priority(hook.priority)
        for i, h in enumerate(self._hooks):
            if p < get_priority(h.priority):
                self._hooks.insert(i, hook)
                break
        else:
            self._hooks.append(hook)

    def _register_default_hooks(self):
        cfg = self.config_dict
        self.register_hook(LrSchedulerHook())
        self.register_hook(
            OptimizerHook(cfg.get("optimizer_grad_clip_cfg"), cfg["training_epochs"])
        )
        self.register_hook(SpeedHook())
        self.register_hook(CheckpointHook())
        if cfg.get("evaluator") is not None and self.rank == 0:
            self.register_hook(EvaluationHook())
        self.register_hook(LoggerHook())

    def call_hooks(self, fn_name):
        for hook in self._hooks:
            getattr(hook, fn_name)(self)

    def get_current_lr(self):
        return self.config_dict.get("current_lr", 0.0)

    # ------------------------------------------------------------ train
    def train(self):
        from ..parallel.prefetch import BATCH_KEYS, prefetch_to_device

        cfg = self.config_dict
        cfg["mode"] = "train"
        self.call_hooks("before_train_epoch")
        keys = BATCH_KEYS + (AUG_KEYS if self._aug_on_device else ())
        loader = cfg["train_data_loader"]
        batches = prefetch_to_device(loader, self.device,
                                     size=int(cfg.get("device_prefetch", 2)), keys=keys)
        for inner, batch in enumerate(batches):
            cfg["inner_train_iter"] = inner
            self.call_hooks("before_train_iter")
            if self._aug_on_device:
                images = dict(buffer=batch["images"], scale=batch["aug_scale"],
                              translation=batch["aug_translation"], flip=batch["aug_flip"])
            else:
                images = batch["images"]
            metrics = self._train_step(
                images, batch["gt_bboxes"], batch["gt_labels"], batch["gt_mask"],
                cfg["current_lr"], cfg.get("clip_enabled", False))
            # async metering: keep device scalars, convert at display time
            # (the reference syncs every iteration via loss.item()); hooks
            # may read this step's 0-d device tensors from last_metrics
            self.last_metrics = metrics
            self._pending_metrics.append((metrics, cfg["batch_size"]))
            display = cfg["display_interval"]
            if (inner + 1) % display == 0 or (inner + 1) == len(loader):
                self._flush_metrics()
            self.call_hooks("after_train_iter")
            cfg["train_iter"] += 1
        self._flush_metrics()
        self.call_hooks("after_train_epoch")

    def _flush_metrics(self):
        """One device-to-host copy for every pending step's losses and
        grad_norm."""
        if not self._pending_metrics:
            return
        cfg = self.config_dict
        # sorted, as lfdtpu's jitted metrics dict comes back
        names = sorted(k for k in self._pending_metrics[0][0] if "loss" in k) + ["grad_norm"]
        values = torch.stack([torch.stack([m[k].float() for k in names])
                              for m, _ in self._pending_metrics]).cpu().tolist()
        for row, (_, bs) in zip(values, self._pending_metrics):
            for name, val in zip(names[:-1], row):
                cfg["train_average_meter"].update(name, val, bs)
        cfg["grad_norm"] = values[-1][-1]
        self._pending_metrics.clear()

    # -------------------------------------------------------------- val
    def val(self):
        """One pass over val_data_loader (`lfdtpu/execution/executor.py:
        219-243`): eval-mode forward, one batched decode, the per-image rows
        in config_dict['eval_results'] and the loader meta in
        config_dict['eval_meta'] for the hooks."""
        from ..parallel.data_parallel import make_eval_step

        cfg = self.config_dict
        if cfg.get("val_data_loader") is None:
            return
        cfg["mode"] = "val"
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.detector)
        self.call_hooks("before_val_epoch")
        for inner, batch in enumerate(cfg["val_data_loader"]):
            cfg["inner_val_iter"] = inner
            self.call_hooks("before_val_iter")
            cfg["eval_results"] = self._val_rows(batch["images"], batch["meta"])
            cfg["eval_meta"] = batch["meta"]
            self.call_hooks("after_val_iter")
        self.call_hooks("after_val_epoch")
        cfg["mode"] = "train"

    def _val_rows(self, images, meta):
        """The per-image rows of one val batch. Over a mesh each rank runs
        and decodes its share of the rows, and every rank gets all of them
        back in the batch's order."""
        input_hw = (images.shape[1], images.shape[2])
        if self.mesh is None or self.mesh.size == 1:
            return self.detector.results_from_outputs(self._eval_step(self.state, images),
                                                      input_hw, meta)
        n, r, size = len(images), self.mesh.rank, self.mesh.size
        lo, hi = n * r // size, n * (r + 1) // size
        rows = (self.detector.results_from_outputs(
            self._eval_step(self.state, images[lo:hi]), input_hw, meta[lo:hi])
            if hi > lo else [])
        parts = [None] * size
        dist.all_gather_object(parts, rows, group=self.mesh.group)
        return [row for part in parts for row in part]

    def run(self):
        """Epochs of train + periodic val (`executor.py:249-259`)."""
        cfg = self.config_dict
        self.call_hooks("before_run")
        while cfg["epoch"] < cfg["training_epochs"]:
            self.train()
            if cfg.get("val_interval", 0) > 0 and (cfg["epoch"] + 1) % cfg["val_interval"] == 0:
                self.val()
            cfg["epoch"] += 1
        self.call_hooks("after_run")

    # ------------------------------------------------------- checkpoint
    def _meta(self):
        return {k: v for k, v in self.config_dict.items() if _basic(v)}

    def save(self, path=None):
        cfg = self.config_dict
        path = path or os.path.join(cfg["work_dir"], f"epoch_{cfg['epoch'] + 1}.pth")
        meta = self._meta()
        meta["epoch"] = cfg["epoch"]
        meta["train_iter"] = cfg["train_iter"]
        save_checkpoint(path, self.state.net, self.state.optimizer, meta)
        cfg["logger"].info(f"checkpoint saved to {path}")

    def resume(self, path):
        """Weights, BN stats, momentum buffers and the epoch / train_iter
        counters (`executor.py:285-298`), strictly."""
        cfg = self.config_dict
        ckpt = load_checkpoint(path)
        self.state.net.load_state_dict(ckpt["state_dict"], strict=True)
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        meta = ckpt.get("meta", {})
        cfg["epoch"] = meta.get("epoch", 0) + 1
        cfg["train_iter"] = meta.get("train_iter", 0)
        cfg["logger"].info(f"resumed from {path} at epoch {cfg['epoch']}")

    @property
    def variables(self):
        """The net's state_dict (lfdtpu: {params, batch_stats})."""
        return self.state.net.state_dict()
