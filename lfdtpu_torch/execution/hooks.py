# Hook system, the port of `lfdtpu/execution/hooks.py` (reference
# `lfd/execution/hooks/`): Priority enum 0-100, Hook base with before/after
# x run/epoch/iter x train/val callbacks.
#
# As in lfdtpu:
#   - OptimizerHook's backward/clip/step lives in the train step
#     (parallel/data_parallel.py); the hook only keeps the epoch-limited
#     clip window.
#   - LrSchedulerHook evaluates the host-side schedule (schedules.py) and
#     stashes the lr for the step.
# ProfilerHook traces with torch.profiler.

from __future__ import annotations

from enum import Enum

from .utils import collect_envs


class Priority(Enum):
    HIGHEST = 0
    VERY_HIGH = 10
    HIGH = 30
    NORMAL = 50
    LOW = 70
    VERY_LOW = 90
    LOWEST = 100


def get_priority(priority):
    if isinstance(priority, int):
        if priority < 0 or priority > 100:
            raise ValueError("priority must be between 0 and 100")
        return priority
    if isinstance(priority, Priority):
        return priority.value
    if isinstance(priority, str):
        return Priority[priority.upper()].value
    raise TypeError("priority must be an integer, str or Priority")


class Hook:
    def __init__(self):
        self.priority = Priority.NORMAL

    def before_run(self, executor):
        pass

    def after_run(self, executor):
        pass

    def before_epoch(self, executor):
        pass

    def after_epoch(self, executor):
        pass

    def before_iter(self, executor):
        pass

    def after_iter(self, executor):
        pass

    def before_train_epoch(self, executor):
        self.before_epoch(executor)

    def before_val_epoch(self, executor):
        self.before_epoch(executor)

    def after_train_epoch(self, executor):
        self.after_epoch(executor)

    def after_val_epoch(self, executor):
        self.after_epoch(executor)

    def before_train_iter(self, executor):
        self.before_iter(executor)

    def before_val_iter(self, executor):
        self.before_iter(executor)

    def after_train_iter(self, executor):
        self.after_iter(executor)

    def after_val_iter(self, executor):
        self.after_iter(executor)


class LrSchedulerHook(Hook):
    """Computes the step lr from config_dict['lr_schedule'] and stores it in
    config_dict["current_lr"] (consumed by the train step)."""

    def before_train_iter(self, executor):
        cfg = executor.config_dict
        cfg["current_lr"] = float(
            cfg["lr_schedule"](cfg["epoch"], cfg["train_iter"])
        )


class OptimizerHook(Hook):
    """Mirrors the grad-clip duration window (`optimizer_hook.py:22-37`):
    clipping is enabled only while epoch < duration."""

    def __init__(self, grad_clip_cfg, training_epochs):
        super().__init__()
        assert grad_clip_cfg is None or isinstance(grad_clip_cfg, dict)
        self._cfg = dict(grad_clip_cfg) if grad_clip_cfg else None
        if self._cfg is not None:
            self.max_norm = float(self._cfg.get("max_norm", 0.0))
            self.duration = int(self._cfg.pop("duration", training_epochs))
        else:
            self.max_norm = 0.0
            self.duration = 0

    def before_train_iter(self, executor):
        cfg = executor.config_dict
        cfg["clip_enabled"] = bool(
            self._cfg is not None and cfg["epoch"] < self.duration
        )


class SpeedHook(Hook):
    """images/s per iter via wall clock (`speed_hook.py:15-26`), averaged
    over the display interval. lfdtpu records the batch size weighted by
    the seconds, which reads batch x seconds (ROADMAP F12). The step is
    asynchronous on a GPU, so this times the host's enqueue, not the
    device's work. batch_size is the global batch: over a data mesh each
    rank reads the global images/s. For the device's pace, read the
    `train.step` span's parts (their stream times) under ProfilerHook or
    any torch.profiler session (lfdtpu_torch/tracing.py)."""

    def __init__(self):
        super().__init__()
        self._t0 = 0.0

    def before_train_iter(self, executor):
        import time

        self._t0 = time.time()

    def before_val_iter(self, executor):
        self.before_train_iter(executor)

    def after_train_iter(self, executor):
        import time

        cfg = executor.config_dict
        cfg["train_average_meter"].update(
            "speed", cfg["batch_size"] / (time.time() - self._t0)
        )

    def after_val_iter(self, executor):
        import time

        cfg = executor.config_dict
        cfg["val_average_meter"].update(
            "speed", cfg["batch_size"] / (time.time() - self._t0)
        )


class CheckpointHook(Hook):
    """Saves every save_interval epochs; over a data mesh rank 0 alone
    writes (the ranks hold one model)."""

    def after_train_epoch(self, executor):
        if (executor.config_dict["epoch"] % executor.config_dict["save_interval"] == 0
                and executor.rank == 0):
            executor.save()


class EvaluationHook(Hook):
    """Feeds each val iteration's per-image results and loader meta to
    config_dict['evaluator'] and evaluates after the val epoch
    (`lfdtpu/execution/hooks.py:159-167`)."""

    def after_val_iter(self, executor):
        executor.config_dict["evaluator"].update(
            executor.config_dict["eval_results"],
            executor.config_dict.get("eval_meta"),
        )

    def after_val_epoch(self, executor):
        executor.config_dict["evaluator"].evaluate()


class LoggerHook(Hook):
    """Env dump + per-display_interval train line (`logger_hook.py:12-96`)."""

    def _log_line(self, executor):
        cfg = executor.config_dict
        if cfg["mode"] == "train":
            meter = cfg["train_average_meter"]
            s = "Epoch[{}][{}/{}], lr:{:.5f}".format(
                cfg["epoch"] + 1,
                cfg["inner_train_iter"] + 1,
                len(cfg["train_data_loader"]),
                cfg.get("current_lr", 0.0),
            )
            s += ", speed:{:.2f} images/s".format(meter.get_average("speed", "sum"))
            if "grad_norm" in cfg:
                s += ", grad_norm:{:.2f}".format(cfg["grad_norm"])
        else:
            meter = cfg["val_average_meter"]
            s = "Val Epoch[{}/{}]".format(
                cfg["inner_val_iter"] + 1, len(cfg["val_data_loader"])
            )
            s += ", speed:{:.2f} images/s".format(meter.get_average("speed", "sum"))
        for name in meter.get_all_names():
            if "loss" in name:
                s += ", {}:{:.5f}".format(name, meter.get_average(name, "weighted_sum"))
        return s

    def before_run(self, executor):
        logger = executor.config_dict["logger"]
        logger.info("Training environment summary --------")
        for k, v in collect_envs().items():
            logger.info("{:<20}:{}".format(k, v))
        logger.info("-----------------------------------------------")
        logger.info("Training settings --------")
        for key in (
            "work_dir", "training_epochs", "batch_size", "seed",
            "display_interval", "save_interval", "val_interval",
            "weight_path", "resume_path",
        ):
            if key in executor.config_dict:
                logger.info("{:<20}:{}".format(key, executor.config_dict[key]))
        logger.info("-----------------------------------------------")

    def after_run(self, executor):
        executor.config_dict["logger"].info("Training finishes.")

    def before_train_epoch(self, executor):
        executor.config_dict["logger"].info(
            "Train Epoch[{}] starts......".format(executor.config_dict["epoch"] + 1)
        )

    def before_val_epoch(self, executor):
        executor.config_dict["logger"].info("Val Epoch starts......")

    def after_train_iter(self, executor):
        cfg = executor.config_dict
        i = cfg["inner_train_iter"] + 1
        if i % cfg["display_interval"] == 0 or i == len(cfg["train_data_loader"]):
            cfg["logger"].info(self._log_line(executor))
            cfg["train_average_meter"].clear()

    def after_val_iter(self, executor):
        cfg = executor.config_dict
        i = cfg["inner_val_iter"] + 1
        if i % cfg["display_interval"] == 0 or i == len(cfg["val_data_loader"]):
            cfg["logger"].info(self._log_line(executor))
            cfg["val_average_meter"].clear()

    def after_val_epoch(self, executor):
        cfg = executor.config_dict
        if cfg.get("evaluator") is not None and executor.rank == 0:
            cfg["logger"].info(cfg["evaluator"].get_eval_display_str())


class ProfilerHook(Hook):
    """torch.profiler trace of `num_iters` train iterations from train_iter
    `start_iter` (the reference only has wall-clock metering; lfdtpu's
    jax.profiler hook stops one iteration later). The trace is written to
    `trace_dir`/trace.json; `profile` keeps the profiler for
    key_averages(). While it records, the program's spans record too
    (lfdtpu_torch/tracing.py): the trace holds each step's `train.step`
    range with its parts (`train.forward`, `train.loss`, ...) beside the
    kernels, and tracing.summary() gives their medians."""

    def __init__(self, trace_dir, start_iter=10, num_iters=5):
        super().__init__()
        self._dir = trace_dir
        self._start = start_iter
        self._stop = start_iter + num_iters
        self._active = False
        self.profile = None

    def before_train_iter(self, executor):
        import torch

        if executor.config_dict["train_iter"] == self._start and not self._active:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=activities)
            self.profile.start()
            self._active = True

    def after_train_iter(self, executor):
        import os

        if self._active and executor.config_dict["train_iter"] + 1 >= self._stop:
            self.profile.stop()
            self._active = False
            os.makedirs(self._dir, exist_ok=True)
            self.profile.export_chrome_trace(os.path.join(self._dir, "trace.json"))
