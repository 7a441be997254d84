"""Faults planted underneath a run's timed path, to see the check catch
them: CPU tests (benchmark/tests/test_bench_faults.py) and the card's
readings (benchmark/tools/readings.py) plant the same ones. Each takes a
function that sets an attribute (pytest's monkeypatch.setattr, or setattr)
and replaces one of benchmark.core.system's entry points.
"""

from __future__ import annotations

import torch

from benchmark.core import system


class AlteredEngine:
    """An engine whose detections are altered where it produces them."""

    def __init__(self, engine, alter):
        self._engine, self._alter = engine, alter
        self.input_resolution = engine.input_resolution
        self.batch_size = engine.batch_size

    def __call__(self, images, valid_hw):
        return self._alter(dict(self._engine(images, valid_hw)))


def moved_boxes(out):
    """Every box moved right by 0.6 of its width."""
    b = out["boxes"].clone()
    w = b[..., 2] - b[..., 0]
    b[..., 0] += 0.6 * w
    b[..., 2] += 0.6 * w
    return dict(out, boxes=b)


def lowered_scores(out):
    """Every score halved."""
    return dict(out, scores=out["scores"] * 0.5)


def top_row(out):
    """Only each image's first row kept."""
    return dict(out, count=out["count"].clamp(max=1))


def altered_answers(setattr_, alter):
    real = system.engine
    setattr_(system, "engine", lambda *a, **k: AlteredEngine(real(*a, **k), alter))


def nms_off(setattr_):
    """An engine whose NMS suppresses nothing (its IoU threshold 1)."""
    real = system.engine
    setattr_(system, "engine", lambda det, cfg, *a, **k: real(det, dict(cfg, nms_threshold=1.0),
                                                             *a, **k))


def unchanged_state(setattr_):
    """A train step that returns its state unchanged (the parameters put
    back after the real step)."""
    real = system.train_step

    def build(det, cfg, device):
        net, opt, step = real(det, cfg, device)

        def step_(*args):
            saved = [p.detach().clone() for p in net.parameters()]
            metrics = step(*args)
            with torch.no_grad():
                for p, v in zip(net.parameters(), saved):
                    p.copy_(v)
            return metrics

        return net, opt, step_

    setattr_(system, "train_step", build)


def half_batch(setattr_):
    """A train step over the first half of its batch, the mean taken over it."""
    real = system.train_step

    def build(det, cfg, device):
        net, opt, step = real(det, cfg, device)

        def step_(images, gt, labels, mask, lr, clip):
            n = images.shape[0] // 2
            return step(images[:n], gt[:n], labels[:n], mask[:n], lr, clip)

        return net, opt, step_

    setattr_(system, "train_step", build)


FAULTS = {"moved_boxes": lambda s: altered_answers(s, moved_boxes),
          "lowered_scores": lambda s: altered_answers(s, lowered_scores),
          "top_row": lambda s: altered_answers(s, top_row), "nms_off": nms_off,
          "unchanged_state": unchanged_state, "half_batch": half_batch}
