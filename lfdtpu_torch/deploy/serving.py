# Pipelined (depth-k) streaming inference over one engine
# (`lfdtpu/deploy/serving.py`): keep `depth` calls in flight so that the next
# frames' host work (staging, the copy to the card, the launch) overlaps the
# card's work on the current ones, and fetch results in submission order.
#
# On the card an engine call is asynchronous: a captured engine enqueues its
# input copy and its graph replay on the current stream and returns device
# tensors. `_prefetch` enqueues each output's copy into pinned host memory
# right after the call and records an event; `_fetch` waits on that event
# and hands back numpy arrays, so a result costs no blocking round trip of
# its own. Deep pipelines need the engine to take a new frame before the
# previous frames' copies to the card are done: its pinned input staging
# grows to as many slots as the stream runs ahead, up to four
# (deploy/runner.py, STAGING_SLOTS). On the CPU a call is synchronous and the
# stream is the synchronous loop in order.
#
# Under a profiler session (tracing.py) each call records `stream.submit`
# (the engine's spans and `stream.prefetch` inside it) and each result
# `stream.fetch`, under the number of the submit it returns.

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .. import tracing


class _Pending:
    """One call's outputs on their way to the host: pinned host copies
    (same structure as the engine's output) and the event after the copies."""

    def __init__(self, out, device):
        self.event = torch.cuda.Event()
        if isinstance(out, dict):
            self.host = {k: self._copy(v) for k, v in out.items()}
        else:
            self.host = self._copy(out)
        self.event.record(torch.cuda.current_stream(device))

    @staticmethod
    def _copy(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host


def _numpy(out):
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _prefetch(out):
    """Start the copies of a result to the host without blocking: a
    _Pending for a result on the card, the result itself otherwise."""
    t = next(iter(out.values())) if isinstance(out, dict) else out
    if isinstance(t, torch.Tensor) and t.is_cuda:
        return _Pending(out, t.device)
    return out


def _submit(engine, args, host_prefetch):
    """One engine call, its result's copies to the host started (with
    host_prefetch): (the result or its _Pending, the call's span number)."""
    with tracing.span("stream.submit") as s:
        out = engine(*args)
        if host_prefetch:
            with tracing.span("stream.prefetch"):
                out = _prefetch(out)
    return out, s.seq


def _fetch(item, seq=None):
    """A result (or a _Pending) as numpy arrays; blocks until computed.
    seq: the number of the submit whose result this is (its span's)."""
    with tracing.span("stream.fetch", seq=seq):
        if isinstance(item, _Pending):
            item.event.synchronize()
            return _numpy(item.host)
        return _numpy(item)


def run_stream(engine, requests, depth=4, host_prefetch=True):
    """Serve an engine over a request stream with `depth` calls in flight.

    engine: a compile_inference or load_engine engine (or any callable
      returning tensors or a dict of them).
    requests: iterable of argument TUPLES for the engine, e.g.
      (images_uint8, valid_hw) pairs, consumed lazily: a live camera or
      queue generator works.
    depth: max in-flight calls; 1 is the synchronous loop.
    host_prefetch: enqueue each result's copy to pinned host memory right
      after its call, so the copies pipeline behind the card's work.

    Yields one fetched (numpy) result per request, IN SUBMISSION ORDER."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q = deque()
    for args in requests:
        q.append(_submit(engine, args, host_prefetch))
        if len(q) >= depth:
            yield _fetch(*q.popleft())
    while q:
        yield _fetch(*q.popleft())


class StreamingServer:
    """Explicit submit/collect form of `run_stream` for push-style callers
    (an RPC handler that cannot hand over an iterator).

    `submit(*args)` enqueues one engine call and returns the completed
    result of an OLDER call once the pipeline is full (else None);
    `drain()` yields the remaining in-flight results. Results always come
    back in submission order."""

    def __init__(self, engine, depth=4, host_prefetch=True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.engine = engine
        self.depth = depth
        self.host_prefetch = host_prefetch
        self._q = deque()

    def submit(self, *args):
        self._q.append(_submit(self.engine, args, self.host_prefetch))
        if len(self._q) >= self.depth:
            return _fetch(*self._q.popleft())
        return None

    def drain(self):
        while self._q:
            yield _fetch(*self._q.popleft())
