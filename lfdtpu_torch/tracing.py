# Spans and counters inside the port, recorded exactly while a torch.profiler
# session records (torch.profiler.profile, or execution.ProfilerHook) and at
# no other time. There is no switch of its own: the profiler is the switch.
#
#   with tracing.span("engine.replay", device):  # a timed region
#       graph.replay()
#   tracing.count("predict.rows", n)               # a counter
#   tracing.summary()                              # medians by span name
#
# With no profiler session recording, span() returns one shared no-op object
# after reading one module flag (torch.autograd.profiler._is_profiler_enabled,
# which the profiler sets at its start and clears at its stop): no profiler
# range, no CUDA event, no allocation and no host sync.
#
# While one records, a span is also a RecordFunction range of that session
# (torch's fast binding, a C++ context manager; its keyword args: the span's
# sequence number, in the trace with record_shapes), so it lies on the
# trace's timeline beside the device's kernels, and the trace names an idle
# gap of the device by the innermost span the host was in. Each span keeps its name, its host
# start and end (perf_counter_ns), its parent (the enclosing span on the same
# thread) and the sequence number of the top-level call that caused it (its
# own, from a process-wide count, when it has no parent; a caller may pass the
# number of the call whose work it finishes, as the stream's fetch does).
# With device= a CUDA device, the span also records a pair of timing events on
# that device's current stream: its stream time, from the span's start to its
# end on the stream. That is the device time of the work the span enqueued
# while the device runs behind the host, and holds the device's idle time too
# where the host falls behind (a host stall inside the span reads as stream
# time). The events come from a pool and are read after the fact, by query()
# as the spans pile up and at summary(), never by a sync inside a span. A
# span on a CPU device reads its host time as its stream time.
#
# No span or counter records inside a CUDA-graph capture: a top-level span
# asks the device (cudaStreamIsCapturing); a nested one records only inside
# a recorded one, and a capture that begins inside a recorded span runs
# under paused() (GraphRunner's).
#
# The spans are kept in memory, the newest BUFFER of them; older ones are
# dropped and counted. Spans and counters are process-wide, as the profiler
# session that switches them is.

from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time

import torch
from torch.autograd import profiler as _profiler

BUFFER = 1 << 16        # spans kept; the oldest are dropped past it
RESOLVE_EVERY = 256     # device spans left unread before the finished ones are read


class _Off:
    """What span() returns while nothing records: one shared object."""

    __slots__ = ()
    seq = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def _range(name, seq):
    """The span's profiler range."""
    return torch._C._profiler._RecordFunctionFast(name, (), {"seq": seq})


class _Span:
    """One recorded span. Its host time runs from the first statement of
    its enter to the last of its exit, so that what recording it costs is
    inside it and not in its parent's self time."""

    __slots__ = ("name", "seq", "id", "parent", "t0", "t1", "device", "stream", "start",
                 "end", "stream_ms", "_range", "_stack")

    def __init__(self, name, device, seq, stack):
        self.name, self.device, self.seq, self._stack = name, device, seq, stack
        self.stream = self.start = self.end = self.stream_ms = None

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        stack = self._stack
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.seq is None:
            self.seq = parent.seq if parent is not None else next(_RECORDER.seqs)
        self.id = next(_RECORDER.ids)
        self._range = _range(self.name, self.seq)
        self._range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.stream = _RECORDER.current_stream(self.device)
            self.start = _RECORDER.event(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        if self.start is not None:
            self.end = _RECORDER.event(self.stream)
        self._range.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        if self.device is not None and self.device.type == "cpu":
            self.stream_ms = (self.t1 - self.t0) / 1e6
        self._stack = None
        _RECORDER.add(self)
        return None


class Recorder:
    """The spans, counters and timing events of one process."""

    def __init__(self, buffer=BUFFER):
        self.spans = collections.deque(maxlen=buffer)
        self.dropped = 0
        self.counters = {}
        self.pending = collections.deque()  # spans whose events are not read yet
        self.free = {}                      # device index -> timing events to reuse
        self.streams = {}                   # (stream id, device index, type) -> Stream
        self.seqs = itertools.count(1)
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def current_stream(self, device):
        """The device's current stream, as torch.cuda.current_stream gives
        it, but built once per stream: building a Stream object sets the
        current device twice, the most a recorded span cost."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        key = torch._C._cuda_getCurrentStream(index)
        s = self.streams.get(key)
        if s is None:
            s = self.streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                      device_type=key[2])
        return s

    def event(self, stream):
        """A timing event recorded on `stream` (an event, once recorded, is
        bound to its device: the pool keeps one list a device)."""
        free = self.free.get(stream.device_index)
        e = free.pop() if free else torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def add(self, s):
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
            self.spans.append(s)
            if s.start is not None:
                self.pending.append(s)
                if len(self.pending) >= RESOLVE_EVERY:
                    self.resolve(wait=False)

    def resolve(self, wait):
        """Read the device times of the pending spans, oldest first: those
        finished (wait=False), or all of them, waiting for each (wait=True).
        Their events go back to the pool."""
        while self.pending:
            s = self.pending[0]
            if wait:
                s.end.synchronize()
            elif not s.end.query():
                return
            s.stream_ms = s.start.elapsed_time(s.end)
            self.free.setdefault(s.stream.device_index, []).extend((s.start, s.end))
            s.start = s.end = s.stream = None
            self.pending.popleft()

    def count(self, name, n):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def reset(self):
        with self.lock:
            self.spans.clear()
            self.pending.clear()
            self.counters.clear()
            self.dropped = 0

    def summary(self):
        with self.lock:
            self.resolve(wait=True)
            spans = list(self.spans)
            counters = dict(self.counters)
            dropped = self.dropped
        under = {}  # span id -> [children's host ns, children's stream ms]
        for s in spans:
            if s.parent is not None:
                c = under.setdefault(s.parent, [0, 0.0])
                c[0] += s.t1 - s.t0
                c[1] += s.stream_ms or 0.0
        calls = collections.Counter(s.name for s in spans)
        per = {}  # name -> {seq: [host ms, self ms, stream ms, stream self ms]}
        for s in spans:
            host = (s.t1 - s.t0) / 1e6
            kids = under.get(s.id, (0, 0.0))
            row = per.setdefault(s.name, {}).setdefault(s.seq, [0.0, 0.0, None, None])
            row[0] += host
            row[1] += host - kids[0] / 1e6
            if s.stream_ms is not None:
                row[2] = (row[2] or 0.0) + s.stream_ms
                row[3] = (row[3] or 0.0) + s.stream_ms - kids[1]
        out = {}
        for name, by_seq in per.items():
            rows = list(by_seq.values())
            out[name] = dict(calls=calls[name], top_level_calls=len(rows),
                             **{k: _median([r[i] for r in rows])
                                for i, k in enumerate(("host_ms", "self_ms", "stream_ms",
                                                       "stream_self_ms"))})
        return dict(spans=out, counters=counters, dropped=dropped)


def _median(values):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


_RECORDER = Recorder()


def _open(stack):
    """Whether a span entered on this thread, whose open spans are `stack`,
    records (the profiler records): inside a recorded span and not paused,
    or at the top level and not inside a graph capture."""
    if stack:
        return stack[-1] is not None
    return not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


def span(name, device=None, seq=None):
    """A context manager that records the span `name` while a profiler
    session records, else the shared no-op object. device: a CUDA device
    (its current stream is timed with events) or the CPU (the host time is
    the stream time). seq: the sequence number of the call whose work this
    span does (default: the enclosing span's, else a new one). The object
    entered has the span's number as `seq` (None when off)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    stack = _RECORDER.stack()
    if not _open(stack):
        return _OFF
    return _Span(name, torch.device(device) if device is not None else None, seq, stack)


def count(name, n=1):
    """Add n to the counter `name` while a profiler session records, where
    a span would record. n: a number, or a function of no arguments that
    gives it, called only then."""
    if _profiler._is_profiler_enabled and _open(_RECORDER.stack()):
        _RECORDER.count(name, n() if callable(n) else n)


@contextlib.contextmanager
def paused():
    """Nothing records inside, on this thread: for a CUDA-graph capture that
    may begin inside a recorded span, where a span's timing events would
    break the capture."""
    stack = _RECORDER.stack()
    stack.append(None)
    try:
        yield
    finally:
        stack.pop()


def summary():
    """{"spans": {name: {calls, top_level_calls, host_ms, self_ms,
    stream_ms, stream_self_ms}}, "counters": {name: total}, "dropped": n}.
    Each time is the median, over the top-level calls (sequence numbers)
    that hold the span, of the span's total in that call; self is the time
    minus what its child spans cover (stream self: minus the children's
    stream times); stream_ms is None for a span without a device. Waits
    for the device spans still running."""
    return _RECORDER.summary()


def reset():
    """Forget every span and counter recorded so far."""
    _RECORDER.reset()
