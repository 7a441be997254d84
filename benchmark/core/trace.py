"""Reading the device from a torch.profiler trace.

A frozen copy of the method the port's on-card checks use (`profiled`,
`device_events`, `busy_share`): the counted window is bracketed on the
device's own clock by two spin kernels (torch.cuda._sleep), because the
trace has been seen to lose a kernel launched right after it starts and the
host's range start to fall after the first kernels of a replay; what ran on
the device is every kernel, copy and set between the two spins, and the
busy time is the union of their intervals, each instant counted once.

`Segment` wraps a run of calls of a loop: the profiler starts before the
window and stops after the bracket; the calls between its start and the
bracket warm the trace.
"""

from __future__ import annotations

import time

SPIN = "spin_kernel"      # torch.cuda._sleep's kernel
SPIN_CYCLES = 1000
TOP = 10                  # entries of each breakdown list


class Segment:
    """Profile the calls of a loop from call `start` to call `stop`:
    open() enters the profiler before the window (its start costs a second
    or more, which would stall the window); before(i) and after(i) are
    called around call i; the spin kernels bracket calls start..stop-1."""

    def __init__(self, start, stop):
        self.start, self.stop = start, stop
        self.prof = None
        self.calls = 0
        self.open_s = self.close_s = None

    def open(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def before(self, i):
        import torch

        if i == self.start and self.prof is not None:
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            self.open_s = time.perf_counter()

    def after(self, i):
        if self.open_s is None or self.close_s is not None:
            return
        self.calls += 1
        if i == self.stop - 1:
            self.finish()

    def finish(self):
        """Close the bracket and the profiler (also when the loop ended
        before `stop`)."""
        import torch

        if self.prof is None or self.close_s is not None:
            return
        if self.open_s is not None:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            self.close_s = time.perf_counter()
        self.prof.__exit__(None, None, None)
        if self.close_s is None:
            self.close_s = -1.0

    def read(self):
        """The summary of the profiled window, or None."""
        if self.open_s is None or self.close_s is None or self.close_s < 0:
            return None
        return summarize(self.prof, self.calls)


def _device_type():
    from torch.autograd import DeviceType

    return DeviceType.CUDA


def summarize(prof, calls):
    """{window_s, busy_s, calls, ops: {kernel name: seconds}, gaps: [(host op,
    seconds)]} of the window between the two spin kernels."""
    events = list(prof.events())
    cuda = _device_type()
    dev = [e for e in events if e.device_type == cuda]
    spins = sorted((e.time_range.start, e.time_range.end) for e in dev if SPIN in e.name)
    if len(spins) < 2:
        raise RuntimeError(f"the trace holds {len(spins)} {SPIN} events, not the 2 that "
                           "bracket its window on the device")
    lo, hi = spins[0][1], spins[-1][0]
    # a host range (record_function) also shows up as a device-side
    # annotation under its own name: not work on the device
    host_names = {e.name for e in events if e.device_type != cuda}
    inside = [e for e in dev if SPIN not in e.name and e.name not in host_names
              and lo <= e.time_range.start <= hi and e.time_range.end > e.time_range.start]
    spans = sorted((e.time_range.start, min(e.time_range.end, hi)) for e in inside)
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    ops = {}
    for e in inside:
        ops[e.name] = ops.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    host = [e for e in events if e.device_type != cuda]
    named = []
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (s + t) / 2
        active = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        # the innermost host op running at the middle of the gap
        name = (min(active, key=lambda e: e.time_range.end - e.time_range.start).name
                if active else "host idle (no op traced)")
        named.append((name, (t - s) / 1e6))
    return dict(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6, calls=calls, ops=ops, gaps=named)


def breakdown(summary):
    """The result line's breakdown: the device ops that took most time and
    the longest idle gaps by the host op active in them."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in summary["gaps"][:TOP]]}
