"""The traced window: ``torch.profiler`` over whole epochs or a whole run of
calls, reduced to the numbers the per-layer readers take.

* device operations: the trace's kernels, copies and sets on the card
  (not its annotations); their union is the busy time, and the window
  less it the idle time;
* operation counts, and the device time of NCCL's kernels (the
  all-reduce);
* ``breakdown``: the device operations with the most time, and the
  longest idle gaps, each named by the innermost host operation open
  at its middle on the thread that launched the most work.

A trace that holds no device record is never reduced: the window is run
again, as ``chip_smoke.py`` retries its traces (up to :data:`TRIES`
times), and a run whose every try comes back empty fails.
"""

import time
import typing

import numpy as np
import torch

TRIES = 4
TOP = 10
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160


class Events(typing.NamedTuple):
    """Device operations and host operations of one trace, times in ns."""

    device: typing.List[typing.Tuple[str, int, int]]  # (name, start, end)
    host: typing.List[typing.Tuple[str, int, int, int]]  # (name, start, end, thread)


def _activity(event) -> str:
    try:
        return str(event.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def events_of(profiler) -> Events:
    """The kineto events of a finished ``torch.profiler.profile``."""
    device, host = [], []
    for e in profiler.profiler.kineto_results.events():
        start, dur = int(e.start_ns()), int(e.duration_ns())
        kind = _activity(e)
        on_device = "cuda" in str(e.device_type()).lower()
        if on_device:
            if kind and not any(k in kind for k in DEVICE_ACTIVITIES):
                continue  # annotations mirrored on the device
            device.append((e.name(), start, start + dur))
        else:
            host.append((e.name(), start, start + dur, int(e.start_thread_id())))
    return Events(device, host)


def union(intervals: typing.Sequence[typing.Tuple[int, int]]) -> typing.List[typing.Tuple[int, int]]:
    """Merged, sorted [start, end) intervals."""
    merged: typing.List[typing.List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(events: Events, window_s: float) -> dict:
    """busy_s, idle share, operation counts, NCCL seconds and the breakdown
    of one trace whose host-clock window lasted ``window_s``."""
    spans = union([(s, e) for _, s, e in events.device])
    busy_s = sum(e - s for s, e in spans) * 1e-9
    per_name: typing.Dict[str, float] = {}
    nccl_s = 0.0
    for name, s, e in events.device:
        per_name[name] = per_name.get(name, 0.0) + (e - s) * 1e-9
        if "nccl" in name.lower():
            nccl_s += (e - s) * 1e-9
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1], spans[i + 1][0])
                   for i in range(len(spans) - 1)), reverse=True)[:TOP]
    name_at = HostNamer(events)
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": len(events.device),
        "nccl_s": nccl_s,
        "device_ops_top": [[_short(n), t] for n, t in top],
        "idle_gaps": [[_short(name_at((a + b) // 2)), g * 1e-9] for g, a, b in gaps],
    }


class HostNamer:
    """Names a moment by the innermost host operation open then on the
    thread that launched the most work ("none" where nothing is open)."""

    def __init__(self, events: Events):
        self.host = events.host
        threads = [h[3] for h in events.host if "launch" in h[0].lower()]
        self.main = max(set(threads), key=threads.count) if threads else None
        self.starts = np.asarray([h[1] for h in events.host], np.int64)
        self.ends = np.asarray([h[2] for h in events.host], np.int64)
        self.tids = np.asarray([h[3] for h in events.host], np.int64)

    def __call__(self, t: int) -> str:
        if not self.host:
            return "none"
        open_ = (self.starts <= t) & (self.ends >= t)
        if self.main is not None and np.any(open_ & (self.tids == self.main)):
            open_ &= self.tids == self.main
        if not np.any(open_):
            return "none"
        idx = np.flatnonzero(open_)
        return "host: " + self.host[int(idx[np.argmax(self.starts[idx])])][0]


def traced(run: typing.Callable[[], typing.Any], device) -> typing.Tuple[typing.Any, dict]:
    """Run ``run`` (a whole traced window, which ends on the device) under
    the profiler -> (its result, :func:`summarize` of the trace).  Retried
    while the trace holds no device record; RuntimeError after
    :data:`TRIES` empty tries."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRIES):
        torch.cuda.synchronize(device)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        start = time.perf_counter()
        try:
            result = run()
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - start
        finally:
            prof.__exit__(None, None, None)
        events = events_of(prof)
        if events.device:
            return result, summarize(events, window_s)
    raise RuntimeError(f"no device record in {TRIES} traces of the window")
