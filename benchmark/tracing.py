"""The traced run's instruments: wrappers at the port's module attributes,
the profiler, and the reduction of its events to what the per-layer
metrics read.

Two passes over the same kind of request, after warm-up:

* the timing pass wraps each metric's ``TIMED`` targets (``"module:attr"``,
  the names the port looks them up by) so that each call ends in a
  synchronize and its host time is summed;
* the profile pass wraps each metric's ``SPANS`` targets in
  ``torch.profiler.record_function`` (no synchronize) and profiles the
  requests with ``torch.profiler`` (CPU and CUDA activity). Its events
  are reduced in memory: no trace file is written.

Span names are ``<module's last part>.<attr>``; the harness adds
``bench.request`` (the port's call and the synchronize after it) and
``bench.call`` (the port's call alone).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import time
from collections import Counter, defaultdict
from typing import NamedTuple

import torch

__all__ = ["Trace", "wrapped", "timer", "spanner", "profiled",
           "reduce_profile", "span_name", "LAUNCH_NAMES", "SYNC_NAMES"]

# CUDA runtime calls (and their cu* twins) that start a kernel, or that make
# the host wait for the device
LAUNCH_NAMES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaLaunchCooperativeKernel", "cudaGraphLaunch"})
SYNC_NAMES = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                        "cudaMemcpy3D"})
REQUEST = "bench.request"
CALL = "bench.call"


def span_name(target: str) -> str:
    module, attr = target.split(":")
    return f"{module.rsplit('.', 1)[-1]}.{attr}"


@contextlib.contextmanager
def wrapped(targets, make):
    """Replace each ``"module:attr"`` of ``targets`` by ``make(target, f)``
    for the duration of the block."""
    saved = []
    try:
        for target in dict.fromkeys(targets):
            module, attr = target.split(":")
            mod = importlib.import_module(module)
            f = getattr(mod, attr)
            saved.append((mod, attr, f))
            setattr(mod, attr, make(target, f))
        yield
    finally:
        for mod, attr, f in reversed(saved):
            setattr(mod, attr, f)


def timer(totals: dict, calls: Counter, sync):
    """``make`` for :func:`wrapped`: the host time of each call, ended by
    ``sync()``, summed by target."""
    def make(target, f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                sync()
                totals[target] = totals.get(target, 0.0) \
                    + time.perf_counter() - t
                calls[target] += 1
        return run
    return make


def spanner(target, f):
    """``make`` for :func:`wrapped`: a ``record_function`` span a call."""
    name = span_name(target)

    @functools.wraps(f)
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return f(*args, **kwargs)
    return run


class Trace(NamedTuple):
    """What the per-layer metrics read. Times in seconds.

    ``timed``/``timed_calls``: the timing pass's summed host time and calls
    by target, over ``timed_requests`` requests. ``requests``: the profiled
    requests; ``window_s`` their wall (each from the call to the end of the
    synchronize after it), ``busy_s`` the union of device activity within
    it; ``kernels``: device time by kernel name; ``runtime``: runtime calls
    by name within the port's calls; ``in_span``: runtime calls by (span,
    name) within each harness span; ``idle``: idle device time by the
    innermost harness span open when the gap began; ``context``: each
    profiled request's facts from its entry (sweeps, stages); ``config``:
    the cell's configuration."""

    timed: dict
    timed_calls: dict
    timed_requests: int
    requests: int
    window_s: float
    busy_s: float
    kernels: dict
    runtime: Counter
    in_span: Counter
    idle: dict
    context: list
    config: dict


def _events(prof):
    """``(name, is_device, is_annotation, start_s, end_s)`` of every event,
    from the profiler's raw results."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            dev = str(e.device_type()).endswith("CUDA")
            out.append((e.name(), dev, bool(e.is_user_annotation()),
                        e.start_ns() * 1e-9,
                        (e.start_ns() + e.duration_ns()) * 1e-9))
        return out
    for e in prof.events():
        dev = str(e.device_type).endswith("CUDA")
        out.append((e.name, dev, False, e.time_range.start * 1e-6,
                    e.time_range.end * 1e-6))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Spans:
    """Each span name's intervals, sorted, for lookups by time (spans of one
    name do not nest)."""

    def __init__(self, spans: dict):
        self.by_name = {n: (sorted(v), [s for s, _ in sorted(v)])
                        for n, v in spans.items() if v}

    def containing(self, t: float):
        """``(duration, name)`` of each span open at ``t``."""
        out = []
        for n, (iv, starts) in self.by_name.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][1] >= t:
                out.append((iv[i][1] - iv[i][0], n))
        return out


def reduce_profile(prof, span_names, context, config, timed=None,
                   timed_calls=None, timed_requests=0) -> Trace:
    """Reduce a finished profile of whole requests to a :class:`Trace`."""
    events = _events(prof)
    names = set(span_names) | {REQUEST, CALL}
    spans = defaultdict(list)
    device, runtime_ev = [], []
    for name, dev, ann, s, e in events:
        if dev:
            if not ann and name not in names:
                device.append((name, s, e))
        elif name in names:
            spans[name].append((s, e))
        elif name.startswith("cu"):
            runtime_ev.append((name, s))
    windows = sorted(spans[REQUEST])
    window_s = sum(e - s for s, e in windows)
    clipped, kernels = [], defaultdict(float)
    for name, s, e in device:
        for ws, we in windows:
            a, b = max(s, ws), min(e, we)
            if b > a:
                clipped.append((a, b))
                kernels[name] += b - a
    busy = _merge(clipped)
    busy_s = sum(e - s for s, e in busy)
    calls = _Spans({CALL: spans[CALL]})
    named = _Spans({n: spans[n] for n in names - {REQUEST}})
    runtime, in_span = Counter(), Counter()
    for name, t in runtime_ev:
        if calls.containing(t):
            runtime[name] += 1
        for _, n in named.containing(t):
            in_span[(n, name)] += 1
    idle = defaultdict(float)
    for ws, we in windows:
        cur = ws
        inner = [b for b in busy if b[1] > ws and b[0] < we] + [[we, we]]
        for s, e in inner:
            if s > cur:
                open_ = named.containing(cur)
                who = min(open_)[1] if open_ else REQUEST
                idle[who] += min(s, we) - cur
            cur = max(cur, e)
    return Trace(timed or {}, dict(timed_calls or {}), timed_requests,
                 len(windows), window_s, busy_s, dict(kernels), runtime,
                 in_span, dict(idle), context, config)


def profiled():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
