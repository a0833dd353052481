"""Profiling and timing: the program's spans, torch.profiler windows, device time by kernel.

Counterpart of autoregressive_diffusion_tpu/utils/profiling.py:
  * `span(name, **attrs)`: a span at a layer boundary of the program (the
    model call, each Block and attention layer, the sampler's frame, the
    train step's phases); `tracing()` records them in memory, and inside a
    `trace` window each is also a named range of the profiler's trace;
  * `trace(logdir)`: a torch.profiler window (host and, with a card, device
    activity) written as a Chrome trace into `logdir` on exit;
  * `top_ops(prof)`: the kernels with the most device time in a window;
  * `benchmark(fn)`: warm-up calls, then the marginal time a call between
    a short and a long run, each ending in torch.cuda.synchronize;
  * `device_ms(fn)`: the card's time a call, the calls queued behind a
    sleeping kernel so that the host's cost of launching them is hidden.

The sums here read the profiler's raw events (`event_totals`), not
`key_averages()`, which first builds a Python object an event, tens of
microseconds each: a rollout frame's window records about 8e5 events (its
launches and kernels). They take the device-side events only (a host
operator's device time repeats its kernels'), and leave out the
device-side copies of user annotations (such as the optimizer's step
range), which span the kernels launched inside them.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


class Span(NamedTuple):
    """One recorded span. Times are time.time_ns(); `thread` is the native
    id of the thread that opened it; `root` is the id of the outermost span
    it descends from (its own id for a root): the spans of one frame or one
    train step share it."""
    id: int
    parent: Optional[int]
    root: int
    thread: int
    name: str
    attrs: dict
    t0_ns: int
    t1_ns: int


class _Tracer:
    """The records of one `tracing()` block and the open spans of each thread."""

    def __init__(self):
        self.records = []
        self.ids = itertools.count(1)
        self.open = {}  # native thread id -> [(span id, root id)] of its open spans
        self.root_thread = None  # the thread whose open spans include a root

    def parent_of(self, thread: int):
        """(parent id, root id) for a span opened on `thread` now: the
        innermost span open on that thread; on a thread with none open
        (autograd's, running a backward or a remat'd Block's recompute), the
        innermost open on the thread that opened the current root."""
        stack = self.open.get(thread)
        if not stack and self.root_thread is not None:
            stack = self.open.get(self.root_thread)
        return stack[-1] if stack else (None, None)


class _Sink(NamedTuple):
    tracer: Optional[_Tracer]  # spans are recorded (tracing())
    annotate: bool             # spans are record_function ranges (trace())


_sink: Optional[_Sink] = None  # None: span() returns _NULL
_NULL = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("sink", "name", "attrs", "rf", "sid", "parent", "root", "thread", "t0")

    def __init__(self, sink: _Sink, name: str, attrs: dict):
        self.sink, self.name, self.attrs = sink, name, attrs

    def __enter__(self):
        tr = self.sink.tracer
        if tr is not None:
            self.thread = threading.get_native_id()
            self.parent, root = tr.parent_of(self.thread)
            self.sid = next(tr.ids)
            self.root = self.sid if root is None else root
            stack = tr.open.setdefault(self.thread, [])
            if self.parent is None:
                tr.root_thread = self.thread
            stack.append((self.sid, self.root))
            self.t0 = time.time_ns()
        if self.sink.annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.sink.annotate:
            self.rf.__exit__(*exc)
        tr = self.sink.tracer
        if tr is not None:
            t1 = time.time_ns()
            tr.open[self.thread].pop()
            tr.records.append(Span(self.sid, self.parent, self.root, self.thread, self.name,
                                   self.attrs, self.t0, t1))
        return False


def span(name: str, /, **attrs):
    """A context manager around one layer boundary of the program. Off (the
    default) it reads one module global and returns a shared null context:
    no record, no clock, no synchronise, no launch. Inside `tracing()` it
    records a `Span` on exit; inside a `trace` window it is also a
    record_function range named `name`, so the window's Chrome trace shows
    it."""
    sink = _sink
    if sink is None:
        return _NULL
    return _OpenSpan(sink, name, attrs)


@contextlib.contextmanager
def tracing():
    """Record the program's spans in the block: yields the list that each
    closed span is appended to (`Span`s, in the order they close). The
    state before the block is restored on exit."""
    global _sink
    prev = _sink
    tracer = _Tracer()
    _sink = _Sink(tracer, prev is not None and prev.annotate)
    try:
        yield tracer.records
    finally:
        _sink = prev


def event_totals(prof) -> tuple:
    """({event name: count} of every event, {device-side event name: total
    device microseconds}) over the profiled window; hidden events are left
    out, as key_averages() leaves them out."""
    counts, device = {}, {}
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        counts[name] = counts.get(name, 0) + 1
        if e.device_type() != DeviceType.CPU and not e.is_user_annotation():
            us = e.duration_ns() / 1e3
            if us > 0:
                device[name] = device.get(name, 0.0) + us
    return counts, device


def kernel_times(prof) -> dict:
    """{kernel name: total device microseconds} over the profiled window,
    from the device-side events only."""
    return event_totals(prof)[1]


def window_summary(prof, wall_s: float, n: int) -> dict:
    """Per-call (or per-step) summary of a window of n calls that took
    wall_s seconds: device busy ms, idle share, kernel launches, aten ops
    (every dispatch: an op that calls an overload of its own name counts
    twice, where key_averages() merges the two), and the kernels with the
    most device time."""
    counts, kernels = event_totals(prof)
    busy_us = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:12]
    return {"wall_ms": wall_s * 1e3 / n, "device_busy_ms": busy_us / 1e3 / n,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "kernel_launches": sum(counts.get(k, 0) for k in LAUNCH_CALLS) / n,
            "host_ops": sum(c for k, c in counts.items() if k.startswith("aten::")) / n,
            "top_device_ms": [[k[:80], us / 1e3 / n] for k, us in top]}


@contextlib.contextmanager
def trace(logdir: Optional[str], name: str = "trace.json", host: bool = True):
    """Profile the block (the card's kernels too when torch has CUDA) and
    write a Chrome trace to logdir/name (logdir None: no file); yields the
    profiler, for `kernel_times`, `top_ops` and `window_summary`. With a
    card, host=False records the card's activity alone (its kernels and the
    runtime's launch calls, no aten ops): a window of 10^5 launches then
    costs a fraction of the time to record and to sum. Inside the window
    the program's spans are record_function ranges (`span`)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    global _sink
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
    prev = _sink
    with profile(activities=acts) as prof:
        _sink = _Sink(prev.tracer if prev is not None else None, True)
        try:
            yield prof
        finally:
            _sink = prev
    if logdir is not None:
        prof.export_chrome_trace(os.path.join(logdir, name))


def top_ops(prof, n: int = 25) -> list:
    """[(device ms, count, kernel name)] of the n kernels with the most
    device time in the window, from the device-side events only."""
    counts, kernels = event_totals(prof)
    ranked = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [(us / 1e3, counts.get(name, 0), name) for name, us in ranked]


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 10,
              **kwargs) -> Dict[str, float]:
    """Time fn(*args, **kwargs): `warmup` calls first (kernel builds, the
    allocator), then a short and a long run, each ended by
    torch.cuda.synchronize; the time a call is the marginal cost between
    them, which leaves out the fixed cost of a run. Returns dict(mean_s,
    short_s, long_s, iters, device)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            fn(*args, **kwargs)
        _synchronize()
        return time.perf_counter() - t0

    short = max(iters // 10, 1)
    run(short)
    t_short, t_long = run(short), run(iters)
    device = (torch.cuda.get_device_name() if torch.cuda.is_available()
              and torch.cuda.is_initialized() else "cpu")
    return dict(mean_s=(t_long - t_short) / (iters - short), short_s=t_short, long_s=t_long,
                iters=float(iters), device=device)


def device_ms(fn: Callable, iters: int = 30, warmup: int = 3) -> float:
    """Device time of a call (ms): the timed calls are queued behind a
    sleeping kernel, so the host's cost of launching them (Python, ctypes,
    tensor maps) overlaps the sleep and the CUDA events see the kernels
    back to back. The sleep doubles until it outlasts the queueing. fn must
    not synchronise (no host-device copies)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 5_000_000
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()  # the card was still asleep when the last call was queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("device_ms: the sleep never outlasted the queueing")
