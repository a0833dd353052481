"""Profiling and timing: torch.profiler windows, device time by kernel.

Counterpart of autoregressive_diffusion_tpu/utils/profiling.py:
  * `trace(logdir)`: a torch.profiler window (host and, with a card, device
    activity) written as a Chrome trace into `logdir` on exit;
  * `annotate(name)`: a named range in the trace (record_function);
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
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


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
    costs a fraction of the time to record and to sum."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """A named range in the profiler's trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


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
