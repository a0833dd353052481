"""Profiling and timing: torch.profiler windows, device time by kernel.

Counterpart of autoregressive_diffusion_tpu/utils/profiling.py:
  * `trace(logdir)`: a torch.profiler window (host and, with a card, device
    activity) written as a Chrome trace into `logdir` on exit;
  * `annotate(name)`: a named range in the trace (record_function);
  * `top_ops(prof)`: the kernels with the most device time in a window;
  * `benchmark(fn)`: warm-up calls, then the marginal time a call between
    a short and a long run, each ending in torch.cuda.synchronize.

`key_averages()` lists host operators and device kernels side by side, and a
host operator's self device time repeats the time of the kernels it
launched. Summing every row therefore counts device time twice; the sums
here take the device-side rows only, and leave out the device-side copies
of user annotations (such as the optimizer's step range), which span the
kernels launched inside them.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch
from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def kernel_times(prof) -> dict:
    """{kernel name: total device microseconds} over the profiled window,
    from the device-side events only."""
    out = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CPU and _device_us(e) > 0
                and not getattr(e, "is_user_annotation", False)):
            out[e.key] = out.get(e.key, 0.0) + _device_us(e)
    return out


def window_summary(prof, wall_s: float, n: int) -> dict:
    """Per-call (or per-step) summary of a window of n calls that took
    wall_s seconds: device busy ms, idle share, kernel launches, aten ops,
    and the kernels with the most device time."""
    kernels = kernel_times(prof)
    busy_us = sum(kernels.values())
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:12]
    return {"wall_ms": wall_s * 1e3 / n, "device_busy_ms": busy_us / 1e3 / n,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
            "kernel_launches": launches / n,
            "host_ops": sum(e.count for e in events if e.key.startswith("aten::")) / n,
            "top_device_ms": [[k[:80], us / 1e3 / n] for k, us in top]}


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace.json"):
    """Profile the block (the card's kernels too when torch has CUDA) and
    write a Chrome trace to logdir/name; yields the profiler, for
    `kernel_times`, `top_ops` and `window_summary`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """A named range in the profiler's trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


def top_ops(prof, n: int = 25) -> list:
    """[(device ms, count, kernel name)] of the n kernels with the most
    device time in the window, from the device-side events only."""
    counts = {e.key: e.count for e in prof.key_averages()}
    ranked = sorted(kernel_times(prof).items(), key=lambda kv: kv[1], reverse=True)[:n]
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
