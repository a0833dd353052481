"""Reading a torch.profiler window: device time by kernel.

`key_averages()` lists host operators and device kernels side by side, and a
host operator's self device time repeats the time of the kernels it
launched. Summing every row therefore counts device time twice; the sums
here take the device-side rows only, and leave out the device-side copies
of user annotations (such as the optimizer's step range), which span the
kernels launched inside them.
"""
from __future__ import annotations

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
