"""What every cell shares: finding its files by name, spans, the profiled window, the result.

A cell is `workloads/<cell>.json`; it names a configuration
(`configs/<config>.json`), a traffic mix (`traffic/<traffic>.json`) and a
driver (`drivers/<driver>.py`, one per kind of measured window). A
per-layer metric is `metrics/<metric>.py`, a reader of the traced window's
record. Adding any of them is adding a file; nothing here names one.

The profiled window records the card's activity alone (its kernels and
the runtime's launch calls). `window_record` reduces it: kernel time by
name, launch calls, the card's busy time (the union of its kernels'
intervals), and the idle gaps between kernels, each labelled by the
innermost benchmark span that was open on the host when the gap began.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
FORBIDDEN = ("jax", "jaxlib", "flax", "autoregressive_diffusion_tpu")


def read_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The cell `name` with its configuration and traffic read in."""
    cell = read_json("workloads", name)
    cell["name"] = name
    cell["config_spec"] = read_json("configs", cell["config"])
    cell["traffic_spec"] = read_json("traffic", cell["traffic"])
    return cell


def load_module(kind: str, name: str):
    """drivers/<name>.py or metrics/<name>.py, loaded by its file name."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"perf_bench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names() -> list:
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py") if not p.stem.startswith("_"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spans:
    """The benchmark's own host spans: (name, start ns, end ns, depth), on the
    wall clock that the profiler's events use."""

    def __init__(self):
        self.items = []
        self.depth = 0

    def span(self, name):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.time_ns()
                spans.depth += 1

            def __exit__(self, *exc):
                spans.depth -= 1
                spans.items.append((name, self.t0, time.time_ns(), spans.depth))
        return _Span()

    def label(self, t_ns: int) -> str:
        """The innermost span open at t_ns ("host" when none is)."""
        best = None
        for name, a, b, d in self.items:
            if a <= t_ns < b and (best is None or d > best[1]):
                best = (name, d)
        return best[0] if best else "host"


class Window:
    """A profiled sub-window: start() and stop() each synchronise the card,
    so that its wall time bounds the device work it holds."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        # a marker on both clocks: the window's first synchronise call
        self.mark = time.time_ns()
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()


def start_next(done: int, now: float, last: float, start: float, seconds: float) -> bool:
    """Whether a window that began at `start` and lasts `seconds` starts its
    next step at `now`: always the first; a later one only when its expected
    end, `now` plus the previous step's duration `last`, is inside it."""
    return done == 0 or now + last <= start + seconds


def host_usage() -> tuple:
    """(CPU seconds, voluntary, involuntary context switches) of this process so far."""
    import resource
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime, r.ru_nvcsw, r.ru_nivcsw


def host_window(before: tuple, wall_s: float) -> dict:
    """The host's share of a window: its CPU time over the wall time, and
    the context switches in it (the involuntary ones: other work took the core)."""
    after = host_usage()
    return {"cpu_share": (after[0] - before[0]) / wall_s, "switches": after[1] - before[1],
            "preempted": after[2] - before[2]}


def busy_and_gaps(intervals):
    """(busy time, [(gap, gap start)] longest first) of (start, end)
    intervals: the length of their union, and the holes between them."""
    busy, gaps, end = 0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((a - end, end))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, sorted(gaps, reverse=True)


def window_record(win: Window, spans: Spans, top: int = 10) -> dict:
    """Reduce a stopped Window: {"window_s", "busy_s", "launches",
    "kernel_s" {name: s}, "kernels" (count), "device_ops", "idle_gaps"}."""
    from torch.autograd import DeviceType
    counts, kernel_s, intervals, sync_starts = {}, {}, [], []
    for e in win.prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        name = e.name()
        counts[name] = counts.get(name, 0) + 1
        if e.device_type() == DeviceType.CPU:
            if name == "cudaDeviceSynchronize":
                sync_starts.append(e.start_ns())
            continue
        if e.is_user_annotation() or e.duration_ns() <= 0:
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + e.duration_ns() / 1e9
        intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    # the profiler's clock against the spans' clock, from the marker
    offset = (min(sync_starts) - win.mark) if sync_starts else 0
    busy_ns, gaps = busy_and_gaps(intervals)
    ops = sorted(kernel_s.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {"window_s": win.wall_s, "busy_s": busy_ns / 1e9,
            "launches": sum(counts.get(k, 0) for k in LAUNCH_CALLS),
            "kernels": sum(1 for _ in intervals), "kernel_s": kernel_s,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[spans.label(t - offset), g / 1e9] for g, t in gaps[:top]],
            "clock_offset_ns": offset}


def device_info(torch, count: int) -> dict:
    name = torch.cuda.get_device_name(0)
    power = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        power = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": name, "count": count, "power_limit_w": power}


def free_device(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| (float64)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def measure(cell: dict, seed: int, seconds: int, trace: bool, device: str, t0: float,
            **driver_args) -> dict:
    """One run of `cell`: its driver's window and check, then the result
    line's fields. trace: the per-layer metrics of the profiled sub-window,
    else the end-to-end metrics."""
    import math

    import torch
    driver = load_module("drivers", cell["driver"])
    rec = driver.run(cell, seed, seconds, trace, device, t0, **driver_args)
    if trace:
        metrics = {}
        for name in metric_names():
            mod = load_module("metrics", name)
            value = mod.read(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {name: {"value": v, "unit": u} for name, (v, u) in rec["e2e"].items()}
        metrics["setup_s"] = {"value": rec["setup_s"], "unit": "s"}
    is_cuda = torch.device(device).type == "cuda"
    dev = (device_info(torch, cell["chips"]) if is_cuda
           else {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit_w": None})
    dev["memory_peak_bytes"] = rec["memory_peak_bytes"]
    out = {"attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
           "device": dev, "window_step_s": rec.get("step_s", []),
           "host": rec.get("host", {})}
    if trace and "trace" in rec:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    if "info" in rec:
        out["info"] = rec["info"]
    checks = {name: {"value": v, "limit": lim} for name, v, lim in rec["checks"]}
    out["correct"] = (rec["failed"] == 0
                      and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values()))
    out["checks"] = checks  # the last key of the line
    return out
