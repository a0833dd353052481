"""Join a profiled window's launches and kernels to the program's spans.

The program records its spans (`autoregressive_diffusion_tpu_torch.utils.
profiling.span`, inside `profiling.tracing()`) on the host's wall clock,
time.time_ns(): records with an id, a parent id, the native id of the
thread that opened them, a name, attributes and two times. The profiler
records the runtime's calls (cudaLaunchKernel, cudaMemcpyAsync, ...) and
the card's kernels and copies on its own clock. Markers give the offset
between the two clocks: `SpanWindow` reads the span clock just before and
just after each of a few cudaDeviceSynchronize calls on an idle card, so
each call's event [start, end] bounds the offset to [end - after, start -
before]; the tightest bounds' midpoint is the offset, half their width its
error. (`harness.window_record` takes the time before the window's first
synchronise alone; that call also pays the profiler's set-up, tens of
microseconds, which would move launches across span boundaries.) Then:

  * each device event maps to the runtime call that issued it, by
    correlation id;
  * each runtime call maps to the innermost program span open at its start
    (moved onto the span clock) on the calling thread; where that thread has
    none open, to the innermost open on the thread of the root spans: a
    backward's launches come from autograd's thread, inside the main
    thread's train.backward;
  * each idle gap of the card is labelled by the innermost span open when it
    began, the program's or the benchmark's (`harness.Spans`).

A call's "self" span is that innermost span; it counts "inclusive" under
the span and every ancestor. `SpanWindow` is a profiled sub-window
(`harness.Window`) with the program's tracer on; `rollout_metrics` and
`train_metrics` read the joined window per cached model call or per train
step.
"""
from __future__ import annotations

import time
from collections import defaultdict

from perf_bench import harness

UPDATE_SPANS = ("train.optimizer", "train.weight_norm", "train.ema")
MARKERS = 5  # synchronises timed on both clocks at a SpanWindow's start


def offset_ns(events, marks) -> tuple:
    """(offset, error) of the profiler's clock against the span clock, from
    marker events [(start, end)] on the profiler's clock and the span-clock
    times [(before, after)] read around each, in the same order: the
    midpoint of the tightest bounds, and half their width (negative if they
    disagree)."""
    if not events or len(events) != len(marks):
        raise ValueError(f"{len(events)} marker events for {len(marks)} marks")
    lo = max(end - after for (_, end), (_, after) in zip(events, marks))
    hi = min(start - before for (start, _), (before, _) in zip(events, marks))
    return (lo + hi) // 2, (hi - lo) // 2


def read_events(prof, marker: str = "cudaDeviceSynchronize"):
    """(calls, device_s, intervals, markers) of a stopped profiler:
    calls [(start ns, thread, correlation id, name)] of the host-side
    runtime calls (correlation id not 0); device_s {correlation id: device
    seconds} of the card's kernels, copies and sets (not annotations);
    intervals [(start, end)] of those device events; [(start, end)] of the
    host events named `marker`, in order."""
    from torch.autograd import DeviceType
    calls, device_s, intervals, marks = [], defaultdict(float), [], []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CPU:
            if e.name() == marker:
                marks.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            if e.correlation_id():
                calls.append((e.start_ns(), e.start_thread_id(), e.correlation_id(), e.name()))
            continue
        if e.is_user_annotation() or e.duration_ns() <= 0:
            continue
        device_s[e.correlation_id()] += e.duration_ns() / 1e9
        intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return calls, dict(device_s), intervals, sorted(marks)


def innermost(intervals, times) -> list:
    """For each time of `times`, the key of the innermost interval of
    `intervals` [(start, end, key)] that holds it (start <= t < end), or
    None. The intervals nest, as one thread's spans do."""
    order = sorted(intervals, key=lambda s: (s[0], -s[1]))
    out = [None] * len(times)
    stack, i = [], 0
    for qi in sorted(range(len(times)), key=times.__getitem__):
        t = times[qi]
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[qi] = stack[-1][2]
    return out


def root_threads(spans) -> set:
    return {s.thread for s in spans if s.parent is None}


def span_of(spans, times, threads, offset: int) -> list:
    """The id of the span each host event (profiler time, thread) is
    attributed to, or None: the innermost open on its thread, else on a
    root span's thread."""
    shifted = [t - offset for t in times]
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s.thread].append((s.t0_ns, s.t1_ns, s.id))
    out = [None] * len(times)
    for th, ivs in by_thread.items():
        idx = [i for i, t in enumerate(threads) if t == th]
        for i, sid in zip(idx, innermost(ivs, [shifted[i] for i in idx])):
            out[i] = sid
    missing = [i for i, sid in enumerate(out) if sid is None]
    main = root_threads(spans)
    roots = [(s.t0_ns, s.t1_ns, s.id) for s in spans if s.thread in main]
    for i, sid in zip(missing, innermost(roots, [shifted[i] for i in missing])):
        out[i] = sid
    return out


def attribute(calls, device_s, spans, offset: int) -> dict:
    """{span id or None: [launch calls, device seconds]} of each call's self
    span: the launches among the calls (harness.LAUNCH_CALLS), and the
    device time of the events each call issued."""
    ids = span_of(spans, [c[0] for c in calls], [c[1] for c in calls], offset)
    out = defaultdict(lambda: [0, 0.0])
    for (_, _, corr, name), sid in zip(calls, ids):
        row = out[sid]
        row[0] += name in harness.LAUNCH_CALLS
        row[1] += device_s.get(corr, 0.0)
    return dict(out)


def chain(spans_by_id: dict, sid) -> list:
    """The names of span `sid` and its ancestors, innermost first."""
    names = []
    while sid is not None:
        s = spans_by_id[sid]
        names.append(s.name)
        sid = s.parent
    return names


def under(att: dict, spans, names, but=()) -> tuple:
    """(launch calls, device seconds) of the calls whose self span is, or
    descends from, a span named in `names`, and from none named in `but`."""
    by_id = {s.id: s for s in spans}
    launches, secs = 0, 0.0
    for sid, (n, d) in att.items():
        c = set(chain(by_id, sid))
        if c & set(names) and not c & set(but):
            launches += n
            secs += d
    return launches, secs


def by_name(att: dict, spans) -> dict:
    """{span name: {count, host_ms, self_launches, launches, self_device_ms,
    device_ms}}: each name's spans, their summed duration, and the calls
    attributed to them alone (self) and with their descendants (inclusive,
    a call counted once a name)."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        row = out.setdefault(s.name, dict(count=0, host_ms=0.0, self_launches=0, launches=0,
                                          self_device_ms=0.0, device_ms=0.0))
        row["count"] += 1
        row["host_ms"] += (s.t1_ns - s.t0_ns) / 1e6
    for sid, (n, d) in att.items():
        if sid is None:
            continue
        names = chain(by_id, sid)
        out[names[0]]["self_launches"] += n
        out[names[0]]["self_device_ms"] += d * 1e3
        for name in set(names):
            out[name]["launches"] += n
            out[name]["device_ms"] += d * 1e3
    return out


def label_gaps(gaps, offset: int, spans, bench_items, top: int = 10) -> list:
    """[[label, seconds]] of the `top` longest gaps [(length ns, start ns on
    the profiler's clock)], longest first: the innermost span open at the
    gap's start among the root thread's program spans and the benchmark's
    (name, start, end, depth) spans; "host" where none is."""
    roots = root_threads(spans)
    ivs = [(s.t0_ns, s.t1_ns, s.name) for s in spans if s.thread in roots]
    ivs += [(a, b, name) for name, a, b, _ in bench_items]
    gaps = sorted(gaps, reverse=True)[:top]
    labels = innermost(ivs, [t - offset for _, t in gaps])
    return [[lab or "host", g / 1e9] for (g, _), lab in zip(gaps, labels)]


def inside(times, offset: int, intervals) -> list:
    """For each profiler time, whether it falls inside one of the
    (start, end) span-clock intervals."""
    hit = innermost([(a, b, True) for a, b in intervals], [t - offset for t in times])
    return [bool(h) for h in hit]


def rollout_metrics(att: dict, spans) -> dict:
    """The rollout's per-call numbers of a window whose model calls are all
    cached ones ({} if any is not, or there is none): device ms and launch
    calls under model.attention, launch calls under model.block outside
    attention, each per cached call, and the mean host ms of a cached
    model.call span."""
    calls = [s for s in spans if s.name == "model.call"]
    if not calls or any(s.attrs.get("mode") != "cached" for s in calls):
        return {}
    n = len(calls)
    a_launches, a_s = under(att, spans, ["model.attention"])
    b_launches, _ = under(att, spans, ["model.block"], but=["model.attention"])
    return {"attention_ms.rollout": 1e3 * a_s / n, "attention_launches.rollout": a_launches / n,
            "block_launches.rollout": b_launches / n,
            "call_host_ms.rollout": sum(s.t1_ns - s.t0_ns for s in calls) / n / 1e6}


def train_metrics(att: dict, spans) -> dict:
    """The update's device ms and launch calls (train.optimizer,
    train.weight_norm, train.ema) per train.step of the window ({} if it
    holds no step)."""
    n = sum(s.name == "train.step" for s in spans)
    if not n:
        return {}
    launches, secs = under(att, spans, UPDATE_SPANS)
    return {"update_ms.train": 1e3 * secs / n, "update_launches.train": launches / n}


class SpanWindow:
    """A profiled sub-window (harness.Window: the card's activity alone)
    with the program's tracer on between start() and stop()."""

    def __init__(self, torch):
        from autoregressive_diffusion_tpu_torch.utils import profiling
        self.torch = torch
        self.window = harness.Window(torch)
        self.tracing = profiling.tracing()
        self.spans = None

    def start(self):
        self.window.start()  # its synchronises are the window's first two
        self.marks = []
        for _ in range(MARKERS):
            before = time.time_ns()
            self.torch.cuda.synchronize()
            self.marks.append((before, time.time_ns()))
        self.spans = self.tracing.__enter__()

    def stop(self):
        self.tracing.__exit__(None, None, None)
        self.window.stop()

    def record(self, bench: harness.Spans, top: int = 10) -> dict:
        """The joined window: {"window_s", "launches", "offset_ns",
        "offset_error_ns", "first_offset_ns" (harness.window_record's rule),
        "by_name", "unattributed" [launches, device s], "idle_gaps", "att",
        "spans", "calls"}."""
        calls, device_s, intervals, syncs = read_events(self.window.prof)
        off, err = offset_ns(syncs[1:1 + MARKERS], self.marks)
        att = attribute(calls, device_s, self.spans, off)
        _, gaps = harness.busy_and_gaps(intervals)
        return {"window_s": self.window.wall_s,
                "launches": sum(c[3] in harness.LAUNCH_CALLS for c in calls),
                "offset_ns": off, "offset_error_ns": err,
                "first_offset_ns": syncs[0][0] - self.window.mark,
                "by_name": by_name(att, self.spans),
                "unattributed": att.get(None, [0, 0.0]),
                "idle_gaps": label_gaps(gaps, off, self.spans, bench.items, top),
                "att": att, "spans": self.spans, "calls": calls}
