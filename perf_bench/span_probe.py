"""Run one cell as `run.py --trace 1` does, plus a second sub-window with the program's spans.

    python3 perf_bench/span_probe.py --workload <cell> --seed <n> --seconds <s> [--out F.json]

The drivers profile one sub-window with the program's tracer off (the
rollout's cached calls [8, 32), training's cycle 1), which the per-layer
metrics read. This script wraps the drivers from outside, leaving their
files and that window as they are, and opens a second sub-window the same
way (attribution.SpanWindow: harness.Window with `profiling.tracing()` on)
over the rollout's cached calls [32, 56), inside the first frame step, or
training's cycle 2. It joins that window's launches, kernels and idle gaps
to the program's spans (attribution.py) and prints one JSON line: the run's
per-layer metrics of the first window, the span window's metrics
(attribution.rollout_metrics / train_metrics), both windows' wall time and
launch calls a call or step (the tracer's overhead), each span name's
launches and device ms, the labelled idle gaps, and the checks: the share
of launch calls inside the benchmark's denoiser_call (train_step) spans
that fall inside a model.call (train.step) span, and the modes of the
window's model calls. --out also writes the line to a file.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPAN_FIRST_CALL = 32  # the rollout's span window: cached calls [32, 32 + 24)
SPAN_CYCLE = 2  # training's span window: the window's third cycle


def rollout_wrap(driver, attribution, torch):
    """Replace the driver's Denoiser by one that also opens the span window."""
    base = driver.Denoiser
    made = []

    class SpanDenoiser(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.span_window = attribution.SpanWindow(torch) if self.window else None
            made.append(self)

        def forward(self, *args, **kw):
            first, n = SPAN_FIRST_CALL, driver.TRACE_CALLS
            if self.span_window is not None and self.calls == first:
                self.span_window.start()
            out = super().forward(*args, **kw)
            if self.span_window is not None and self.calls == first + n:
                self.span_window.stop()
                self.span_calls = n
            return out

    driver.Denoiser = SpanDenoiser
    return made


def train_wrap(driver, attribution, torch):
    """Wrap the driver's batch maker and step function so that the span
    window holds the steps of cycle SPAN_CYCLE, from the first step's batch
    to the last step's return."""
    holder = {}
    make_batch_fn, build = driver.make_batch_fn, driver.build

    def first_last(tr):
        first = driver.SETUP_STEPS + SPAN_CYCLE * tr["just_2d_every"]
        return first, first + tr["just_2d_every"] - 1

    def wrapped_make_batch_fn(cfg, tr, seed, device):
        make = make_batch_fn(cfg, tr, seed, device)
        first, _ = first_last(tr)

        def make_batch(i):
            if i == first and "window" not in holder:
                holder["window"] = attribution.SpanWindow(torch)
                holder["window"].start()
            return make(i)
        return make_batch

    def wrapped_build(cfg, tr, params, device):
        state, step_fn = build(cfg, tr, params, device)
        _, last = first_last(tr)

        def step(state, lat, acts, i, **kw):
            out = step_fn(state, lat, acts, i, **kw)
            if i == last and "window" in holder:
                holder["window"].stop()
                holder["steps"] = tr["just_2d_every"]
            return out
        return state, step

    driver.make_batch_fn, driver.build = wrapped_make_batch_fn, wrapped_build
    return holder


def recording_spans(harness):
    """Make harness.Spans keep its instances, so that the benchmark's spans
    of the driver's run are at hand after it."""
    made = []

    class Recorded(harness.Spans):
        def __init__(self):
            super().__init__()
            made.append(self)

    harness.Spans = Recorded
    return made


def probe(cell: dict, seed: int, seconds: int, device: str, t0: float) -> dict:
    """The cell's run with both sub-windows: the result line's fields."""
    import torch

    from perf_bench import attribution, harness
    bench_spans = recording_spans(harness)
    driver = harness.load_module("drivers", cell["driver"])
    rollout = driver.KIND == "rollout"
    if rollout:
        made = rollout_wrap(driver, attribution, torch)
    else:
        holder = train_wrap(driver, attribution, torch)
    rec = driver.run(cell, seed, seconds, True, device, t0)
    metrics = {}
    for name in harness.metric_names():
        value = harness.load_module("metrics", name).read(rec)
        if value is not None:
            metrics[name] = value
    first = rec.get("trace", {})
    bench = bench_spans[0]
    if rollout:
        win, n = made[0].span_window, getattr(made[0], "span_calls", 0)
        per, n0, outer, inner = "call", first.get("calls", 0), "denoiser_call", "model.call"
    else:
        win, n = holder.get("window"), holder.get("steps", 0)
        per, n0, outer, inner = "step", first.get("steps", 0), "train_step", "train.step"
    dev = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    out = {"workload": cell["name"], "seed": seed, "device": dev,
           "correct": rec["failed"] == 0 and all(v <= lim for _, v, lim in rec["checks"]),
           "checks": {k: [v, lim] for k, v, lim in rec["checks"]}, "metrics": metrics}
    if not (n and n0):
        return out
    j = win.record(bench)
    spans = j["spans"]
    out["span_metrics"] = (attribution.rollout_metrics(j["att"], spans) if rollout
                           else attribution.train_metrics(j["att"], spans))
    # the launch calls inside the benchmark's spans around each call (step),
    # and the share of them inside the program's own span
    launches = [c for c in j["calls"] if c[3] in harness.LAUNCH_CALLS]
    times = [c[0] for c in launches]
    ids = attribution.span_of(spans, times, [c[1] for c in launches], j["offset_ns"])
    by_id = {s.id: s for s in spans}
    in_inner = [sid is not None and inner in attribution.chain(by_id, sid) for sid in ids]
    in_outer = attribution.inside(times, j["offset_ns"],
                                  [(a, b) for name, a, b, _ in bench.items if name == outer])
    n_outer = sum(in_outer)
    out.update({
        "overhead": {f"plain_wall_ms_per_{per}": 1e3 * first["window_s"] / n0,
                     f"spans_wall_ms_per_{per}": 1e3 * j["window_s"] / n,
                     f"plain_launches_per_{per}": first["launches"] / n0,
                     f"spans_launches_per_{per}": j["launches"] / n},
        "coverage": {"outer": outer, "inner": inner, "launches_in_outer": n_outer,
                     "share_in_inner": (sum(a and b for a, b in zip(in_outer, in_inner))
                                        / n_outer) if n_outer else None},
        "call_modes": sorted({s.attrs.get("mode") for s in spans if s.name == "model.call"}),
        "offset_ns": j["offset_ns"], "offset_error_ns": j["offset_error_ns"],
        "first_offset_ns": j["first_offset_ns"],
        "launch_threads": sorted({c[1] for c in launches}),
        "span_threads": sorted({s.thread for s in spans}),
        "unattributed_per_" + per: [v / n for v in j["unattributed"]],
        "by_name_per_" + per: {k: {f: (v / n if f != "count" else v) for f, v in row.items()}
                               for k, row in j["by_name"].items()},
        "by_block_per_" + per: by_block(j["att"], spans, n),
        "idle_gaps": j["idle_gaps"],
        "gaps_after": gaps_after(win, j, spans),
        "first_idle_gaps": first.get("idle_gaps")})
    return out


def by_block(att, spans, n) -> dict:
    """{Block name: [self launch calls, self device ms]} a call or step, of
    the calls whose innermost span is that model.block."""
    names = {s.id: s.attrs.get("name") for s in spans if s.name == "model.block"}
    out = {}
    for sid, (launches, secs) in att.items():
        if sid in names:
            row = out.setdefault(names[sid], [0.0, 0.0])
            row[0] += launches / n
            row[1] += 1e3 * secs / n
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def gaps_after(win, j, spans, top: int = 10) -> list:
    """For each of the `top` longest idle gaps: its length (ms), its
    innermost span, and the program span that ended last before it began
    (name and Block name), with the ms between that end and the gap."""
    from perf_bench import attribution, harness
    _, _, intervals, _ = attribution.read_events(win.window.prof)
    _, gaps = harness.busy_and_gaps(intervals)
    ends = sorted((s.t1_ns, s.name, s.attrs.get("name")) for s in spans)
    out = []
    for g, t in gaps[:top]:
        t -= j["offset_ns"]
        before = [e for e in ends if e[0] <= t]
        last = before[-1] if before else (t, None, None)
        label = attribution.innermost([(s.t0_ns, s.t1_ns, s.name) for s in spans], [t])[0]
        out.append([g / 1e6, label, last[1], last[2], (t - last[0]) / 1e6])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perf_bench import harness
    if not torch.cuda.is_available():
        print("span_probe: no CUDA card", file=sys.stderr)
        return 2
    out = probe(harness.load_cell(args.workload), args.seed, args.seconds, "cuda", T0)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
