"""Run one rollout cell as `run.py --trace 0` does, and count how its cached model calls ran.

    python3 perf_bench/graph_probe.py --workload <cell> --seed <n> --seconds <s> [--out F.json]

The program replays its cached, non-updating denoiser call as a CUDA graph
(models/call_graph.py), and each model.call span says how the call ran in
its `graph` attribute: "capture", "replay" or "eager". This script runs the
cell (its module under drivers/) with the program's tracer
(`utils/profiling.tracing()`) on from process start to the end of the
check, and prints one JSON line: the run's end-to-end metrics and checks,
the counts of the cached model calls by `graph` in each frame step of the
window (the benchmark's frame_step spans) and before the window (set-up),
and the replay share: replays over the window's cached calls. A replay
records one span, a recorded or eager call about 40, so the tracer's cost
is that of a few hundred spans a frame step. A program whose spans carry
no `graph` counts its calls under null.
--out also writes the line to a file.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def graph_counts(spans, frame_steps) -> dict:
    """{"setup": {graph: n}, "frames": [{graph: n} per frame step],
    "replay_share": replays / cached calls over the frame steps} of the
    cached model.call spans; `frame_steps` are (start ns, end ns)."""
    setup, frames = {}, [{} for _ in frame_steps]
    for s in spans:
        if s.name != "model.call" or s.attrs.get("mode") != "cached":
            continue
        kind = s.attrs.get("graph")
        row = setup
        for i, (a, b) in enumerate(frame_steps):
            if a <= s.t0_ns < b:
                row = frames[i]
                break
        row[kind] = row.get(kind, 0) + 1
    cached = sum(n for f in frames for n in f.values())
    replays = sum(f.get("replay", 0) for f in frames)
    return {"setup": setup, "frames": frames,
            "replay_share": replays / cached if cached else None}


def probe(cell: dict, seed: int, seconds: int, device: str, t0: float) -> dict:
    """The cell's run with the tracer on: the result line's fields."""
    import torch

    from autoregressive_diffusion_tpu_torch.utils import profiling
    from perf_bench import harness
    made = []

    class Recorded(harness.Spans):
        def __init__(self):
            super().__init__()
            made.append(self)

    window = harness.load_module("drivers", cell["driver"])
    if window.KIND != "rollout":
        raise SystemExit(f"graph_probe: {cell['name']} is not a rollout cell")
    base, harness.Spans = harness.Spans, Recorded
    try:
        with profiling.tracing() as spans:
            rec = window.run(cell, seed, seconds, False, device, t0)
    finally:
        harness.Spans = base
    steps = [(a, b) for name, a, b, _ in made[0].items if name == "frame_step"]
    dev = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    return {"workload": cell["name"], "seed": seed, "device": dev,
            "correct": rec["failed"] == 0 and all(v <= lim for _, v, lim in rec["checks"]),
            "checks": {k: [v, lim] for k, v, lim in rec["checks"]},
            "metrics": {k: v for k, (v, _) in rec["e2e"].items()}, "setup_s": rec["setup_s"],
            "window_step_s": rec["step_s"], **graph_counts(spans, steps)}


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
        print("graph_probe: no CUDA card", file=sys.stderr)
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
