"""Run one cell of the port's benchmark once, on the card.

    python3 perf_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is perf_bench/workloads/<cell>.json; it names its configuration,
traffic mix and driver, each a file of its own (harness.py). The run makes
every input and weight on the card from --seed, builds and warms the
program (set-up), measures a window of --seconds, checks what the window
produced against the plain reference, and prints the result as one JSON
line last on standard output: `correct`, `attempted`, `failed`, `metrics`
(--trace 0: the end-to-end metrics; --trace 1: the per-layer metrics of a
profiled sub-window, with `breakdown`), `device`, and last `checks`, each
compared number beside its limit, which also end standard error. With no
card, or fewer than the cell asks for, it prints no result and exits 2; if
JAX, flax or the JAX package were loaded, it exits 3. Kernel and compiler
caches stay inside the checkout (build/).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache = ROOT / "build" / "perf_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    from perf_bench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perf_bench: the cell needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perf_bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
