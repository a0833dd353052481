"""The controls and faults that the limits of `correct` were set against, on the card.

    python3 perf_bench/control.py --workload <cell> --seeds 1,2,3 [--seconds 20]
        [--sound 1] [--control 0] [--faults 1]

A rollout cell's control is the program's own lower-precision path, its
int8 decode weights and K/V rings, run through the cell's window and check
in place of the bf16 path; with --sound 1 the same seeds run the bf16 path
too, in the same process; with --faults 1 the bf16 path runs with each
planted fault under `sampling.generate` (FAULTS): the cache left unchanged
after each frame step, the cache of one checked session left unchanged,
half of the sessions' frames left at their initial noise.

A training cell's control is the plain reference computed with float8
(e4m3, per-tensor scale) products in place of the program, read against
the float32 reference; with --sound 1 the program's readings are taken too
(a run of the cell's window of --seconds), and with --faults 1 the
reference trained on half of each batch (the mean over the rest) is read
as a fault. Each training line also gives the losses' gap, the small
leaves' gap and every leaf's raw norms (`raw`), from which another rule
over the leaves can be read again.

One JSON line a reading: {"seed", "what", "checks": {name: value}, ...}.
Not part of a benchmark run.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("cache_unchanged", "one_session_cache", "half_the_sessions")


def planted(fault, one, sessions, real):
    """`sampling.generate` with `fault` under it; `one` is the session whose
    cache one_session_cache leaves unchanged, of `sessions`."""
    import torch

    def keep_one(new, old):
        if isinstance(new, dict):
            return {k: keep_one(v, old[k]) for k, v in new.items()}
        if isinstance(new, torch.Tensor) and new.dim() and new.shape[0] == sessions:
            new = new.clone()
            new[one] = old[one]
        return new

    def generate(model, cache, n, shape, conditioning=None, generator=None, **kw):
        x, new = real(model, cache, n, shape, conditioning, generator, **kw)
        if fault == "cache_unchanged":
            return x, cache
        if fault == "one_session_cache":
            return x, keep_one(new, cache)
        x = x.clone()
        x[x.shape[0] // 2:] = kw["x_init"][x.shape[0] // 2:]
        return x, new
    return generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--sound", type=int, default=0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perf_bench import harness
    cell = harness.load_cell(args.workload)
    drv = harness.load_module("drivers", cell["driver"])

    def emit(seed, what, checks, **info):
        line = {"seed": seed, "what": what, "checks": {n: v for n, v, _ in checks}, **info}
        print(json.dumps(line), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        if drv.KIND == "rollout":
            runs = ([("int8", True)] if args.control else []) + (
                [("bf16", False)] if args.sound else [])
            for what, control in runs:
                rec = drv.run(cell, seed, args.seconds, False, args.device, time.perf_counter(),
                              control=control)
                emit(seed, what, rec["checks"], frame_steps=rec["frame_steps"], **rec["info"])
            if args.faults:
                import autoregressive_diffusion_tpu_torch.sampling as sampling
                real = sampling.generate
                b = cell["traffic_spec"]["sessions"]
                one = int(drv.checked_sessions(seed, b)[0])
                for fault in FAULTS:
                    sampling.generate = planted(fault, one, b, real)
                    try:
                        rec = drv.run(cell, seed, args.seconds, False, args.device,
                                      time.perf_counter())
                    finally:
                        sampling.generate = real
                    emit(seed, fault, rec["checks"], frame_steps=rec["frame_steps"],
                         **rec["info"])
            continue
        cfg, tr = cell["config_spec"], cell["traffic_spec"]
        ref = drv.reference_readings(cfg, tr, seed, args.device, None)
        emit(seed, "reference", [], raw=ref)

        def read(prog, what):
            emit(seed, what, drv.compare(cfg, prog, ref), loss_gap=drv.loss_gap(prog, ref),
                 small_gap=drv.small_gap(cfg, prog, ref), raw=prog)

        if args.sound:
            rec = drv.run(cell, seed, args.seconds, False, args.device, time.perf_counter())
            read(rec["program_readings"], "program")
        if args.control:
            read(drv.reference_readings(cfg, tr, seed, args.device, "fp8"), "fp8")
        if args.faults:
            read(drv.reference_readings(cfg, tr, seed, args.device, None, 0.5), "half_batch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
