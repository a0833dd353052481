"""Rollout-drift sampler sweep on the card.

    python -m autoregressive_diffusion_tpu_torch.drift_sweep [--episodes 2] [--frames 32]
        [--episodes-file run_artifacts/episodes/lunarlander_heuristic_seed0_256px.npz]
        [--cells r4-protocol,no-churn] [--in-process]

Counterpart of tools/drift_sweep.py, with its cells: it runs the port's
rollout_drift over sampler settings (guidance, S_churn, num_steps,
sigma_min, rho, the action policy) one cell after another and tabulates
the last frame's latent MSE against the persistence baseline. It parses
rollout_drift's 0-based summary line (`frame0=`; the JAX tool's regex
reads `frame1=`, which its own script never prints). A cell runs in a
subprocess (`python -m autoregressive_diffusion_tpu_torch.rollout_drift`),
or with --in-process in this process, which builds the kernels once. Each
cell writes under build/drift_sweep/<cell>. A cell whose policy the
episodes file does not hold fails, as rollout_drift does.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

CELLS = [
    ("r4-protocol", []),
    ("no-churn", ["--s-churn", "0"]),
    ("ref-recipe", ["--s-churn", "0", "--sigma-min", "0.4", "--rho", "2",
                    "--num-steps", "64"]),
    ("ref-recipe-32", ["--s-churn", "0", "--sigma-min", "0.4", "--rho", "2"]),
    ("guidance1.5", ["--guidance", "1.5"]),
    ("ref+g1.5", ["--s-churn", "0", "--sigma-min", "0.4", "--rho", "2",
                  "--num-steps", "64", "--guidance", "1.5"]),
    # in-distribution action conditioning: the heuristic lander policy is
    # out of the uniform-random actions gym_train trains on
    ("ref-random", ["--s-churn", "0", "--sigma-min", "0.4", "--rho", "2",
                    "--policy", "random"]),
    ("r4-random", ["--policy", "random"]),
]

SUMMARY = re.compile(r"latent MSE frame0=([\d.]+) frame(\d+)=([\d.]+) "
                     r"\(persistence ([\d.]+)\); std drift ([\d.]+)x")


def parse_summary(text: str) -> Optional[tuple]:
    """(frame0 MSE, last frame index, last frame MSE, persistence, std
    drift) from the last summary line in rollout_drift's output, or None."""
    found = None
    for line in text.splitlines():
        m = SUMMARY.search(line)
        if m:
            f0, i, flast, pers, stdx = m.groups()
            found = (float(f0), int(i), float(flast), float(pers), float(stdx))
    return found


def run_cell(argv, in_process: bool) -> tuple:
    """(exit code, stdout + stderr, last line of the failure) of one cell."""
    if in_process:
        from . import rollout_drift
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rollout_drift.main(argv)
        except Exception as e:  # the sweep reports a failed cell and goes on
            return 1, buf.getvalue(), repr(e)
        return 0, buf.getvalue(), ""
    r = subprocess.run([sys.executable, "-m", "autoregressive_diffusion_tpu_torch.rollout_drift"]
                       + argv, capture_output=True, text=True, timeout=3000, cwd=REPO)
    tail = ((r.stderr or r.stdout).strip().splitlines() or [""])[-1]
    return r.returncode, r.stdout + r.stderr, tail


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--unet", default="saved_models/gym_r3/"
                                      "unet_46M_ema0.050_step40000_bfloat16.ad")
    ap.add_argument("--vae", default="saved_models/vae_lunar_lander.ad")
    ap.add_argument("--episodes-file", default=None, metavar="NPZ",
                    help="recorded episodes for every cell, in place of gymnasium")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", default=None, help="comma-separated cell names (default: all)")
    ap.add_argument("--in-process", action="store_true",
                    help="run the cells in this process (the kernels build once)")
    args = ap.parse_args(argv)

    sel = set(args.cells.split(",")) if args.cells else None
    results = []
    for name, extra in CELLS:
        if sel and name not in sel:
            continue
        t0 = time.time()
        cell_argv = ["--unet", os.path.join(REPO, args.unet),
                     "--vae", os.path.join(REPO, args.vae),
                     "--episodes", str(args.episodes), "--frames", str(args.frames),
                     "--device", args.device,
                     "--out", os.path.join(REPO, "build", "drift_sweep", name)] + extra
        if args.episodes_file:
            cell_argv += ["--episodes-file", os.path.join(REPO, args.episodes_file)]
        rc, out, tail = run_cell(cell_argv, args.in_process)
        parsed = parse_summary(out)
        if rc or parsed is None:
            print(f"{name:16s} FAILED exit={rc} {tail}", flush=True)
            continue
        f0, last_i, flast, pers, stdx = parsed
        verdict = "BEATS" if flast < pers else "worse than"
        results.append((name, f0, flast, pers))
        print(f"{name:16s} frame0={f0} frame{last_i}={flast} persistence={pers} std={stdx}x "
              f"-> {verdict} persistence ({time.time() - t0:.0f}s)", flush=True)
    if results:
        best = min(results, key=lambda r: r[2])
        print(f"# best: {best[0]} frame{args.frames - 1}={best[2]:.4f} "
              f"(persistence {best[3]:.4f})")
    return results


if __name__ == "__main__":
    main()
