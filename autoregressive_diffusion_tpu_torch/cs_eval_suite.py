"""The CS evaluations in one process: the scrambled-context probe, then the
rollout against held-out clips.

    python -m autoregressive_diffusion_tpu_torch.cs_eval_suite --ckpt-dir D
        --mds DIR [--rollout-mds DIR] [--vae saved_models/vae_lunar_lander.ad]
        [--lat-mean M --lat-std S] [--frames 12] [--out run_artifacts/cs_rollout]
        [--model-channels 128] [--device cuda]

Counterpart of tools/cs_eval_suite.py: context_probe (--batches 4) on --mds,
then cs_rollout on --rollout-mds (default --mds; a build_cs_dataset split of
another seed measures generalization), both with --use-actions and the raw
weights (cs_rollout's --ema -1), which are restored once for both.
"""
from __future__ import annotations

import argparse

import torch

from . import context_probe, cs_rollout
from .utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--mds", required=True, help="training split (probe)")
    ap.add_argument("--rollout-mds", default=None,
                    help="held-out split for the rollout (default: --mds)")
    ap.add_argument("--vae", default=None)
    ap.add_argument("--lat-mean", type=float, default=0.0)
    ap.add_argument("--lat-std", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="run_artifacts/cs_rollout")
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    model, step = cs_rollout.restore_model(args.ckpt_dir, args.model_channels,
                                           resolve_device(args.device), torch.bfloat16)
    print(f"# restored step {step} from {args.ckpt_dir}, raw weights")
    return run(model, args)


def run(model, args: argparse.Namespace) -> dict:
    """The probe, then the rollout, of `model`. Returns {"probe":
    context_probe.run's result, "rollout": cs_rollout.run's}."""
    common = ["--ckpt-dir", args.ckpt_dir, "--lat-mean", str(args.lat_mean),
              "--lat-std", str(args.lat_std), "--use-actions"]
    print("== scrambled-context probe ==", flush=True)
    probe = context_probe.run(model, context_probe.parse_args(
        common + ["--mds", args.mds, "--batches", "4"]))
    print("== rollout coherence ==", flush=True)
    rollout = ["--mds", args.rollout_mds or args.mds, "--frames", str(args.frames),
               "--ema", "-1", "--out", args.out] + (["--vae", args.vae] if args.vae else [])
    return dict(probe=probe, rollout=cs_rollout.run(model, cs_rollout.parse_args(
        common + rollout)))


if __name__ == "__main__":
    main()
