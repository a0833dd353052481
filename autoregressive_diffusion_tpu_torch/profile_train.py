"""Profile one dispatch of G scanned training steps on the card: the device ops with the most time.

    python -m autoregressive_diffusion_tpu_torch.profile_train [--batch 8] [--frames 8]
        [--scan 10] [--top 40] [--trace DIR] [--device cuda] [--config gym|tiny]

Counterpart of tools/profile_train.py: the gym model (46M, 64x64x8 latents,
max_frames 64, bf16 body over fp32 weights, seeded random weights as the
port's train CLI builds them), AdamW at 1e-3 behind the 0.1 global-norm
clip, the gym loss (P_mean 1.2, P_std 1, context noise reduction 0.5), and
train/train_state.make_scanned_train_step: G = --scan DART steps of batch
--batch, T = --frames in one call, each on its own seeded normal latents.
It runs one warm dispatch, then profiles one (utils/profiling.trace, the
card's activity alone: kernels and launch calls; a Chrome trace into
--trace DIR if given) and prints the card's name and
power limit, the --top device ops by device time with their counts
(utils/profiling.top_ops), their total, the whole window's device busy
time and launches. On --device cpu there are no device ops: it ranks the
host's aten ops by their own CPU time instead, and says so.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .generate import build_model
from .train.loss import EDM2LossConfig
from .train.optim import make_optimizer
from .train.train_state import create_train_state, make_scanned_train_step
from .utils.device import card_line, resolve_device
from .utils.profiling import top_ops, trace, window_summary

LOSS = EDM2LossConfig(P_mean=1.2, P_std=1.0, context_noise_reduction=0.5)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_top_ops(prof, n: int) -> list:
    """[(host ms, count, aten op)] of the n aten ops with the most self CPU
    time in the window."""
    rows = [(e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.key.startswith("aten::")]
    return sorted(rows, reverse=True)[:n]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8, help="latent frames T")
    ap.add_argument("--scan", type=int, default=10, help="G: steps in one dispatch")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="also write the window's Chrome trace into DIR")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=("gym", "tiny"), default="gym",
                    help="gym: the full-width model; tiny: a few layers, for the CPU")
    args = ap.parse_args(argv)
    from .train.cli import TINY_CONFIG

    dev = resolve_device(args.device)
    print(f"# card: {card_line(dev)}", flush=True)
    overrides = TINY_CONFIG if args.config == "tiny" else {}
    model = build_model(dev, torch.bfloat16, 0, **overrides).train()
    cfg = model.cfg
    tx = make_optimizer(1e-3)
    state = create_train_state(model, tx)
    step = make_scanned_train_step(LOSS, tx, args.batch)
    g, b, t = args.scan, args.batch, args.frames
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn((g, b, t, cfg.img_resolution, cfg.img_resolution, cfg.img_channels),
                         generator=gen, device=dev)
    cond = torch.zeros((g, b, t), dtype=torch.long, device=dev)
    print(f"# {args.config} model, {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
          f"params; {g} scanned DART steps of batch {b}, T={t} a dispatch; warm dispatch...",
          flush=True)
    t0 = time.perf_counter()
    state, metrics = step(state, images, cond, 0)
    float(metrics["loss"])
    _sync(dev)
    warm_s = time.perf_counter() - t0
    print(f"# warm dispatch {warm_s:.2f} s (kernel builds included); tracing one...", flush=True)
    with trace(args.trace, host=dev.type != "cuda") as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, images, cond, 1)
        loss = float(metrics["loss"])
        _sync(dev)
        wall = time.perf_counter() - t0
    w = window_summary(prof, wall, 1)
    rows = top_ops(prof, n=args.top)
    where = "device"
    if not rows:
        rows, where = host_top_ops(prof, args.top), "host (no device ops on the CPU)"
    total = 0.0
    print(f"# the {len(rows)} {where} ops with the most time in one dispatch:")
    for ms, count, name in rows:
        total += ms
        print(f"{ms:9.3f} ms x{count:5d}  {name[:120]}")
    print(f"TOTAL(top{len(rows)}): {total:.1f} ms {where} for {g} steps of batch {b}; the "
          f"dispatch {wall * 1e3:.1f} ms wall, device busy {w['device_busy_ms']:.1f} ms "
          f"(idle share {w['device_idle_share']:.3f}), {w['kernel_launches']:.0f} launches, "
          f"loss {loss:.4f}")
    summary = dict(card=card_line(dev), config=args.config, scan=g, batch=b, frames=t,
                   where=where, wall_ms=wall * 1e3, warm_s=warm_s, top_total_ms=total,
                   device_busy_ms=w["device_busy_ms"], idle_share=w["device_idle_share"],
                   launches=w["kernel_launches"], loss=loss,
                   top=[[ms, count, name[:120]] for ms, count, name in rows])
    print(json.dumps({"profile_train": {k: v for k, v in summary.items() if k != "top"}}))
    return summary


if __name__ == "__main__":
    main()
