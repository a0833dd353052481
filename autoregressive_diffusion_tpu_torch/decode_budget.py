"""Decode budget of the batch-1 rollout on the card: where a denoiser call's time goes.

    python -m autoregressive_diffusion_tpu_torch.decode_budget [--num-steps 64]
        [--guidance 1.0] [--quant 1] [--frames 9] [--device cuda] [--config gym|tiny]

Counterpart of tools/decode_budget.py, with its flags and configuration:
the gym UNet (64x64x8 latents, max_frames 32) at batch 1 with 6 prefilled
context frames, seeded random weights, int8 decode weights after the
forced weight norm by default (--quant 0: the bf16 body on the fp32
weights), and the EDM Heun sampler (sigma in [0.4, 80], rho 2): 2n - 1
NFE (denoiser calls) a frame for n steps, doubled by the just_2d pass when
--guidance is not 1. It prints, after the card's name and power limit:

  * operations and HBM bytes a NFE from the port's cost model
    (utils/roofline.denoiser_call_cost: the decode Block and frame
    attention kernels and the plain PyTorch products of the call),
    by route;
  * the floors they imply on an H100: tensor cores at 989e12 bf16
    operations/s, HBM at 3.35e12 B/s;
  * kernel launches a NFE, counted by torch.profiler over one warm frame
    (the runtime's launch calls, and the kernels the card ran; the card's
    activity alone, without the host's aten ops, which would make a
    frame's window take minutes);
  * ms a frame and us a NFE by marginal-cost timing: a rollout of one
    frame and one of --frames frames, chained through the cache, each
    ended by a synchronise;
  * the residual over the floor (launch and dispatch overhead, and the
    elementwise work the model leaves out).
It ends with a JSON line of the same numbers. --device cpu --config tiny
runs a few-layer model on the kernels' plain versions; its floors are
still the H100's, and its times are the CPU's.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .generate import build_model, int8_model
from .models import init_cache
from .sampling.sampler import edm_sampler
from .utils.device import card_line, resolve_device
from .utils.profiling import LAUNCH_CALLS, event_totals, trace
from .utils.roofline import PEAK_BYTES_PER_S, PEAK_FLOPS, denoiser_call_cost

CONTEXT_FRAMES = 6


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def nfe_per_frame(num_steps: int, guidance: float) -> int:
    """Denoiser calls a frame: Heun's two a step, the last step Euler; the
    just_2d reference pass doubles them under guidance."""
    return (2 * num_steps - 1) * (2 if guidance != 1.0 else 1)


def cost_per_nfe(cfg, quant: bool, guidance: float, dtype=torch.bfloat16) -> dict:
    """The cost model's operations and bytes a NFE (a cached call, and with
    guidance the mean of the cached and the just_2d call), by route."""
    calls = [denoiser_call_cost(cfg, dtype, cfg.max_frames, 1 if quant else 4)]
    if guidance != 1.0:
        calls.append(denoiser_call_cost(cfg, dtype, cfg.max_frames, 1 if quant else 4,
                                        just_2d=True))
    routes = {}
    for rows in calls:
        for _, route, flops, nbytes in rows:
            r = routes.setdefault(route, [0.0, 0.0])
            r[0] += flops / len(calls)
            r[1] += nbytes / len(calls)
    return dict(flops=sum(r[0] for r in routes.values()),
                bytes=sum(r[1] for r in routes.values()), routes=routes)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-steps", type=int, default=64)
    ap.add_argument("--guidance", type=float, default=1.0)
    ap.add_argument("--quant", type=int, default=1, help="1: int8 decode weights and K/V")
    ap.add_argument("--frames", type=int, default=9, help="frames of the timed rollout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=("gym", "tiny"), default="gym",
                    help="gym: the full-width model; tiny: a few layers, for the CPU")
    args = ap.parse_args(argv)
    if args.frames < 2:
        raise ValueError("--frames must be at least 2 (the marginal cost of frames 2..n)")
    from .train.cli import TINY_CONFIG

    dev = resolve_device(args.device)
    print(f"# card: {card_line(dev)}", flush=True)
    overrides = TINY_CONFIG if args.config == "tiny" else dict(max_frames=32)
    model = build_model(dev, torch.bfloat16, 0, **overrides)
    if args.quant:
        model = int8_model(model)
    cfg = model.cfg
    b, res, ch = 1, cfg.img_resolution, cfg.img_channels
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, CONTEXT_FRAMES, res, res, ch), generator=g, device=dev)
    with torch.no_grad():
        _, cache = model(x, torch.full((b, CONTEXT_FRAMES), 0.05, device=dev),
                         torch.zeros((b, CONTEXT_FRAMES), dtype=torch.long, device=dev),
                         cache=init_cache(model, b, device=dev), update_cache=True)
    cond = torch.zeros((b, 1), dtype=torch.long, device=dev)
    shape = (b, 1, res, res, ch)
    n = args.num_steps
    nfe = nfe_per_frame(n, args.guidance)

    def frames(count, c):
        out = None
        for _ in range(count):
            out, _, _, c = edm_sampler(model, c, shape, cond, generator=g, num_steps=n,
                                       sigma_min=0.4, sigma_max=80.0, rho=2.0,
                                       guidance=args.guidance)
        return out

    cost = cost_per_nfe(cfg, bool(args.quant), args.guidance)
    t_tc = cost["flops"] / PEAK_FLOPS[torch.bfloat16]
    t_hbm = cost["bytes"] / PEAK_BYTES_PER_S
    print(f"# sampler: {n} steps, {nfe} NFE/frame, guidance={args.guidance}, "
          f"int8={bool(args.quant)}; {args.config} UNet, max_frames {cfg.max_frames}, batch 1, "
          f"{CONTEXT_FRAMES} context frames", flush=True)
    print(f"# cost model / NFE: {cost['flops'] / 1e9:.4f} GFLOP, {cost['bytes'] / 1e6:.3f} MB "
          f"(" + ", ".join(f"{k} {v[0] / 1e9:.4f} GFLOP {v[1] / 1e6:.3f} MB"
                           for k, v in sorted(cost["routes"].items())) + ")")
    print(f"#   H100 floors / NFE: tensor cores {t_tc * 1e6:.2f} us, HBM {t_hbm * 1e6:.2f} us")

    frames(1, cache)  # warm: kernel builds, the allocator
    _sync(dev)
    # on the card the card's activity alone (kernels, launch calls): with
    # the host's aten ops too, a frame's window takes minutes to record
    with trace(None, host=dev.type != "cuda") as prof:
        frames(1, cache)
        _sync(dev)
    counts, on_device = event_totals(prof)
    launch_calls = sum(counts.get(k, 0) for k in LAUNCH_CALLS)
    device_kernels = sum(counts[k] for k in on_device)
    host_ops = sum(c for k, c in counts.items() if k.startswith("aten::"))
    print(f"# launches / NFE (torch.profiler over one warm frame): {launch_calls / nfe:.1f} "
          f"launch calls, {device_kernels / nfe:.1f} device kernels and copies"
          + (f", {host_ops / nfe:.1f} aten ops" if dev.type != "cuda" else ""))

    def run(count):
        _sync(dev)
        t0 = time.perf_counter()
        out = frames(count, cache)
        float(out.sum())  # device -> host: the chain is done
        _sync(dev)
        return time.perf_counter() - t0, out

    t_short, _ = run(1)
    t_long, last = run(args.frames)
    dt = (t_long - t_short) / (args.frames - 1)
    per_nfe = dt / nfe
    resid = per_nfe - max(t_tc, t_hbm)
    print(f"# measured: {1 / dt:.3f} frames/s, {dt * 1e3:.2f} ms/frame, {per_nfe * 1e6:.1f} "
          f"us/NFE (marginal cost of frames 2..{args.frames}, on {dev.type})")
    print(f"# residual over the floor: {resid * 1e6:.1f} us/NFE "
          f"({100 * resid / per_nfe:.2f}% of the NFE; launch and dispatch overhead and "
          f"work the cost model leaves out)")
    summary = dict(card=card_line(dev), config=args.config, num_steps=n,
                   guidance=args.guidance, int8=bool(args.quant), nfe_per_frame=nfe,
                   gflop_per_nfe=cost["flops"] / 1e9, mb_per_nfe=cost["bytes"] / 1e6,
                   routes={k: dict(gflop=v[0] / 1e9, mb=v[1] / 1e6)
                           for k, v in cost["routes"].items()},
                   floor_tc_us=t_tc * 1e6, floor_hbm_us=t_hbm * 1e6,
                   launch_calls_per_nfe=launch_calls / nfe,
                   device_kernels_per_nfe=device_kernels / nfe,
                   ms_per_frame=dt * 1e3, frames_per_s=1 / dt, us_per_nfe=per_nfe * 1e6,
                   residual_us_per_nfe=resid * 1e6, frames=args.frames,
                   finite=bool(torch.isfinite(last).all()))
    print(json.dumps({"decode_budget": summary}))
    return summary


if __name__ == "__main__":
    main()
