"""Autoregressive rollout of the gym denoiser on the card.

    python -m autoregressive_diffusion_tpu_torch.generate [--context-frames 6]

Mirrors scripts/generate.py without the VAE step: prefill the context
frames at sigma=0.05 into a fresh cache, time the cached single-frame
denoiser call, roll out frames with the EDM Heun sampler, then re-prime
observed frames into the warm cache. Weights are seeded random (the gym
config at full width); the JAX package's checkpoint bundles are not read.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .models import Precond, UNetConfig, init_cache, init_weights
from .sampling import generate
from .utils.device import resolve_device
from .utils.profiling import window_summary

GYM_CONFIG = dict(img_resolution=64, img_channels=8, label_dim=4,
                  model_channels=32, channel_mult=(1, 2, 4, 8), num_blocks=2,
                  video_attn_resolutions=(8,), frame_attn_resolutions=(16,),
                  max_frames=64)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(device="cuda", body_dtype=torch.bfloat16, seed: int = 0,
                **overrides) -> Precond:
    """The gym denoiser (sigma_data=1, as scripts/generate.py) with seeded
    random weights on `device`; `overrides` change UNetConfig fields."""
    dev = resolve_device(device)
    cfg = UNetConfig(**{**GYM_CONFIG, **overrides})
    model = Precond(cfg, sigma_data=1.0, body_dtype=body_dtype)
    init_weights(model, seed)
    return model.to(dev).eval()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def rollout(model, context_frames=6, gen_frames=6, num_steps=64, sigma_max=80.0,
            sigma_min=0.4, rho=2.0, guidance=1.0, reprime_frames=2,
            bench_iters=100, seed=0) -> dict:
    """Prefill, cached-decode latency, generate, re-prime. Returns the
    measurements and outputs as a dict (times on the host clock around
    work that ends in a synchronise)."""
    dev = next(model.parameters()).device
    cfg = model.cfg
    b, res, ch = 1, cfg.img_resolution, cfg.img_channels
    g = torch.Generator(device=dev).manual_seed(seed)

    cache = init_cache(model, b, device=dev)
    context = torch.randn((b, context_frames, res, res, ch), generator=g, device=dev)
    sigma = torch.full((b, context_frames), 0.05, device=dev)
    cond = torch.zeros((b, context_frames), dtype=torch.long, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    _, cache = model(context, sigma, cond, cache=cache, update_cache=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    x1 = torch.randn((b, 1, res, res, ch), generator=g, device=dev)
    s1 = torch.full((b, 1), 1.0, device=dev)
    c1 = torch.zeros((b, 1), dtype=torch.long, device=dev)
    per_call = None
    if bench_iters > 0:
        yy = model(x1, s1, c1, cache=cache)[0]  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(bench_iters):  # chained: each output feeds the next call
            yy = model(yy, s1, c1, cache=cache)[0]
        _sync(dev)
        per_call = (time.perf_counter() - t0) / bench_iters

    t0 = time.perf_counter()
    frames, cache = generate(model, cache, gen_frames, (b, 1, res, res, ch),
                             conditioning=c1, generator=g, num_steps=num_steps,
                             sigma_max=sigma_max, sigma_min=sigma_min, rho=rho,
                             guidance=guidance)
    _sync(dev)
    gen_s = time.perf_counter() - t0

    reprime_s = None
    if reprime_frames > 0:
        obs = torch.randn((b, reprime_frames, res, res, ch), generator=g, device=dev)
        sig_r = torch.full((b, reprime_frames), 0.05, device=dev)
        cond_r = torch.zeros((b, reprime_frames), dtype=torch.long, device=dev)
        t0 = time.perf_counter()
        _, cache = model(obs, sig_r, cond_r, cache=cache, update_cache=True)
        _sync(dev)
        reprime_s = time.perf_counter() - t0
    return {"frames": frames, "cache": cache, "prefill_s": prefill_s,
            "decode_ms_per_call": None if per_call is None else per_call * 1e3,
            "generate_s": gen_s, "rollout_frames_per_sec": gen_frames / gen_s,
            "reprime_s": reprime_s}


@torch.no_grad()
def profile_decode(model, cache, calls: int = 10, trace_path=None) -> dict:
    """torch.profiler over `calls` chained cached single-frame denoiser
    calls: wall time, device busy time and idle share, kernel launches and
    the ops with the most device time, all per call. Writes a Chrome trace
    to `trace_path` if given."""
    from torch.profiler import ProfilerActivity, profile

    dev = next(model.parameters()).device
    cfg = model.cfg
    x = torch.randn((1, 1, cfg.img_resolution, cfg.img_resolution, cfg.img_channels),
                    device=dev)
    s1 = torch.full((1, 1), 1.0, device=dev)
    c1 = torch.zeros((1, 1), dtype=torch.long, device=dev)
    x = model(x, s1, c1, cache=cache)[0]  # warm-up outside the window
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            x = model(x, s1, c1, cache=cache)[0]
        _sync(dev)
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(str(trace_path))

    w = window_summary(prof, wall, calls)
    return {"calls": calls, "wall_ms_per_call": w["wall_ms"],
            "device_busy_ms_per_call": w["device_busy_ms"],
            "device_idle_share": w["device_idle_share"],
            "kernel_launches_per_call": w["kernel_launches"],
            "host_ops_per_call": w["host_ops"],
            "top_device_ms_per_call": w["top_device_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                    help="body dtype (preconditioning stays fp32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--context-frames", type=int, default=6)
    ap.add_argument("--gen-frames", type=int, default=6)
    ap.add_argument("--num-steps", type=int, default=64)
    ap.add_argument("--sigma-max", type=float, default=80.0)
    ap.add_argument("--rho", type=float, default=2.0)
    ap.add_argument("--guidance", type=float, default=1.0)
    ap.add_argument("--bench-iters", type=int, default=100)
    ap.add_argument("--reprime-frames", type=int, default=2)
    ap.add_argument("--profile", default=None, metavar="TRACE.json",
                    help="also profile 10 cached decode calls; writes a Chrome trace")
    args = ap.parse_args(argv)

    model = build_model(args.device, DTYPES[args.dtype], args.seed)
    out = rollout(model, args.context_frames, args.gen_frames, args.num_steps,
                  args.sigma_max, 0.4, args.rho, args.guidance,
                  args.reprime_frames, args.bench_iters, args.seed)
    frames = out["frames"]
    dev = next(model.parameters()).device
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "body_dtype": args.dtype,
        "prefill_s": out["prefill_s"],
        "decode_ms_per_call": out["decode_ms_per_call"],
        "rollout_frames_per_sec": out["rollout_frames_per_sec"],
        "reprime_s": out["reprime_s"],
        "frames_shape": list(frames.shape),
        "frames_finite": bool(torch.isfinite(frames).all()),
        "latent_mean": float(frames.mean()), "latent_std": float(frames.std()),
        "cache_frames": out["cache"]["frames"],
    }))
    if args.profile:
        print(json.dumps({"profile": profile_decode(model, out["cache"], 10, args.profile)}))


if __name__ == "__main__":
    main()
