"""Autoregressive rollout of the gym denoiser on the card.

    python -m autoregressive_diffusion_tpu_torch.generate \
        [--unet saved_models/gym_r3/unet_46M_ema0.050_step40000_bfloat16.ad] \
        [--vae saved_models/vae_lunar_lander.ad] [--int8] [--out strip.png]

Mirrors scripts/generate.py: prefill the context frames at sigma=0.05 into
a fresh cache, time the cached single-frame denoiser call, roll out frames
with the EDM Heun sampler, re-prime observed frames into the warm cache
and, with --vae, decode the generated latents to pixels and write them as
one PNG strip. The denoiser comes from a `.ad` bundle (--unet) or, without
one, is the gym config at full width with seeded random weights. --int8
serves int8 decode weights and int8 K/V rings, as bench.py's rollout does
(forced weight norm, then quantize_variables, then quantized_config).
"""
from __future__ import annotations

import argparse
import json
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from .models import Precond, UNetConfig, init_cache, init_weights
from .models.vae import latents_to_frames
from .sampling import generate
from .utils.bridge import build_precond, from_bundle, jax_variables, vae_from_bundle
from .utils.device import resolve_device
from .utils.profiling import kernel_times, trace, window_summary

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


def int8_model(model: Precond) -> Precond:
    """`model` served with int8 decode weights and int8 K/V rings."""
    dev = next(model.parameters()).device
    return build_precond(model.cfg, jax_variables(model), dev, model.body_dtype, int8=True)


def write_png(path, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of rgb (H, W, 3) uint8, written with zlib alone."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _peak_mb(dev):
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None


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
    to `trace_path` if given, the program's spans (model.call, model.block,
    model.attention) among its ranges."""
    dev = next(model.parameters()).device
    cfg = model.cfg
    x = torch.randn((1, 1, cfg.img_resolution, cfg.img_resolution, cfg.img_channels),
                    device=dev)
    s1 = torch.full((1, 1), 1.0, device=dev)
    c1 = torch.zeros((1, 1), dtype=torch.long, device=dev)
    x = model(x, s1, c1, cache=cache)[0]  # warm-up outside the window
    _sync(dev)
    with trace(None) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            x = model(x, s1, c1, cache=cache)[0]
        _sync(dev)
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(str(trace_path))

    w = window_summary(prof, wall, calls)
    decode_us = sum(us for name, us in kernel_times(prof).items() if "decode_" in name)
    return {"calls": calls, "wall_ms_per_call": w["wall_ms"],
            "device_busy_ms_per_call": w["device_busy_ms"],
            "decode_block_device_ms_per_call": decode_us / 1e3 / calls,
            "device_idle_share": w["device_idle_share"],
            "kernel_launches_per_call": w["kernel_launches"],
            "host_ops_per_call": w["host_ops"],
            "top_device_ms_per_call": w["top_device_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--unet", default=None, metavar="BUNDLE",
                    help="denoiser .ad bundle (default: the gym config, seeded random weights)")
    ap.add_argument("--vae", default=None, metavar="BUNDLE",
                    help="VAE .ad bundle: decode the generated latents and write --out")
    ap.add_argument("--int8", action="store_true",
                    help="int8 decode weights and int8 K/V rings")
    ap.add_argument("--out", default="images_training/generated.png",
                    help="PNG strip of the decoded frames (with --vae)")
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

    if args.unet:
        model = from_bundle(args.unet, args.device, DTYPES[args.dtype], args.int8)
    else:
        model = build_model(args.device, DTYPES[args.dtype], args.seed)
        if args.int8:
            model = int8_model(model)
    dev = next(model.buffers()).device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = rollout(model, args.context_frames, args.gen_frames, args.num_steps,
                  args.sigma_max, 0.4, args.rho, args.guidance,
                  args.reprime_frames, args.bench_iters, args.seed)
    frames = out["frames"]
    line = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "body_dtype": args.dtype,
        "weights": args.unet or f"seeded random (seed {args.seed})",
        "int8": args.int8,
        "prefill_s": out["prefill_s"],
        "decode_ms_per_call": out["decode_ms_per_call"],
        "rollout_frames_per_sec": out["rollout_frames_per_sec"],
        "reprime_s": out["reprime_s"],
        "frames_shape": list(frames.shape),
        "frames_finite": bool(torch.isfinite(frames).all()),
        "latent_mean": float(frames.mean()), "latent_std": float(frames.std()),
        "cache_frames": out["cache"]["frames"],
        "peak_mem_mb": _peak_mb(dev),
    }
    if args.vae:
        vae, _ = vae_from_bundle(args.vae, dev)
        _sync(dev)
        t0 = time.perf_counter()
        pix = latents_to_frames(vae, frames.float(), 0.0, 1.0)
        _sync(dev)
        line["vae_decode_ms"] = (time.perf_counter() - t0) * 1e3
        line["decoded_shape"] = list(pix.shape)
        line["peak_mem_mb_with_vae"] = _peak_mb(dev)
        write_png(args.out, np.concatenate(list(pix[0].cpu().numpy()), axis=1))
        line["out"] = args.out
    print(json.dumps(line))
    if args.profile:
        print(json.dumps({"profile": profile_decode(model, out["cache"], 10, args.profile)}))


if __name__ == "__main__":
    main()
