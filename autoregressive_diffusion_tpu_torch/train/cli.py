"""DART training steps of the gym denoiser on the card, on synthetic latents.

    python -m autoregressive_diffusion_tpu_torch.train [--steps 5] [--batch 8]
        [--frames 8] [--dtype bf16] [--seed 0] [--just-2d-every 4]
        [--config gym|tiny] [--device cuda] [--profile TRACE.json]
    torchrun --nproc-per-node N -m autoregressive_diffusion_tpu_torch.train
        --dp DP --sp SP [--backend nccl|gloo] ...   (DP * SP = N)

Counterpart of bench.py's training benchmark: builds the flagship gym model
(64x64x8 latents, 46M parameters) with seeded random weights, creates the
train state (AdamW at 1e-3 behind a 0.1 global-norm clip, two power-function
EMA copies) and runs N steps on seeded normal latents with the loss
settings of the gym run (P_mean 1.2, P_std 1.0, context noise reduction
0.5). Every `--just-2d-every`-th step is a just_2d step, as in the gym
trainer. Prints loss, gradient norm, step time and samples/s per step and a
JSON summary. `--config tiny --device cpu` runs a few-layer model through
the kernels' plain versions; the full width belongs on the card.
`python -m autoregressive_diffusion_tpu_torch.train` runs this module's main
(train/__main__.py), since `train` is the package of the training modules.

Under torchrun with --dp/--sp (the counterpart of scripts/cs_train.py --sp,
on the gym model and synthetic latents) every rank builds the same weights
from the seed, takes its samples (split over `data`) and frames (split over
`seq`) of the same synthetic batch, and runs the data x seq parallel step;
rank 0 prints the rows, the JSON summary and whether the ranks' parameters
still agree. Several ranks share one card under --backend gloo (NCCL takes
one rank a card); --device cpu needs gloo.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..generate import build_model
from ..parallel import check_replica_consistency, create_mesh, seq_slice
from ..utils.profiling import kernel_times, window_summary
from .loss import EDM2LossConfig
from .optim import make_optimizer
from .train_state import create_train_state, make_train_step, step_seed

DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
          "fp32": torch.float32, "float32": torch.float32}
TINY_CONFIG = dict(img_resolution=16, img_channels=4, model_channels=16,
                   channel_mult=(1, 2), num_blocks=1, max_frames=8, channels_per_head=16)
GYM_LOSS = EDM2LossConfig(P_mean=1.2, P_std=1.0, context_noise_reduction=0.5)
# kernel-name fragments for the profile's groups
ATTENTION_KERNELS = ("flash_attn_",)  # csrc/flash_attention_{fwd,bwd}.cu
# csrc/fused_conv_fwd.cu: fp32 SIMT; bf16 prologue, weight packing, tensor-core GEMM
CONV_FWD_KERNELS = ("fused_conv_fwd_kernel", "conv_fwd_prologue", "conv_fwd_pack_w",
                    "conv_fwd_tc")
# csrc/fused_conv_bwd.cu: fp32 SIMT, bf16 prologues and tensor-core GEMMs, shared finalizes
CONV_BWD_KERNELS = ("transpose_w_kernel", "dx_kernel", "dw_kernel", "conv_bwd_prologue",
                    "conv_bwd_grad_prologue", "conv_bwd_pack_w", "conv_bwd_dx_tc",
                    "conv_bwd_dw_tc", "dw_finalize", "dcv_finalize", "dgates_kernel")
MATMUL_KERNELS = ("gemm", "cutlass", "softmax", "bmm", "xmma")


def build_trainer(device="cuda", body_dtype=torch.bfloat16, seed: int = 0,
                  batch: int = 8, learning_rate=1e-3, mesh=None, **overrides):
    """(state, train_step) for the gym denoiser with seeded random weights
    on `device`; `overrides` change UNetConfig fields. With a `mesh` the
    step is this rank's part of a data x seq parallel step (`batch` stays
    the global batch)."""
    model = build_model(device, body_dtype, seed, **overrides).train()
    tx = make_optimizer(learning_rate)
    state = create_train_state(model, tx)
    return state, make_train_step(GYM_LOSS, tx, batch, mesh=mesh)


def synthetic_batch(cfg, batch: int, frames: int, seed: int, device):
    """Seeded normal latents (b, t, H, W, C) and zero action labels (b, t)."""
    g = torch.Generator(device=device).manual_seed(seed)
    r, c = cfg.img_resolution, cfg.img_channels
    images = torch.randn((batch, frames, r, r, c), generator=g, device=device)
    cond = torch.zeros((batch, frames), dtype=torch.long, device=device)
    return images, cond


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_steps(state, train_step, images, cond, steps: int, seed: int = 0,
              just_2d_every: int = 4, log=None, mesh=None) -> list:
    """Run `steps` train steps; step i (counted from the state's step) is a
    just_2d step when (i + 1) % just_2d_every == 0. Returns one dict a step:
    loss, unweighted loss, gradient norm, seconds on the host clock around a
    synchronise, samples/s (of the global batch, under a `mesh`)."""
    dev = images.device
    batch = images.shape[0] * (1 if mesh is None else mesh.batch_ranks)
    rows = []
    for _ in range(steps):
        i = state.step
        just_2d = just_2d_every > 0 and (i + 1) % just_2d_every == 0
        _sync(dev)
        t0 = time.perf_counter()
        state, m = train_step(state, images, cond, step_seed(seed, i), just_2d=just_2d)
        loss = float(m["loss"])  # device -> host: the step is done
        _sync(dev)
        dt = time.perf_counter() - t0
        row = dict(step=i, just_2d=just_2d, loss=loss, unweighted=float(m["unweighted"]),
                   grad_norm=float(m["grad_norm"]), seconds=dt,
                   samples_per_sec=batch / dt)
        rows.append(row)
        if log is not None:
            log(f"step {i} {'just_2d' if just_2d else 'dart':7s} loss={loss:.4f} "
                f"grad_norm={row['grad_norm']:.4f} {dt * 1e3:.1f} ms "
                f"{row['samples_per_sec']:.2f} samples/s")
    return rows


def kernel_group(name: str) -> str:
    """The profile group of a device kernel or copy, by its name."""
    if "Memcpy" in name:
        return "memcpy"
    if any(k in name for k in ATTENTION_KERNELS):
        return "attention_kernels"
    if any(k in name for k in CONV_FWD_KERNELS):
        return "conv_forward"
    if any(k in name for k in CONV_BWD_KERNELS):
        return "conv_backward"
    if any(k in name.lower() for k in MATMUL_KERNELS):
        return "matmul_attention"
    return "optimizer_elementwise_other"


def profile_steps(state, train_step, images, cond, steps: int = 2, seed: int = 0,
                  trace_path=None) -> dict:
    """torch.profiler over `steps` DART train steps: wall time, device busy
    time and idle share, launches, device time by kernel group (conv
    forward, conv backward, the flash-attention kernels, other matrix
    products and softmax, copies between host and card, optimizer and
    elementwise), and the time inside torch.distributed collectives (the
    gloo or nccl work, waits for the other ranks included), all per step
    of this process. Writes a Chrome trace if asked."""
    from torch.profiler import ProfilerActivity, profile

    dev = images.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = train_step(state, images, cond, step_seed(seed, state.step))
        float(m["loss"])
        _sync(dev)
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(str(trace_path))

    w = window_summary(prof, wall, steps)
    groups = {"conv_forward": 0.0, "conv_backward": 0.0, "attention_kernels": 0.0,
              "matmul_attention": 0.0, "memcpy": 0.0, "optimizer_elementwise_other": 0.0}
    for key, us in kernel_times(prof).items():
        groups[kernel_group(key)] += us
    return {"steps": steps, "wall_ms_per_step": w["wall_ms"],
            "device_busy_ms_per_step": w["device_busy_ms"],
            "device_idle_share": w["device_idle_share"],
            "kernel_launches_per_step": w["kernel_launches"],
            "device_ms_per_step_by_group": {k: v / 1e3 / steps for k, v in groups.items()},
            "collectives_ms_per_step": sum(e.cpu_time_total for e in prof.key_averages()
                                           if e.key.startswith(("gloo:", "nccl:"))) / 1e3 / steps,
            "top_device_ms_per_step": w["top_device_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8, help="latent frames T (the DART "
                    "concat has 2T)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16",
                    help="body dtype (parameters and preconditioning stay fp32)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--just-2d-every", type=int, default=4,
                    help="every n-th step is a just_2d step; 0: none")
    ap.add_argument("--config", choices=("gym", "tiny"), default="gym",
                    help="gym: the full-width 46M model; tiny: a few layers, for the CPU")
    ap.add_argument("--profile", default=None, metavar="TRACE.json",
                    help="also profile two more DART steps; writes a Chrome trace")
    ap.add_argument("--dp", type=int, default=1, help="data-parallel ranks (under torchrun)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel ranks: the clip's frames split over them")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="torch.distributed backend of a --dp/--sp run")
    args = ap.parse_args(argv)

    overrides = TINY_CONFIG if args.config == "tiny" else {}
    mesh, device = None, args.device
    if args.dp * args.sp > 1:
        mesh = create_mesh(args.dp, args.sp, args.backend, args.device)
        device = mesh.device
    state, train_step = build_trainer(device, DTYPES[args.dtype], args.seed, args.batch,
                                      mesh=mesh, **overrides)
    model = state.model
    dev = next(model.parameters()).device
    images, cond = synthetic_batch(model.cfg, args.batch, args.frames, args.seed + 1, dev)
    if mesh is not None:
        images, cond = seq_slice(images, mesh), seq_slice(cond, mesh)
    lead = mesh is None or mesh.rank == 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rows = run_steps(state, train_step, images, cond, args.steps, args.seed,
                     args.just_2d_every, log=print if lead else None, mesh=mesh)
    prof = None
    if args.profile:  # every rank runs the steps; rank 0 keeps the trace
        prof = profile_steps(state, train_step, images, cond, 2, args.seed,
                             args.profile if lead else None)
    extra = {}
    if mesh is not None:
        named = dict(model.named_parameters())
        named.update({f"ema{i}.{n}": v for i, e in enumerate(state.ema) for n, v in e.items()})
        extra = dict(dp=mesh.dp, sp=mesh.sp, backend=mesh.backend,
                     replica_mismatches=check_replica_consistency(named, mesh))
        torch.distributed.destroy_process_group()
    if lead:
        _print_summary(args, model, rows, dev, extra)
        if prof is not None:
            print(json.dumps({"profile": prof}))
    if extra.get("replica_mismatches"):
        raise SystemExit("the ranks' parameters disagree after the steps")


def _print_summary(args, model, rows, dev, extra):
    dart = [r for r in rows[1:] if not r["just_2d"]] or rows
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "body_dtype": args.dtype, "config": args.config,
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "batch": args.batch, "frames": args.frames, "steps": len(rows),
        "dart_step_ms": 1e3 * sum(r["seconds"] for r in dart) / len(dart),
        "dart_samples_per_sec": args.batch * len(dart) / sum(r["seconds"] for r in dart),
        "final_loss": rows[-1]["loss"], "finite": all(r["loss"] == r["loss"] for r in rows),
        "peak_mem_mb": (torch.cuda.max_memory_allocated(dev) / 2 ** 20
                        if dev.type == "cuda" else None), **extra,
    }))


if __name__ == "__main__":
    main()
