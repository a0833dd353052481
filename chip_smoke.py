#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run with a non-zero exit:
  1. setup: prints the card's name and power limit, builds every CUDA
     kernel from csrc/ with nvcc for sm_90a (all sources at once), and turns
     TF32 off for matmuls and cuDNN convolutions so that fp32 comparisons
     are fp32;
  2. the prefill-attention kernels against their plain PyTorch version at
     the gym's shapes (4 heads, d=64, 64 tokens a frame): fresh causal t=8;
     ring offset 0, t_new=8, f_total=64; offset 10, t_new=2; wrapped ring at
     offset 60, t_new=8 -- in fp32 (SIMT kernel) and bf16 (the tensor-core
     flash forward under the ring mask), with device times of the kernel
     and of F.scaled_dot_product_attention on the same mask (device_ms),
     beside their wall times a call and the plain version's;
  2b. the DART and full flash-attention kernels, forward and backward,
     against their plain versions (o, lse, dq, dk, dv) in fp32 (SIMT
     kernels) and bf16 (tensor-core kernels) at every attention shape of
     the gym model's DART and just_2d training steps (batch 8, T=8) and of
     the CS model's (batch 2, T=16: video attention at 4x4, 16 tokens a
     frame, 8 heads of d=64; frame attention at 8x8), at both models'
     rollout frame-attention shapes (b*t = 1 and 8 frames) and at odd
     shapes (T=3, hw=40, d=32, batch 1), with times of the kernels, the
     plain versions and F.scaled_dot_product_attention on the same mask
     (for the full kind also with no mask), forward and backward; kernel
     and SDPA times are device times (device_ms: the calls queued behind a
     sleeping kernel, so the host's launch cost is not counted), the wall
     time a call beside them;
  3. the fused decode-Block kernels against their plain version for every
     attention-free Block shape of the gym model and of the CS model (4x4
     Blocks and C0 up to 768 among them), fp32 (SIMT) and bf16
     (tensor cores), with the kernels' device time and wall time a call and
     the plain version's wall time. The wgmma/mma.sync and TMA/cp.async
     instructions of every tensor-core kernel (flash, prefill, Block, the
     train-mode conv) are counted in the machine code (cuobjdump; a kernel
     with no tensor-core product or no asynchronous copy fails the run), and
     every kernel's registers and spills are printed from the build;
  4. end to end against the plain versions: a small model and the
     full-width gym model on the card (kernels, fp32) agree with the same
     models on the CPU (plain versions) on a prefill and a cached decode step;
  5. the main path: the full-width 46M gym denoiser in bf16 from seeded
     weights prefills 8 context frames into a fresh cache, generates 2
     frames (64 Heun steps, rho=2, sigma in [0.4, 80]) and re-primes 2
     frames at offset 10, with both kernels' launch counters zeroed before
     and read after; the counts must be 6 per prefill call for the
     attention kernel and 17 per denoiser call for the decode Block;
  6. the train-mode fused gated conv, forward and backward kernels, against
     their plain version (out, dx, dw2, dw3, dcvec, dgates) in fp32 (SIMT
     kernels) and bf16 (tensor cores; run twice, bit for bit) at every
     distinct (H, C, Co, silu_in, has_cvec, with_ctx) of the gym model's
     causal convs at batch 8, T=8, of the CS model's at batch 2, T=16 (one
     microbatch; 4x4 frames among them), and at one odd shape (24x40, C=9, T=3,
     batch 1), with device times (device_ms) and wall times a call of the
     forward and of the backward entry point, each on its own, and of the
     unfused cuDNN path (F.conv2d in the working type plus elementwise ops;
     its backward by autograd over a kept graph), which the port never
     calls, beside the plain version's wall times; and the kernel's fp32
     weight gradient against a float64 reference;
  7. the training path: a small fp32 model's one-step gradients on the card
     (conv and attention kernels) against the same model on the CPU (plain
     versions); then the full-width 46M gym model in a bf16 body, batch 8,
     T=8, seeded synthetic latents, through create_train_state and
     make_train_step: three DART steps and one just_2d step, with the conv
     and attention launch counters zeroed before and read after each step;
     the conv counts must equal the model's causal conv count, the attention
     counts its attention layers (a DART step: one DART forward and backward
     per video layer, one full per frame layer; a just_2d step: one full per
     attention layer). Loss and gradients finite, unit-norm weights, EMA
     moved;
  8. sequence parallelism (row 8): every seq rank's forward and backward
     kernel call (the flash kernels' SP entry points) against its plain
     version at the gym's video-attention shape, DART and frame-causal,
     sp = 2 and 4, fp32 and bf16, and the ranks' stacked o and summed dk, dv
     against the one-rank kernels, with times of each call, its plain
     version and F.scaled_dot_product_attention on the same rows and mask;
     then two ranks spawned on this card under gloo (the main path of the
     slice): a small fp32 model's DART and just_2d steps against the same
     steps in one process on the card, and the full-width gym model, bf16,
     batch 8, T=8 split 4 + 4 frames, three DART steps and one just_2d step
     with every launch counter zeroed before and read after each step in
     each rank (a DART step: 6 dart_sp forward and backward, no one-rank
     DART launch, 5 full, 58 conv forward and backward);
  9. trained weights (run right after phase 5), read from the committed
     bundles by the port's own reader (utils/checkpoint.py, no JAX):
     (a) the r3 denoiser (saved_models/gym_r3/...) in fp32 on the card
     against the CPU, as phase 4; (b) phase 5's path on the r3 weights in
     bf16 and (c) with int8 decode weights and int8 K/V rings, the launch
     counts held as in phase 5, the rings checked int8, each model alone
     on the card for its peak memory; the int8 model in fp32, card against
     CPU, as (a); the decode Block kernel on every Block's dequantized int8
     weights against its plain version; and the int8 output of one cached
     call against the bf16 one from the same context, recorded (max |diff|
     / max |bf16|, std ratio, and the share of K/V components that the int8
     rings clip, and the same against the int8 weights alone, the int8
     rings alone and fp32) beside the JAX test's 0.05, which this model
     does not meet (PERF.md); (d) the generated latents decoded to
     (1, 8, 256, 256, 3) uint8 frames by the trained VAE
     (saved_models/vae_lunar_lander.ad) on the card against the CPU: float
     pixels within std(diff) 3e-4, uint8 within 1;
 10. the gym training path (gym_train.py, the slice's main path) at full
     width in a directory under build/ that it removes: (a) 16 synthetic
     clips (16, 32, 256, 256, 3) uint8 encoded by the trained VAE to
     (16, 8, 64, 64, 8) latents, one clip card against CPU within
     std(diff) 3e-4; (b) eight steps through gym_train's loop, batch 16 in
     microbatches of 8, on streamed clips with the LR schedule of --steps 8,
     each step's launches held to twice a batch-8 step's (phase 7), the
     dashboard at step 4 (coefs refitted, finite and changed; the sampler
     callback's 315 denoiser calls and 2 prefills held to 17 Blocks a call
     and 6 prefill launches a prefill; the rollout decoded to a PNG; the
     model left in training mode), checkpoints at steps 4 and 8; (c) four
     steps, a refit and a save, a restore into a freshly built trainer and
     four more steps against eight straight steps: every leaf of the train
     state bit for bit (else within 1e-6 of its largest value, reported);
     (d) --replay 32 --replay-device for four steps: one just_2d dispatch,
     one of three steps, the rings on the card, under a profile the
     3-step dispatch's host-to-card bytes below 1% of one batch; (e)
     export_ema of the 0.050 EMA as bf16, every leaf equal to the state's
     EMA rounded to bf16 in numpy, served by generate --unet --vae: finite
     latents and a uint8 PNG. Its launches join the kernels line.
 11. the CS path (build_cs_dataset, cs_train, cs_rollout, context_probe,
     cs_eval_suite) at full width (the 310M CS UNet, 32x32x8 latents,
     T=16) in a directory under build/ that it removes: (a) 8 synthetic
     camera-pan clips of 128 frames at 128 px encoded by the trained VAE
     into .npz shards of (32, 32, 32, 8) fp16 latents, one clip card
     against CPU within std(diff) 3e-4, and an uncompressed MDS copy; (b)
     cs_train --mds for 6 steps (batch 8 in microbatches of 2, just_2d at
     steps 0 and 4), each step's launches held to four microbatches' (58
     conv forward and backward, 6 DART and 5 full flash forward and
     backward each; 11 full in a just_2d step), loss finite, weights unit
     norm, EMA moved, the final save with the host's resident peak, and one
     profiled DART step (busy share, launches); (c) the CS model in fp32,
     card against CPU (prefill 4, one cached step, just_2d) within 3e-4,
     with 17 decode-Block launches in each T=1 call; (d), (e) cs_eval_suite
     on (b)'s checkpoint: context_probe's real and scrambled losses finite,
     cs_rollout's 2 clips of 4 context and 2 generated frames (32 steps)
     with 17 Blocks a denoiser call and 6 prefill launches a prefill, MSE
     finite, a uint8 PNG; then the cached denoiser call timed and profiled.
     Its launches join the kernels line.
 12. VAE training (gym_vae_train, cs_vae_train, cs_vae_adversarial,
     calibrate_lpips) in a directory under build/ that it removes: (a) one
     gym VAE + discriminator step (32 px, 8 frames, batch 2) card against
     CPU from the same seeded weights, t and noise injected: float64 holds
     losses, every gradient, the parameters and batch_stats at 3e-4; fp32
     (TF32 off) holds the losses, the VAE's gradients and batch_stats and
     records the discriminator's; (b) gym_vae_train --synthetic at its full
     configuration (256 px, 32 frames, batch 4) for 6 steps: step ms,
     clips/s, peak MB, one profiled step's launches and busy share, and
     whether --remat was needed (run without; on running out of device
     memory, again with it); the bundle read by vae_from_bundle and decoded,
     and served by generate --vae for one rollout; (c) cs_vae_train
     --synthetic at the full VAE (3, 32, 128, 512, 8) at 256 px, clip 32
     and batch 2, else the first of clip 32 x batch 1, 16 x 2 and 16 x 1
     that fits (the cuts printed) for 3 steps, then
     cs_vae_adversarial --vae <its bundle> for 2 steps, with step ms, peak
     MB and the perceptual branch; calibrate_lpips --out and
     alexnet_lpips_loss timed at 256 px on its params. The served
     rollout's launches join the kernels line.
 13. (a) the original PyTorch repo's recorded tensors
     (tests/reference_parity/fixtures) on the card in fp32, through the
     kernels: the causal conv and video attention fixtures (train, just_2d,
     prefill, decode) and the Precond loaded by the port's import_torch_3d
     (train y and input gradient, just_2d, prefill, cached decode, the loss,
     the 8-step sampler), at the CPU test's bounds; as the recorded Precond
     has out_gain and emb_gain 0, the same weights with those gains 1 card
     against CPU at 3e-4; (b) the full-width gym DART step (bf16, batch 8,
     T=8) with dropout 0.1, without and with per-Block remat from one seed:
     gradients within 1e-6 relative (bitwise equality reported), launches of
     a loss + backward held (remat: every Block's convs and attention
     forward again), step ms and peak MB of 3 steps each; (c)
     rollout_drift on the r3 weights and the trained VAE over the committed
     episode 0 for 8 frames: the series finite and in drift.npz, 17 decode
     Blocks a denoiser call, 6 prefill launches a prefill. Its launches join
     the kernels line.
Then it prints the `kernels` JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. It exits non-zero, printing no result, when
no CUDA device is present or the port's package is not beside it.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PKG = "autoregressive_diffusion_tpu_torch"
DEV = "cuda"

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
TOL_FP32_ATTN = 1e-4   # max |diff|: the same fp32 arithmetic in another order
TOL_FP32_BLOCK = 1e-3  # max |diff|: fp32 sums of up to 27*256 products
TOL_BF16 = 1e-2        # std(diff)/std(ref): bf16 rounding of outputs and t0/t1
TOL_E2E = 3e-4         # std(diff): the repo's parity bound
TOL_GRAD = 3e-4        # std(diff)/std(ref) per gradient leaf, card vs CPU, fp32
EPS32 = 6e-8           # fp32 unit roundoff


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=30, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=30, warmup=3) -> float:
    """Device time of a call: the timed calls are queued behind a sleeping
    kernel, so the host's cost of launching them (Python, ctypes, tensor
    maps) overlaps the sleep and the events see the kernels back to back.
    The sleep doubles until it outlasts the queueing. fn must not
    synchronise (no host-device copies)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 5_000_000
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()  # the card was still asleep when the last call was queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
    raise RuntimeError("device_ms: the sleep never outlasted the queueing")


def ptxas_report(text):
    """[(kernel, registers, spill store bytes, spill load bytes)] of every
    entry function in nvcc's -Xptxas -v output, names demangled where
    c++filt is on the PATH."""
    rows, fn, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append([fn, int(m.group(1)), *spill])
            fn, spill = None, (0, 0)
    for r, name in zip(rows, demangle([r[0] for r in rows])):
        r[0] = name
    return [tuple(r) for r in rows]


def demangle(names):
    """Kernel names without namespaces and arguments, by c++filt where it is
    on the PATH (else as they are)."""
    if not names or not shutil.which("c++filt"):
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return names
    return [re.sub(r"\(.*", "", n.replace("(anonymous namespace)::", "").removeprefix("void "))
            for n in out]


def sass_counts(lib, part="_tc"):
    """{kernel: (HGMMA, HMMA, UTMALDG, LDGSTS)}: the tensor-core products
    (wgmma, mma.sync) and asynchronous copies (TMA, cp.async) in the machine
    code (cuobjdump -sass) of every kernel of a built library whose mangled
    name holds `part`; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    found = {}
    for fn in re.split(r"\n(?=\s*Function : )", text):
        m = re.search(r"Function : (\S+)", fn)
        if m and part in m.group(1):
            found[m.group(1)] = tuple(fn.count(op) for op in ("HGMMA.", "HMMA.", "UTMALDG",
                                                               "LDGSTS"))
    return dict(zip(demangle(list(found)), found.values()))


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def compare(got, want, dtype, fp32_tol):
    """(max |diff|, error, tolerance, ok) for one output: fp32 is held to
    max |diff| <= fp32_tol, bf16 to std(diff)/std(ref) <= TOL_BF16."""
    diff = got.float() - want.float()
    max_abs = float(diff.abs().max())
    if dtype == torch.float32:
        return max_abs, max_abs, fp32_tol, max_abs <= fp32_tol
    rel = float(diff.std() / want.float().std())
    return max_abs, rel, TOL_BF16, rel <= TOL_BF16


FLASH_COUNTERS = ("dart_fwd_launches", "dart_bwd_launches", "full_fwd_launches",
                  "full_bwd_launches")


def flash_counts(fa):
    """(dart fwd, dart bwd, full fwd, full bwd) launch counters."""
    return tuple(getattr(fa, n) for n in FLASH_COUNTERS)


def zero_flash_counts(fa):
    for n in FLASH_COUNTERS:
        setattr(fa, n, 0)


# ---------------------------------------------------------------------------
# phase 2: prefill attention

def attention_phase(fa, masks, F):
    dev = torch.device(DEV)
    heads, d, hw = 4, 64, 64
    cases = [("fresh causal t=8", 8, 8, 0), ("ring off=0 t=8 F=64", 8, 64, 0),
             ("ring off=10 t=2 F=64", 2, 64, 10), ("wrapped off=60 t=8 F=64", 8, 64, 60)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, t_new, f_total, off in cases:
            g = torch.Generator(device=dev).manual_seed(t_new * 1000 + off)
            q = torch.randn((1, heads, t_new * hw, d), generator=g, device=dev)
            k = torch.randn((1, heads, f_total * hw, d), generator=g, device=dev)
            v = torch.randn((1, heads, f_total * hw, d), generator=g, device=dev)
            qs = (q * d ** -0.5).to(dtype)
            k, v = k.to(dtype), v.to(dtype)
            got = fa.prefill_attention(qs, k, v, t_new, f_total, off, hw)
            want = fa.prefill_attention_plain(qs, k, v, t_new, f_total, off, hw)
            torch.cuda.synchronize()
            max_abs, err, tol, ok = compare(got, want, dtype, TOL_FP32_ATTN)
            fmask = masks.prefill_frame_mask(t_new, f_total, off)
            tok_mask = torch.as_tensor(masks.expand_to_tokens(fmask, hw), device=dev)

            def kernel():
                return fa.prefill_attention(qs, k, v, t_new, f_total, off, hw)

            def sdpa():
                return F.scaled_dot_product_attention(qs, k, v, attn_mask=tok_mask, scale=1.0)

            ms, lib_ms = device_ms(kernel), device_ms(sdpa)
            wall_ms, lib_wall_ms = time_ms(kernel), time_ms(sdpa)
            plain_ms = time_ms(lambda: fa.prefill_attention_plain(qs, k, v, t_new,
                                                                  f_total, off, hw))
            pairs = int(fmask.sum()) * hw * hw * heads
            slots = int(fmask.any(axis=0).sum())
            item = qs.element_size()
            nbytes = item * heads * d * (2 * t_new * hw + 2 * slots * hw)
            bound_ms, bound_by = bound(4 * d * pairs, nbytes, dtype)
            row = dict(case=label, dtype=str(dtype).split(".")[-1], max_abs_err=max_abs,
                       err=err, tol=tol, ok=bool(ok), ms=ms, wall_ms=wall_ms,
                       plain_ms=plain_ms, library_ms=lib_ms, library_wall_ms=lib_wall_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows.append(row)
            log(f"# attn {row['dtype']:8s} {label:24s} max_abs={max_abs:.3e} err={err:.3e} "
                f"tol={tol:.0e} ok={ok} | device ms kernel={ms:.4f} sdpa={lib_ms:.4f} | wall ms "
                f"kernel={wall_ms:.4f} sdpa={lib_wall_ms:.4f} plain={plain_ms:.4f} | "
                f"bound_ms={bound_ms:.5f} ({bound_by})")
    return rows


# ---------------------------------------------------------------------------
# phase 2b: DART and full flash attention, forward and backward

def attention_calls(cfg, b, t, just_2d):
    """[(kind, batch, heads, n_frames, hw, d)] of the flash-attention calls
    of one training step of the model, in layer order: a DART step runs
    DART attention over the 2T-frame concat in every video layer and full
    attention per frame (b*2T frames) in every frame layer; a just_2d step
    runs full attention per frame (b*T) in both."""
    out = []
    for _, _, spec in cfg.block_layout():
        heads = cfg.num_heads(spec)
        if not heads:
            continue
        hw, d = spec["res"] ** 2, spec["cout"] // heads
        if spec["attention"] == "video" and not just_2d:
            out.append(("dart", b, heads, t, hw, d))
        else:
            out.append(("full", b * (t if just_2d else 2 * t), heads, 1, hw, d))
    return out


def flash_cost(kind, b, heads, n_frames, hw, d, dtype, masks):
    """((forward operations, bytes), (backward operations, bytes)) of one
    call: a multiply-add is two operations, over the (query, key) pairs the
    mask lets through; forward reads q, k, v and writes o and lse, backward
    reads q, k, v, o, dO and lse and writes dq, dk, dv."""
    if kind == "dart":
        s = 2 * n_frames * hw
        pairs = int(masks.train_frame_mask(n_frames).sum()) * hw * hw
    else:
        s = hw
        pairs = s * s
    bh = b * heads
    item = torch.tensor([], dtype=dtype).element_size()
    mat = bh * s * d * item
    return ((4 * d * pairs * bh, 4 * mat + 4 * bh * s),
            (10 * d * pairs * bh, 8 * mat + 4 * bh * s))


def flash_tol(want, s):
    """fp32: the same products and exponentials summed in another order, a
    random walk of rounding errors over a sum of up to S terms, each step up
    to the unit roundoff of the largest value (8 steps)."""
    return 8 * EPS32 * s ** 0.5 * max(1.0, float(want.abs().max()))


def serving_calls(cfg, frames=(1, 8)):
    """[(kind, batch, heads, n_frames, hw, d)] of the flash-attention calls
    of the rollout's frame layers at batch 1: full attention per frame over
    b*t = 1 frame (a cached denoiser call) and 8 frames (the prefill)."""
    out = set()
    for _, _, spec in cfg.block_layout():
        heads = cfg.num_heads(spec)
        if heads and spec["attention"] == "frame":
            hw, d = spec["res"] ** 2, spec["cout"] // heads
            out.update(("full", bt, heads, 1, hw, d) for bt in frames)
    return sorted(out)


def flash_phase(fa, masks, F, cfg, b=8, t=8, label="gym", odd=True):
    """The kernels against their plain versions at every attention shape
    of `cfg`'s DART and just_2d steps (batch b, T=t; keys labelled
    `label`), its rollout's frame-attention shapes ("serve") and, with
    `odd`, the odd shapes."""
    dev = torch.device(DEV)
    step = sorted(set(attention_calls(cfg, b, t, False) + attention_calls(cfg, b, t, True)))
    cases = ([(label, c) for c in step] + [("serve", c) for c in serving_calls(cfg)]
             + ([("odd", ("dart", 1, 2, 3, 40, 32)), ("odd", ("full", 3, 2, 1, 40, 32))]
                if odd else []))
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, (label, shape) in enumerate(cases):
            kind, bb, heads, n_frames, hw, d = shape
            s = 2 * n_frames * hw if kind == "dart" else hw
            g = torch.Generator(device=dev).manual_seed(200 + i)
            q, k, v, do = (torch.randn((bb, heads, s, d), generator=g, device=dev)
                           for _ in range(4))
            qs, k, v, do = (q * d ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
            o, lse = fa.flash_attention_fwd(qs, k, v, kind, n_frames, hw)
            o_p, lse_p = fa.flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw)
            grads = fa.flash_attention_bwd(qs, k, v, o_p, lse_p, do, kind, n_frames, hw)
            grads_p = fa.flash_attention_bwd_plain(qs, k, v, o_p, lse_p, do, kind, n_frames, hw)
            torch.cuda.synchronize()
            ok, errs, worst = True, {}, 0.0
            for name, got, want in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + grads,
                                       (o_p, lse_p) + grads_p):
                diff = got.float() - want.float()
                max_abs = float(diff.abs().max())
                worst = max(worst, max_abs)
                if dtype == torch.float32 or name == "lse":  # lse is fp32 in both
                    tol = flash_tol(want.float(), s)
                    err = max_abs
                else:
                    tol = TOL_BF16
                    err = float(diff.std() / want.float().std())
                errs[name] = (err, tol)
                ok = ok and err <= tol and bool(torch.isfinite(got).all())
            mask = fa._token_mask(kind, n_frames, hw, s, dev)
            leaves = [a.detach().requires_grad_(True) for a in (qs, k, v)]
            # SDPA on the kernel's mask; for the full kind also with no mask
            # (the same function), and the faster of the two is the yardstick
            lib_masks = {"mask": mask, "none": None} if kind == "full" else {"mask": mask}
            lib = {}
            for name, am in lib_masks.items():

                def sdpa(am=am):
                    return F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=1.0)

                def sdpa_fb():
                    sdpa().backward(do)

                with torch.no_grad():
                    lib_f = device_ms(sdpa)
                lib_fb = device_ms(sdpa_fb)
                lib[name] = (lib_f, max(lib_fb - lib_f, 0.0))

            def fwd():
                return fa.flash_attention_fwd(qs, k, v, kind, n_frames, hw)

            def bwd():
                return fa.flash_attention_bwd(qs, k, v, o, lse, do, kind, n_frames, hw)

            ms_f, ms_b = device_ms(fwd), device_ms(bwd)
            wall_f, wall_b = time_ms(fwd), time_ms(bwd)
            plain_f = time_ms(lambda: fa.flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw),
                              10, 1)
            plain_b = time_ms(lambda: fa.flash_attention_bwd_plain(qs, k, v, o, lse, do, kind,
                                                                   n_frames, hw), 10, 1)
            (ff, fb), (bf, bb_) = flash_cost(kind, bb, heads, n_frames, hw, d, dtype, masks)
            bound_f, by_f = bound(ff, fb, dtype)
            bound_b, by_b = bound(bf, bb_, dtype)
            key = (label, shape, dname)
            results[key] = dict(ok=bool(ok), max_abs_err=worst, errs=errs, fwd_ms=ms_f,
                                bwd_ms=ms_b, wall_fwd_ms=wall_f, wall_bwd_ms=wall_b,
                                plain_fwd_ms=plain_f, plain_bwd_ms=plain_b,
                                library_fwd_ms=min(v[0] for v in lib.values()),
                                library_bwd_ms=min(v[1] for v in lib.values()),
                                library_by_mask={n: list(v) for n, v in lib.items()},
                                bound_fwd_ms=bound_f, bound_bwd_ms=bound_b,
                                bound_fwd_by=by_f, bound_bwd_by=by_b)
            detail = " ".join(f"{n}={e:.2e}/{tl:.1e}" for n, (e, tl) in errs.items())
            sdpa_txt = " ".join(f"sdpa[{n}]={f_:.4f}+{b_:.4f}" for n, (f_, b_) in lib.items())
            log(f"# flash {dname:8s} {label} {kind} b={bb} h={heads} S={s} hw={hw} d={d} "
                f"ok={ok} {detail} | device ms fwd={ms_f:.4f} bwd={ms_b:.4f} {sdpa_txt} "
                f"| wall ms fwd={wall_f:.4f} bwd={wall_b:.4f} plain={plain_f:.4f}+{plain_b:.4f} "
                f"| bound={bound_f:.5f}+{bound_b:.5f} ({by_f}, {by_b})")
    return results


# ---------------------------------------------------------------------------
# phase 3: fused decode Block

def decode_block_shapes(cfg):
    """[(block name, (H, Cin, C0, Co, flavor, has_skip))] of every
    attention-free Block of the model, in execution order."""
    out = []
    for side, name, spec in cfg.block_layout():
        if spec["kind"] != "block" or spec["attention"] is not None:
            continue
        cin, co = spec["cin"], spec["cout"]
        c0 = co if spec["flavor"] == "enc" else cin
        out.append((f"{side}_{name}", (spec["res"], cin, c0, co, spec["flavor"], cin != co)))
    return out


def block_inputs(shape, dtype, with_ctx, seed):
    from autoregressive_diffusion_tpu_torch.ops.numerics import mp_weight
    h, cin, c0, co, flavor, has_skip = shape
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    args = dict(
        x=rn(1, 1, h, h, cin).to(dtype),
        a0=rn(1, 2, h, h, c0).to(dtype) if with_ctx else None,
        a1=rn(1, 2, h, h, co).to(dtype) if with_ctx else None,
        wsk=mp_weight(rn(cin, co)).to(dtype) if has_skip else None,
        w20=mp_weight(rn(3, 3, c0, co)).to(dtype),
        w30=mp_weight(rn(2, 3, 3, c0, co)).to(dtype),
        w21=mp_weight(rn(3, 3, co, co)).to(dtype),
        w31=mp_weight(rn(2, 3, 3, co, co)).to(dtype),
        cv=(1.0 + 0.5 * rn(1, co)).to(dtype),
        gates=(0.1 + 0.8 * torch.rand((1, 2), generator=g, device=dev)))
    return args, dict(flavor=flavor, res_t=0.3, clip=256.0, with_ctx=with_ctx)


def block_cost(shape, dtype, with_ctx=True):
    """(operations, bytes) of one fused Block step: both convolutions' and
    the skip's multiply-adds as two operations each; each input read once,
    each output written once."""
    h, cin, c0, co, _, has_skip = shape
    taps = 27 if with_ctx else 9
    hw = h * h
    flops = 2 * hw * (taps * c0 * co + taps * co * co + (cin * co if has_skip else 0))
    elems = (hw * cin + (2 * hw * (c0 + co) if with_ctx else 0)
             + taps * (c0 + co) * co + (cin * co if has_skip else 0) + co
             + hw * (co + c0 + co))
    item = torch.tensor([], dtype=dtype).element_size()
    return flops, elems * item + 8


def decode_block_phase(fc, cfg):
    order = ("x", "a0", "a1", "wsk", "w20", "w30", "w21", "w31", "cv", "gates")
    shapes = decode_block_shapes(cfg)
    unique = sorted(set(s for _, s in shapes), key=lambda s: (-s[0], s[1], s[3]))
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(unique):
            for with_ctx in ((True, False) if i < 2 else (True,)):
                args, kw = block_inputs(shape, dtype, with_ctx, seed=i)
                pos = [args[n] for n in order]
                got = fc.fused_decode_block(*pos, **kw)
                want = fc.fused_decode_block_plain(*pos, **kw)
                torch.cuda.synchronize()
                worst, errs, ok = 0.0, [], True
                for gg, ww in zip(got, want):
                    max_abs, err, tol, ok_one = compare(gg, ww, dtype, TOL_FP32_BLOCK)
                    worst = max(worst, max_abs)
                    errs.append(err)
                    ok = ok and ok_one

                def kernel():
                    return fc.fused_decode_block(*pos, **kw)

                ms, wall_ms = device_ms(kernel), time_ms(kernel)
                plain_ms = time_ms(lambda: fc.fused_decode_block_plain(*pos, **kw))
                flops, nbytes = block_cost(shape, dtype, with_ctx)
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                key = (shape, str(dtype).split(".")[-1], with_ctx)
                results[key] = dict(max_abs_err=worst, err=max(errs), tol=tol, ok=bool(ok),
                                    ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
                h, cin, c0, co, flavor, skip = shape
                log(f"# block {key[1]:8s} H={h:2d} Cin={cin:3d} C0={c0:3d} Co={co:3d} "
                    f"{flavor} skip={int(skip)} ctx={int(with_ctx)} max_abs={worst:.3e} "
                    f"err={max(errs):.3e} tol={tol:.0e} ok={ok} device_ms={ms:.4f} "
                    f"wall_ms={wall_ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
                    f"({bound_by})")
    return shapes, results


# ---------------------------------------------------------------------------
# phase 4: end to end against the plain versions on the CPU

def e2e_phase(make, init_cache, label, ctx_frames):
    """make(device) -> the fp32 model on that device."""
    dev = torch.device(DEV)
    gpu, cpu = make(DEV), make("cpu")
    cfg = gpu.cfg
    g = torch.Generator().manual_seed(2)
    r, c = cfg.img_resolution, cfg.img_channels
    x = torch.randn((1, ctx_frames + 1, r, r, c), generator=g)
    s = torch.full((1, ctx_frames + 1), 0.05)
    s[:, -1] = 2.0
    cond = torch.zeros((1, ctx_frames + 1), dtype=torch.long)
    errs = {}
    with torch.no_grad():
        outs = {}
        for name, m, d in (("gpu", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
            cache = init_cache(m, 1, device=d)
            y0, cache = m(x[:, :ctx_frames].to(d), s[:, :ctx_frames].to(d),
                          cond[:, :ctx_frames].to(d), cache=cache, update_cache=True)
            y1, _ = m(x[:, ctx_frames:].to(d), s[:, ctx_frames:].to(d),
                      cond[:, ctx_frames:].to(d), cache=cache, update_cache=True)
            y2, _ = m(x[:, ctx_frames:].to(d), s[:, ctx_frames:].to(d),
                      cond[:, ctx_frames:].to(d), just_2d=True)
            outs[name] = [y.float().cpu() for y in (y0, y1, y2)]
    ok = True
    for what, a, b in zip(("prefill", "decode", "just_2d"), outs["gpu"], outs["cpu"]):
        sd = float((a.double() - b.double()).std())
        finite = bool(torch.isfinite(a).all())
        errs[what] = sd
        ok = ok and finite and sd <= TOL_E2E
        log(f"# e2e {label}: {what} std(gpu-cpu)={sd:.3e} tol={TOL_E2E:.0e} "
            f"std(ref)={float(b.std()):.3f} finite={finite}")
    return ok, errs


# phase 5 (and 9 (b), (c)): the main path

def serve_phase(rollout, fa, fc, cfg, n_blocks, model, label, bench_iters):
    """The rollout on `model` (bf16 body): prefill 8 context frames into a
    fresh cache, `bench_iters` timed cached calls, generate 2 frames (64
    Heun steps, rho=2, sigma in [0.4, 80]), re-prime 2 frames at offset 10,
    with every launch counter zeroed before and read after. The counts must
    be 6 per prefill call for the prefill attention, 17 per denoiser call
    for the decode Block and 5 per model call for the frame layers' flash
    forward."""
    n_weights = sum(t.numel() for t in list(model.parameters()) + list(model.buffers()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_gen, n_steps = 2, 64
    fa.launches = fc.launches = 0
    zero_flash_counts(fa)
    out = rollout(model, context_frames=8, gen_frames=n_gen, num_steps=n_steps,
                  sigma_max=80.0, sigma_min=0.4, rho=2.0, reprime_frames=2,
                  bench_iters=bench_iters, seed=0)
    torch.cuda.synchronize()
    counts = dict(prefill=fa.launches, block=fc.launches, flash=flash_counts(fa))
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    frames = out["frames"]
    denoiser_calls = 1 + bench_iters + n_gen * (2 * n_steps - 1)
    n_video = sum(1 for _, _, sp in cfg.block_layout()
                  if sp.get("attention") == "video" and cfg.num_heads(sp))
    n_frame = sum(1 for _, _, sp in cfg.block_layout()
                  if sp.get("attention") == "frame" and cfg.num_heads(sp))
    model_calls = denoiser_calls + 2  # and the prefill and the re-prime
    want = dict(prefill=n_video * 2, block=n_blocks * denoiser_calls,  # gym: 6 and 17
                flash=(0, 0, n_frame * model_calls, 0))
    finite = bool(torch.isfinite(frames).all())
    log(f"# rollout {label}: {n_weights / 1e6:.1f}M weights, bf16 body, frames "
        f"{tuple(frames.shape)} finite={finite} cache frames={out['cache']['frames']} "
        f"prefill_s={out['prefill_s']:.4f} decode_ms_per_call={out['decode_ms_per_call']:.3f} "
        f"rollout_frames_per_sec={out['rollout_frames_per_sec']:.4f} "
        f"reprime_s={out['reprime_s']:.4f} peak_mem_mb={peak_mb:.1f}")
    log(f"# launches {label}: prefill attention {counts['prefill']} (want {want['prefill']}), "
        f"decode block {counts['block']} (want {want['block']} = {n_blocks} x "
        f"{denoiser_calls} calls), flash dart fwd/bwd, full fwd/bwd {counts['flash']} (want "
        f"{want['flash']}: {n_frame} frame layers x {model_calls} model calls)")
    failures = []
    res, ch = cfg.img_resolution, cfg.img_channels
    if not finite or tuple(frames.shape) != (1, n_gen, res, res, ch):
        failures.append(f"rollout output ({label})")
    if out["cache"]["frames"] != 12:
        failures.append(f"cache frame counter {out['cache']['frames']} != 12 ({label})")
    if counts != want:
        failures.append(f"launch counts ({label})")
    return dict(out=out, counts=counts, want=want, peak_mb=peak_mb,
                denoiser_calls=denoiser_calls, failures=failures)


# ---------------------------------------------------------------------------
# phase 9: trained weights, read from the committed bundles by the port's
# own reader

R3_BUNDLE = "saved_models/gym_r3/unet_46M_ema0.050_step40000_bfloat16.ad"
VAE_BUNDLE = "saved_models/vae_lunar_lander.ad"
TOL_INT8 = 0.05  # the JAX test's max |int8 - fp32| / max |fp32| (tests/test_unet.py:171-172)
TOL_PIX = 3e-4   # std(diff) of the float pixels in [0, 255], card vs CPU
TOL_U8 = 1       # max |diff| of the uint8 frames, card vs CPU


def kv_dtypes(cache):
    """The dtypes of every attention K/V ring of a cache."""
    out = set()
    for side in ("enc", "dec"):
        for entry in cache[side].values():
            if "attn" in entry:
                out |= {entry["attn"]["k"].dtype, entry["attn"]["v"].dtype}
    return out


def int8_block_check(fc, model):
    """The decode Block kernel on the int8 model's dequantized weights
    (decode_weights of every attention-free Block) against its plain
    version, bf16, random activations and rings: [(name, max |diff|,
    std(diff)/std(ref), ok)]."""
    dev, dt = torch.device(DEV), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)
    c_noise = torch.full((1, 1), 0.25, device=dev)
    rows = []
    for name, mod in model.unet.named_children():
        if not hasattr(mod, "conv_res0") or hasattr(mod, "attn"):
            continue
        w20, w30, g0 = mod.conv_res0.decode_weights(dt, c_noise, 10)
        w21, w31, g1 = mod.conv_res1.decode_weights(dt, c_noise, 10)
        wsk = mod.conv_skip.weight(dt)[0, 0] if hasattr(mod, "conv_skip") else None
        co, c0 = w21.shape[-1], w20.shape[-2]
        cin = wsk.shape[0] if wsk is not None else c0
        res = int(name.split("_")[1].split("x")[0])  # e.g. enc_32x32_down: after resampling
        x = torch.randn((1, 1, res, res, cin), generator=g, device=dev).to(dt)
        a0 = torch.randn((1, 2, res, res, c0), generator=g, device=dev).to(dt)
        a1 = torch.randn((1, 2, res, res, co), generator=g, device=dev).to(dt)
        cv = (1.0 + 0.5 * torch.randn((1, co), generator=g, device=dev)).to(dt)
        gates = torch.stack([g0[:, 0], g1[:, 0]], dim=1).float()
        args = (x, a0, a1, wsk, w20, w30, w21, w31, cv, gates, mod.flavor, mod.res_balance,
                mod.clip_act, True)
        got = fc.fused_decode_block(*args)
        want = fc.fused_decode_block_plain(*args)
        torch.cuda.synchronize()
        worst, errs, ok = 0.0, [], True
        for gg, ww in zip(got, want):
            max_abs, err, _, ok_one = compare(gg, ww, dt, TOL_FP32_BLOCK)
            worst, ok = max(worst, max_abs), ok and ok_one and bool(torch.isfinite(gg).all())
            errs.append(err)
        rows.append((name, worst, max(errs), ok))
    return rows


def kv_clipped_share(cache, frames):
    """The share of the written K/V ring components with |x| > 1, the
    range that the int8 rings keep (models/attention.py _quant_kv)."""
    n = big = 0
    for side in ("enc", "dec"):
        for entry in cache[side].values():
            if "attn" in entry:
                for name in ("k", "v"):
                    t = entry["attn"][name][:, :, :frames].float()
                    n, big = n + t.numel(), big + int((t.abs() > 1).sum())
    return big / max(n, 1)


def trained_phase(rollout, fa, fc, cfg, shapes, init_cache):
    """(a) the trained r3 denoiser in fp32, card against CPU; (b), (c) the
    main path on the r3 weights in bf16 and with int8 weights and K/V, each
    model alone on the card; the int8 model in fp32, card against CPU; the
    int8 output against the bf16 one on one cached call from the same
    context (recorded beside the JAX test's 0.05, which holds at its 16x16
    random-weight config and not here: PERF.md); the decode Block kernel on
    the int8 path's dequantized weights; (d) the generated latents to pixels
    with the trained VAE, card against CPU."""
    from autoregressive_diffusion_tpu_torch.models.vae import latents_to_pixels
    from autoregressive_diffusion_tpu_torch.utils import (from_bundle, load_model,
                                                          vae_from_bundle)

    failures, summary = [], {}
    r3, vae_path = str(ROOT / R3_BUNDLE), str(ROOT / VAE_BUNDLE)
    t0 = time.perf_counter()
    kwargs, variables = load_model(r3)
    summary["read_s"] = time.perf_counter() - t0
    log(f"# trained: read {R3_BUNDLE} in {summary['read_s']:.3f} s, kwargs {kwargs}")
    del variables

    # (a), and the int8 model the same way
    for label, int8 in (("trained r3", False), ("trained r3 int8", True)):
        ok, errs = e2e_phase(lambda d: from_bundle(r3, d, torch.float32, int8=int8),
                             init_cache, label, 2)
        summary[f"e2e {label}"] = errs
        if not ok:
            failures.append(f"end to end, {label} weights, card against CPU")

    # (b), (c): each model alone on the card (its peak memory)
    runs = {}
    for label, int8 in (("r3 bf16", False), ("r3 int8", True)):
        model = from_bundle(r3, DEV, torch.bfloat16, int8=int8)
        run = serve_phase(rollout, fa, fc, cfg, len(shapes), model, label, bench_iters=5)
        failures += run["failures"]
        cache = run["out"].pop("cache")
        kv = kv_dtypes(cache)
        want_kv = {torch.int8} if int8 else {torch.bfloat16}
        log(f"# trained {label}: K/V ring dtypes {sorted(map(str, kv))} (want "
            f"{sorted(map(str, want_kv))})")
        if kv != want_kv:
            failures.append(f"K/V ring dtypes ({label})")
        if not int8:
            summary["kv_clipped_share"] = kv_clipped_share(cache, 12)
            latents = run["out"].pop("frames").float()
        runs[label] = run
        del model, cache
        torch.cuda.empty_cache()

    # one cached call from the same 8-frame context: int8 against bf16, and
    # where the difference comes from (the int8 model on bf16 rings: its
    # weights alone; the bf16 model on int8 rings: the rings alone; bf16
    # against fp32 as the yardstick)
    g = torch.Generator(device=DEV).manual_seed(7)
    res, ch = cfg.img_resolution, cfg.img_channels
    ctx = torch.randn((1, 8, res, res, ch), generator=g, device=DEV)
    x1 = torch.randn((1, 1, res, res, ch), generator=g, device=DEV)
    sig, s1 = torch.full((1, 8), 0.05, device=DEV), torch.ones((1, 1), device=DEV)
    cond = torch.zeros((1, 8), dtype=torch.long, device=DEV)
    models = {"bf16": from_bundle(r3, DEV, torch.bfloat16),
              "int8": from_bundle(r3, DEV, torch.bfloat16, int8=True),
              "fp32": from_bundle(r3, DEV, torch.float32)}

    def one_call(model, ring_model):
        c = init_cache(ring_model, 1, device=DEV)
        _, c = model(ctx, sig, cond, cache=c, update_cache=True)
        return model(x1, s1, cond[:, :1], cache=c)[0].float()

    with torch.no_grad():
        ys = {"int8": one_call(models["int8"], models["int8"]),
              "int8 weights alone": one_call(models["int8"], models["bf16"]),
              "int8 rings alone": one_call(models["bf16"], models["int8"]),
              "fp32": one_call(models["fp32"], models["fp32"])}
        ybf = one_call(models["bf16"], models["bf16"])
        blocks = int8_block_check(fc, models["int8"])
    del models
    torch.cuda.empty_cache()
    breakdown = {}
    for label, y in ys.items():
        breakdown[label] = (float((y - ybf).abs().max() / ybf.abs().max()),
                            float((y - ybf).std() / ybf.std()))
        log(f"# trained one cached call, {label} against bf16: max|diff|/max|bf16| = "
            f"{breakdown[label][0]:.4f}, std(diff)/std(bf16) = {breakdown[label][1]:.4f}")
    rel, std_rel = breakdown["int8"]
    finite = bool(torch.isfinite(ys["int8"]).all())
    log(f"# trained int8 vs bf16: max|diff|/max|bf16| = {rel:.4f} finite={finite}; the JAX "
        f"test's bound {TOL_INT8} (tests/test_unet.py:171, a 16x16 random-weight model) "
        f"{'met' if rel <= TOL_INT8 else 'NOT met'} here, recorded, not held (PERF.md); "
        f"{summary['kv_clipped_share']:.3f} of the bf16 K/V components lie outside the int8 "
        f"rings' [-1, 1]")
    if not finite:
        failures.append("int8 output not finite")
    for name, worst, err, ok_b in blocks:
        log(f"# block int8 {name}: dequantized weights, kernel vs plain max_abs={worst:.3e} "
            f"err={err:.3e} tol={TOL_BF16:.0e} ok={ok_b}")
    if len(blocks) != len(shapes) or not all(b[3] for b in blocks):
        failures.append("decode block on int8 weights")
    summary.update(int8_rel=rel, int8_std_rel=std_rel, int8_breakdown=breakdown,
                   int8_blocks=blocks,
                   runs={k: dict(counts=v["counts"], want=v["want"], peak_mb=v["peak_mb"],
                                 **{n: v["out"][n] for n in ("prefill_s", "decode_ms_per_call",
                                                             "rollout_frames_per_sec",
                                                             "generate_s", "reprime_s")})
                         for k, v in runs.items()})

    # (d)
    vae_gpu, _ = vae_from_bundle(vae_path, DEV)
    vae_cpu, _ = vae_from_bundle(vae_path, "cpu")
    torch.cuda.reset_peak_memory_stats()
    pix = latents_to_pixels(vae_gpu, latents, 0.0, 1.0)
    torch.cuda.synchronize()
    vae_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    vae_ms = time_ms(lambda: latents_to_pixels(vae_gpu, latents, 0.0, 1.0), iters=5, warmup=1)
    t0 = time.perf_counter()
    pix_cpu = latents_to_pixels(vae_cpu, latents.cpu(), 0.0, 1.0)
    cpu_s = time.perf_counter() - t0
    pix = pix.cpu()
    finite = bool(torch.isfinite(pix).all())
    sd = float((pix.double() - pix_cpu.double()).std())
    u8 = int((pix.to(torch.uint8).int() - pix_cpu.to(torch.uint8).int()).abs().max())
    tc, sc = vae_gpu.cfg.time_compression, vae_gpu.cfg.spatial_compression
    want_shape = (1, latents.shape[1] * tc, res * sc, res * sc, 3)
    ok_vae = (finite and tuple(pix.shape) == want_shape and sd <= TOL_PIX and u8 <= TOL_U8)
    log(f"# trained VAE: latents {tuple(latents.shape)} -> uint8 frames {tuple(pix.shape)} "
        f"(want {want_shape}) finite={finite} std(gpu-cpu) of float pixels={sd:.3e} "
        f"(tol {TOL_PIX:.0e}) max |uint8 diff|={u8} (tol {TOL_U8}) ok={ok_vae}; "
        f"decode {vae_ms:.2f} ms on the card (wall, events), {cpu_s:.2f} s on the CPU; "
        f"peak {vae_peak:.1f} MB")
    if not ok_vae:
        failures.append("VAE decode, card against CPU")
    summary["vae"] = dict(shape=list(pix.shape), std_diff=sd, max_u8_diff=u8, ms=vae_ms,
                          cpu_s=cpu_s, peak_mb=vae_peak)
    return dict(runs=runs, summary=summary), failures


# ---------------------------------------------------------------------------
# phase 6: the train-mode fused gated conv, forward and backward

def conv_calls(cfg):
    """[(module name, (H, C, Co, silu_in, has_cvec))] of every causal conv
    of the model, in execution order."""
    out = []
    for side, name, spec in cfg.block_layout():
        r, cin, co = spec["res"], spec["cin"], spec["cout"]
        full = name if side == "out" else f"{side}_{name}"
        if spec["kind"] == "conv":
            out.append((full, (r, cin, co, False, False)))
        else:
            c0 = co if spec["flavor"] == "enc" else cin
            out.append((f"{full}.conv_res0", (r, c0, co, True, False)))
            out.append((f"{full}.conv_res1", (r, co, co, True, True)))
    return out


def conv_inputs(b, f, h, w, c, co, has_cv, with_ctx, dtype, seed):
    from autoregressive_diffusion_tpu_torch.ops.numerics import mp_weight
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    args = [rn(b, f, h, w, c).to(dtype), mp_weight(rn(3, 3, c, co)).to(dtype),
            mp_weight(rn(2, 3, 3, c, co)).to(dtype) if with_ctx else None,
            (1.0 + 0.3 * rn(b, f, c)).to(dtype) if has_cv else None,
            (0.05 + 0.9 * torch.rand((b, f), generator=g, device=dev)) if with_ctx else None]
    return args, rn(b, f, h, w, co).to(dtype)


def unfused_cudnn_conv(x, w2, w3, cvec, gates, silu_in, with_ctx):
    """The unfused path in the working type: elementwise transform, one
    F.conv2d per frame, one F.conv2d over the two past clean frames stacked
    on channels, gate blend. A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    b, f, h, w, c = x.shape
    a = x
    if cvec is not None:
        a = a * cvec[:, :, None, None, :]
    if silu_in:
        a = F.silu(a) / 0.596

    def conv(inp, wt):
        y = F.conv2d(inp.reshape((-1,) + tuple(inp.shape[2:])).permute(0, 3, 1, 2),
                     wt.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
        return y.reshape(tuple(inp.shape[:2]) + tuple(y.shape[1:]))

    y2d = conv(a, w2)
    if not with_ctx:
        return y2d
    t = f // 2
    hist = torch.cat([torch.ones_like(a[:, :2]), a[:, :t - 1]], dim=1)
    xs = torch.cat([hist[:, :t], hist[:, 1:t + 1]], dim=-1)
    ctx = conv(xs, w3.permute(1, 2, 0, 3, 4).reshape(3, 3, 2 * c, -1))
    ctx = torch.cat([ctx, ctx], dim=1)
    g = gates.to(x.dtype)[:, :, None, None, None]
    return (y2d + (ctx - y2d) * g) * ((1 - g) ** 2 + g ** 2) ** -0.5


def conv_cost(b, f, h, w, c, co, has_cv, with_ctx, dtype):
    """((forward operations, bytes), (backward operations, bytes)): a
    multiply-add is two operations; each input read once, each output
    written once (the forward's diff residual included)."""
    t = f // 2
    mac = b * h * w * c * co * 9
    item = torch.tensor([], dtype=dtype).element_size()
    n_x, n_o = b * f * h * w * c, b * f * h * w * co
    n_w = 9 * c * co * (3 if with_ctx else 1)
    n_cv = b * f * c if has_cv else 0
    fwd = 2 * mac * (f + (2 * t if with_ctx else 0))
    fwd_bytes = item * (n_x + n_w + n_cv + n_o * (2 if with_ctx else 1)) + 4 * b * f
    # dx: every frame's 2D conv and the clean frames' context taps that
    # exist; dw: every product of the forward pass, the ones frames' included
    ctx_taps = max(t - 1, 0) + max(t - 2, 0) if with_ctx else 0
    bwd = 2 * mac * (f + ctx_taps) + 2 * mac * (f + (2 * t if with_ctx else 0))
    bwd_bytes = (item * (2 * n_x + 2 * n_w + 2 * n_cv + n_o * (3 if with_ctx else 1))
                 + 8 * b * f)
    return (fwd, fwd_bytes), (bwd, bwd_bytes)


def conv_phase(fc, cfg, b=8, t=8, label="gym", odd=True):
    """Kernels against the plain version at every distinct causal conv of
    the model (batch b, T=t; keys labelled `label`) and, with `odd`, the odd
    shapes, fp32 and bf16; bf16 also run twice, bit for bit. Times: the
    forward and the backward entry point each on its own, and the unfused
    cuDNN path's forward and its backward (autograd over a kept graph), as
    device time (device_ms) and as wall time a call; the plain version's as
    wall time."""
    calls = conv_calls(cfg)
    shapes = sorted(set(s for _, s in calls), key=lambda s: (-s[0], s[1], s[2], s[3], s[4]))
    cases = [(label, b, 2 * t if ctx else t, h, h, c, co, silu, cv, ctx)
             for (h, c, co, silu, cv) in shapes for ctx in (True, False)]
    if odd:
        cases.append(("odd", 1, 6, 24, 40, 9, 32, True, True, True))
        cases.append(("odd", 1, 3, 24, 40, 9, 32, True, True, False))
    names = ("out", "dx", "dw2", "dw3", "dcvec", "dgates")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for i, (kind, bb, f, h, w, c, co, silu, has_cv, ctx) in enumerate(cases):
            args, gout = conv_inputs(bb, f, h, w, c, co, has_cv, ctx, dtype, seed=100 + i)
            sums = dict(out=27 * c if ctx else 9 * c, dx=27 * co if ctx else 9 * co,
                        dw2=bb * f * h * w, dw3=bb * (f // 2) * h * w, dcvec=h * w * 27 * co,
                        dgates=h * w * co)

            def run(fn):
                leaves = [None if a is None else a.detach().requires_grad_(True)
                          for a in args]
                out = fn(*leaves, silu, ctx)
                out.backward(gout)
                return [out.detach()] + [None if l is None else l.grad for l in leaves]

            got = run(fc.fused_gated_conv)
            want = run(fc.fused_gated_conv_plain)
            repeat = None
            if dtype == torch.bfloat16:
                again = run(fc.fused_gated_conv)
                repeat = all(a is None or torch.equal(a, r) for a, r in zip(got, again))
            torch.cuda.synchronize()
            ok, errs, worst = repeat is not False, {}, 0.0
            for name, gg, ww in zip(names, got, want):
                if ww is None and gg is None:
                    continue
                diff = gg.float() - ww.float()
                max_abs = float(diff.abs().max())
                ref_max = float(ww.float().abs().max())
                worst = max(worst, max_abs)
                if dtype == torch.float32:
                    # the same fp32 products in another order: a random walk
                    # of rounding errors over the length of the sum, each
                    # step up to the unit roundoff of the largest value. 8
                    # steps, because the plain version's cuDNN weight
                    # gradient is the looser side: dw_float64_check holds
                    # the kernel alone to 4 against a float64 reference.
                    tol = max(1e-6, 8 * EPS32 * sums[name] ** 0.5 * ref_max)
                    err, good = max_abs, max_abs <= tol
                else:
                    tol = TOL_BF16
                    err = float(diff.std() / ww.float().std()) if ww.numel() > 1 else 0.0
                    good = err <= tol
                    if name == "dgates" and not good:
                        # the kernel reads the residuals out and diff in bf16,
                        # autograd keeps them in fp32: each of the H*W*Co
                        # terms is off by up to 2^-9 of its size (about 1)
                        tol = 4 * 2 ** -9 * sums[name] ** 0.5
                        err, good = max_abs, max_abs <= tol
                errs[name] = (err, tol)
                ok = ok and good and bool(torch.isfinite(gg).all())
            iters = 5
            leaves = [None if a is None else a.detach().requires_grad_(True) for a in args]
            need = [l for l in leaves if l is not None]

            def fwd_only(fn):
                with torch.no_grad():
                    return fn(*args, silu, ctx)

            saved_out, saved_diff = fc._launch_conv_fwd(*args, silu, ctx, True)

            def kernel_bwd():
                return fc._launch_conv_bwd(*args, gout, saved_diff, saved_out, silu, ctx, True)

            def graph_bwd(out):
                return lambda: torch.autograd.grad(out, need, gout, retain_graph=True)

            plain_out = fc.fused_gated_conv_plain(*leaves, silu, ctx)
            unf_out = unfused_cudnn_conv(*leaves, silu, ctx)
            r = dict(
                fwd_ms=device_ms(lambda: fwd_only(fc.fused_gated_conv), iters, 1),
                bwd_ms=device_ms(kernel_bwd, iters, 1),
                unfused_fwd_ms=device_ms(lambda: fwd_only(unfused_cudnn_conv), iters, 1),
                unfused_bwd_ms=device_ms(graph_bwd(unf_out), iters, 1),
                fwd_wall_ms=time_ms(lambda: fwd_only(fc.fused_gated_conv), iters, 1),
                bwd_wall_ms=time_ms(kernel_bwd, iters, 1),
                unfused_fwd_wall_ms=time_ms(lambda: fwd_only(unfused_cudnn_conv), iters, 1),
                unfused_bwd_wall_ms=time_ms(graph_bwd(unf_out), iters, 1),
                plain_fwd_ms=time_ms(lambda: fwd_only(fc.fused_gated_conv_plain), iters, 1),
                plain_bwd_ms=time_ms(graph_bwd(plain_out), iters, 1))
            del plain_out, unf_out
            (ff, fb), (bf, bb_) = conv_cost(bb, f, h, w, c, co, has_cv, ctx, dtype)
            bound_f, by_f = bound(ff, fb, dtype)
            bound_b, by_b = bound(bf, bb_, dtype)
            key = (kind, bb, f, h, w, c, co, silu, has_cv, ctx, dname)
            results[key] = dict(ok=bool(ok), max_abs_err=worst, errs=errs, repeat=repeat, **r,
                                bound_fwd_ms=bound_f, bound_bwd_ms=bound_b, bound_fwd_by=by_f,
                                bound_bwd_by=by_b)
            detail = " ".join(f"{n}={e:.2e}/{tl:.1e}" for n, (e, tl) in errs.items())
            log(f"# conv {dname:8s} {kind} B={bb} F={f:2d} {h:2d}x{w:2d} C={c:3d} Co={co:3d} "
                f"silu={int(silu)} cv={int(has_cv)} ctx={int(ctx)} ok={ok} repeat={repeat} "
                f"{detail} | device ms fwd={r['fwd_ms']:.4f} bwd={r['bwd_ms']:.4f} "
                f"unfused={r['unfused_fwd_ms']:.4f}+{r['unfused_bwd_ms']:.4f} | wall ms "
                f"fwd={r['fwd_wall_ms']:.3f} bwd={r['bwd_wall_ms']:.3f} "
                f"unfused={r['unfused_fwd_wall_ms']:.3f}+{r['unfused_bwd_wall_ms']:.3f} "
                f"plain={r['plain_fwd_ms']:.3f}+{r['plain_bwd_ms']:.3f} | "
                f"bound={bound_f:.4f}+{bound_b:.4f} ({by_f}, {by_b})")
    return calls, results


def dw_float64_check(fc):
    """The fp32 weight gradient of the kernel and of the plain version, each
    against a float64 reference (just_2d, batch 8 x 8 frames, 64x64, 64 -> 64
    channels: sums of 262,144 products). The kernel is held to half the
    bound that the kernel-against-plain comparison allows; the plain
    version's error is logged beside it."""
    import torch.nn.functional as F
    b, f, h, c, co = 8, 8, 64, 64, 64
    args, gout = conv_inputs(b, f, h, h, c, co, False, False, torch.float32, seed=7)

    def dw2(fn):
        w2 = args[1].detach().requires_grad_(True)
        fn(args[0], w2, None, None, None, True, False).backward(gout)
        return w2.grad.double()

    x = args[0].float()
    a = (torch.sigmoid(x) * x * (1.0 / 0.596)).double().reshape(b * f, h, h, c)
    w64 = args[1].double().requires_grad_(True)
    y = F.conv2d(a.permute(0, 3, 1, 2), w64.permute(3, 2, 0, 1), padding=1)
    y.backward(gout.double().reshape(b * f, h, h, co).permute(0, 3, 1, 2))
    ref = w64.grad
    ref_max = float(ref.abs().max())
    err_k = float((dw2(fc.fused_gated_conv) - ref).abs().max())
    err_p = float((dw2(fc.fused_gated_conv_plain) - ref).abs().max())
    tol = 4 * EPS32 * (b * f * h * h) ** 0.5 * ref_max
    ok = err_k <= tol
    log(f"# conv dw2 fp32 against float64 (max|ref|={ref_max:.1f}): kernel err={err_k:.3e} "
        f"tol={tol:.3e} ok={ok}; plain version (cuDNN) err={err_p:.3e}")
    return ok, err_k, err_p


def conv_kernel_rows(calls, conv_results, launches_cf, launches_cb):
    """The `kernels` rows of the two conv kernels: sums over the causal convs
    of one DART step (batch 8, T=8, bf16), logged with their per-shape means."""
    rows = []
    step_rows = [conv_results[("gym", 8, 16, h, h, c, co, silu, cv, True, "bfloat16")]
                 for _, (h, c, co, silu, cv) in calls]
    by_shape = {}
    for (_, (h, c, co, _, _)), r in zip(calls, step_rows):
        by_shape.setdefault((h, c, co), []).append(r)
    for (h, c, co), rs in sorted(by_shape.items(), key=lambda kv: (-kv[0][0], kv[0][1:])):
        mean = {k: sum(r[k] for r in rs) / len(rs) for k in rs[0] if k.endswith("_ms")}
        log(f"# conv-step {h:2d}x{h:2d} C={c:3d} Co={co:3d} calls={len(rs):2d} ms a call: "
            f"device fwd={mean['fwd_ms']:.4f} bwd={mean['bwd_ms']:.4f} "
            f"unfused={mean['unfused_fwd_ms']:.4f}+{mean['unfused_bwd_ms']:.4f}; "
            f"wall plain={mean['plain_fwd_ms']:.3f}+{mean['plain_bwd_ms']:.3f}; "
            f"bound={mean['bound_fwd_ms']:.4f}+{mean['bound_bwd_ms']:.4f}")
    for which, src, line, n_launch in (("fwd", "fused_conv_fwd.cu", 784, launches_cf),
                                       ("bwd", "fused_conv_bwd.cu", 879, launches_cb)):
        by = [r[f"bound_{which}_by"] for r in step_rows]
        rows.append(dict(
            name=f"fused_conv_{which}", route="cuda", source=f"{PKG}/csrc/{src}",
            replaces=f"autoregressive_diffusion_tpu/ops/fused_conv.py:{line}",
            launches=n_launch, max_abs_err=max(r["max_abs_err"] for r in step_rows),
            ms=sum(r[f"{which}_ms"] for r in step_rows),
            plain_ms=sum(r[f"plain_{which}_ms"] for r in step_rows),
            bound_ms=sum(r[f"bound_{which}_ms"] for r in step_rows),
            bound_by="operations" if by.count("operations") > len(by) / 2 else "bytes",
            library_ms=sum(r[f"unfused_{which}_ms"] for r in step_rows),
            ok=all(r["ok"] for r in conv_results.values())))
    share = " ".join(f"{r['name']} {r['ms']:.3f} vs library {r['library_ms']:.3f} ms "
                     f"({r['bound_ms'] / r['ms']:.1%} of the bound);" for r in rows)
    log(f"# fused_conv_fwd/bwd ms/plain_ms/bound_ms/library_ms are sums over the {len(calls)} "
        f"causal convs of one DART step (batch 8, T=8, bf16); ms and library_ms are device "
        f"times, the library being the unfused cuDNN path (F.conv2d in bf16 plus elementwise "
        f"ops, its backward by autograd), which the port never calls: {share} wall a step: "
        f"fwd {sum(r['fwd_wall_ms'] for r in step_rows):.3f}, bwd "
        f"{sum(r['bwd_wall_ms'] for r in step_rows):.3f} ms")
    return rows


# ---------------------------------------------------------------------------
# phase 7: the training path

def grad_parity_phase(build_trainer, edm2_loss, loss_cfg, overrides, fa):
    """One loss + backward of a small fp32 model on the card (kernels) and
    on the CPU (plain versions) from the same weights, images, sigma and
    noise; gradients compared leaf by leaf. The model has video and frame
    attention layers, and the card's run must launch both flash kernels."""
    g = torch.Generator().manual_seed(5)
    grads = {}
    zero_flash_counts(fa)
    b, t = 2, 3
    for dev in (DEV, "cpu"):
        state, _ = build_trainer(dev, torch.float32, seed=3, batch=b, **overrides)
        cfg = state.model.cfg
        if dev == DEV:
            r, c = cfg.img_resolution, cfg.img_channels
            images = torch.randn((b, t, r, r, c), generator=g)
            sigma = torch.exp(torch.randn((b, 2 * t), generator=g) * 0.8)
            noise = sigma[:, :, None, None, None] * torch.randn((b, 2 * t, r, r, c), generator=g)
            cond = torch.zeros((b, t), dtype=torch.long)
        loss, _ = edm2_loss(state.model, images.to(dev), 0, loss_cfg, cond.to(dev), state.coefs,
                            sigma=sigma.to(dev), noise=noise.to(dev))
        loss.backward()
        grads[dev] = ({n: p.grad.detach().float().cpu() for n, p in
                       state.model.named_parameters() if p.grad is not None}, float(loss.detach()))
        if dev == DEV:
            counts = flash_counts(fa)
    (gk, loss_k), (gp, loss_p) = grads[DEV], grads["cpu"]
    worst, worst_name = 0.0, ""
    ok = set(gk) == set(gp) and abs(loss_k - loss_p) <= 1e-5 * max(1.0, abs(loss_p))
    ok = ok and all(c > 0 for c in counts)
    for n, ref in gp.items():
        d = gk[n] - ref
        if ref.numel() > 1:
            err = float(d.std() / ref.std()) if float(ref.std()) > 0 else float(d.abs().max())
        else:
            err = float(d.abs() / ref.abs().clamp_min(1e-12))
        if err > worst:
            worst, worst_name = err, n
    ok = ok and worst <= TOL_GRAD
    log(f"# train grads, small fp32 model, card (kernels) vs CPU (plain): loss {loss_k:.6f} vs "
        f"{loss_p:.6f}; {len(gp)} leaves, worst std(diff)/std(ref)={worst:.3e} ({worst_name}) "
        f"tol={TOL_GRAD:.0e}; flash dart fwd/bwd, full fwd/bwd launches {counts} ok={ok}")
    return ok, worst


def train_phase(build_trainer, synthetic_batch, run_steps, fc, fa, n_convs):
    from autoregressive_diffusion_tpu_torch.models.attention import (FrameAttention,
                                                                     VideoAttention)
    dev = torch.device(DEV)
    b, t = 8, 8
    state, train_step = build_trainer(DEV, torch.bfloat16, seed=0, batch=b)
    model = state.model
    n_video = sum(isinstance(m, VideoAttention) for m in model.modules())
    n_frame = sum(isinstance(m, FrameAttention) for m in model.modules())
    want_flash = {False: (n_video, n_video, n_frame, n_frame),  # DART step
                  True: (0, 0, n_video + n_frame, n_video + n_frame)}  # just_2d step
    images, cond = synthetic_batch(model.cfg, b, t, 1, dev)
    ema0 = {n: v.clone() for n, v in state.ema[0].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.conv_fwd_launches = fc.conv_bwd_launches = 0
    zero_flash_counts(fa)
    rows, failures, counts, flash = [], [], [], []
    for i in range(4):  # DART, DART, DART, just_2d
        before = (fc.conv_fwd_launches, fc.conv_bwd_launches)
        before_flash = flash_counts(fa)
        rows += run_steps(state, train_step, images, cond, 1, seed=0, just_2d_every=4)
        counts.append((fc.conv_fwd_launches - before[0], fc.conv_bwd_launches - before[1]))
        flash.append(tuple(a - c for a, c in zip(flash_counts(fa), before_flash)))
        grads_finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        r = rows[-1]
        log(f"# train step {i} {'just_2d' if r['just_2d'] else 'dart':7s} loss={r['loss']:.4f} "
            f"grad_norm={r['grad_norm']:.4f} grads_finite={grads_finite} "
            f"step_ms={r['seconds'] * 1e3:.1f} samples_per_sec={r['samples_per_sec']:.3f} "
            f"conv launches fwd={counts[-1][0]} bwd={counts[-1][1]} (want {n_convs}); "
            f"flash dart fwd/bwd, full fwd/bwd {flash[-1]} (want {want_flash[r['just_2d']]})")
        if not (r["loss"] == r["loss"] and abs(r["loss"]) < float("inf")) or not grads_finite:
            failures.append(f"train step {i}: loss or gradients not finite")
        if counts[-1] != (n_convs, n_convs):
            failures.append(f"train step {i}: conv launches {counts[-1]} != {n_convs}")
        if flash[-1] != want_flash[r["just_2d"]]:
            failures.append(f"train step {i}: flash launches {flash[-1]} != "
                            f"{want_flash[r['just_2d']]}")
    launches = (fc.conv_fwd_launches, fc.conv_bwd_launches) + flash_counts(fa)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if [r["just_2d"] for r in rows] != [False, False, False, True]:
        failures.append("train steps: expected three DART steps and one just_2d step")
    worst_norm = 0.0
    for n, p in model.named_parameters():
        if n.rsplit(".", 1)[-1] == "w":
            dims = tuple(range(p.ndim - 1))
            fan_in = p[..., 0].numel()
            norm = p.detach().float().pow(2).sum(dim=dims).sqrt() / fan_in ** 0.5
            worst_norm = max(worst_norm, float((norm - 1).abs().max()))
    if worst_norm > 1e-3:
        failures.append(f"weights not unit norm after a step: {worst_norm:.2e}")
    moved = sum(float((state.ema[0][n] - ema0[n]).abs().max()) > 0 for n in ema0)
    if moved < 0.9 * len(ema0):
        failures.append(f"EMA moved in {moved} of {len(ema0)} leaves only")
    dart = [r for r in rows[1:] if not r["just_2d"]]
    step_ms = 1e3 * sum(r["seconds"] for r in dart) / len(dart)
    log(f"# train: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, bf16 body, "
        f"batch {b}, T={t}: DART step {step_ms:.1f} ms ({b * 1e3 / step_ms:.3f} samples/s, "
        f"steps 1-2; step 0 includes first-use costs {rows[0]['seconds'] * 1e3:.1f} ms), "
        f"just_2d step {rows[3]['seconds'] * 1e3:.1f} ms, peak_mem_mb={peak_mb:.1f}, "
        f"|norm-1| of w <= {worst_norm:.1e}, EMA moved {moved}/{len(ema0)}")
    summary = dict(rows=rows, dart_step_ms=step_ms, dart_samples_per_sec=b * 1e3 / step_ms,
                   just_2d_step_ms=rows[3]["seconds"] * 1e3, peak_mem_mb=peak_mb,
                   launches_per_step=counts, flash_launches_per_step=flash)
    return failures, launches, summary


# ---------------------------------------------------------------------------
# phase 8: sequence parallel (row 8): the kernels, then two ranks on the card

SP_COUNTERS = ("dart_sp_fwd_launches", "dart_sp_bwd_launches", "causal_sp_fwd_launches",
               "causal_sp_bwd_launches")
# a tiny model with every layer kind and action labels (per-frame cvec rows)
SP_SMALL = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
                channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
                frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)


def gathered_order(masks, kind, n_frames, hw, sp):
    """The clip's token index of each token of the rank-major gathered
    layout of `sp` seq ranks (x_gathered = x_clip[:, :, index])."""
    import numpy as np
    s = (2 if kind == "dart" else 1) * n_frames * hw
    j = np.arange(s)
    idx = masks.shard_frame(j // hw, n_frames // sp, n_frames, kind) * hw + j % hw
    return torch.from_numpy(idx).to(DEV)


def sp_cost(fa, kind, b, heads, n_frames, hw, d, sp, rank, dtype):
    """((forward operations, bytes), (backward operations, bytes)) of one
    rank's call: a multiply-add is two operations, over the (query, key)
    pairs the rank's mask lets through; the forward reads its q rows and the
    gathered k, v and writes o and lse rows, the backward reads q, o, dO,
    lse rows and k, v and writes dq rows and the partial dk, dv."""
    s = (2 if kind == "dart" else 1) * n_frames * hw
    sq = s // sp
    pairs = int(fa._token_mask_np(kind, n_frames, hw, sq, sp, rank).sum())
    bh = b * heads
    item = torch.tensor([], dtype=dtype).element_size()
    rows, keys = bh * sq * d * item, bh * s * d * item
    return ((4 * d * pairs * bh, 2 * rows + 2 * keys + 4 * bh * sq),
            (10 * d * pairs * bh, 4 * rows + 4 * keys + 4 * bh * sq))


def sp_kernel_phase(fa, masks, F, b=8, heads=4, hw=64, d=64):
    """Every seq rank's forward and backward kernel calls against their
    plain versions at the gym's video-attention shape (1024 tokens: DART
    over T=8, frame-causal over 16 frames), sp = 2 and 4, fp32 and bf16;
    the ranks' stacked o and dq and summed dk, dv against the one-rank
    kernels (DART: row 4; causal: the prefill kernel's o, row 5, and the
    plain backward); times of each rank's call, its plain version and
    F.scaled_dot_product_attention on the same rows and mask (kernel and
    SDPA: device times)."""
    dev = torch.device(DEV)
    results = {}
    for kind, n_frames in (("dart", 8), ("causal", 16)):
        s = (2 if kind == "dart" else 1) * n_frames * hw
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            g = torch.Generator(device=dev).manual_seed(300 + n_frames)
            q, k, v, do = (torch.randn((b, heads, s, d), generator=g, device=dev)
                           for _ in range(4))
            qs, k, v, do = (q * d ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
            if kind == "dart":
                o1, lse1 = fa.flash_attention_fwd(qs, k, v, kind, n_frames, hw)
                g1 = fa.flash_attention_bwd(qs, k, v, o1, lse1, do, kind, n_frames, hw)
                o_one = o1
            else:
                o1, lse1 = fa.flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw)
                g1 = fa.flash_attention_bwd_plain(qs, k, v, o1, lse1, do, kind, n_frames, hw)
                o_one = fa.prefill_attention(qs, k, v, n_frames, n_frames, 0, hw)
            for sp in (2, 4):
                sq = s // sp
                idx = gathered_order(masks, kind, n_frames, hw, sp)
                kg, vg = k[:, :, idx].contiguous(), v[:, :, idx].contiguous()
                outs, dqs, dk_sum, dv_sum = [], [], 0.0, 0.0
                for r in range(sp):
                    rows = idx[r * sq:(r + 1) * sq]
                    q_r, do_r, o_in, lse_in = (a[:, :, rows].contiguous()
                                               for a in (qs, do, o1, lse1))
                    args = (kind, n_frames, hw, r)
                    o_r, lse_r = fa.flash_attention_sp_fwd(q_r, kg, vg, *args)
                    o_p, lse_p = fa.flash_attention_sp_fwd_plain(q_r, kg, vg, *args)
                    grads = fa.flash_attention_sp_bwd(q_r, kg, vg, o_in, lse_in, do_r, *args)
                    grads_p = fa.flash_attention_sp_bwd_plain(q_r, kg, vg, o_in, lse_in, do_r,
                                                              *args)
                    torch.cuda.synchronize()
                    outs.append(o_r)
                    dqs.append(grads[0])
                    dk_sum, dv_sum = dk_sum + grads[1].float(), dv_sum + grads[2].float()
                    ok, errs, worst = True, {}, 0.0
                    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                                               (o_r, lse_r) + grads, (o_p, lse_p) + grads_p):
                        diff = got.float() - want.float()
                        max_abs = float(diff.abs().max())
                        worst = max(worst, max_abs)
                        if dtype == torch.float32 or name == "lse":
                            err, tol = max_abs, flash_tol(want.float(), s)
                        else:
                            err, tol = float(diff.std() / want.float().std()), TOL_BF16
                        errs[name] = (err, tol)
                        ok = ok and err <= tol and bool(torch.isfinite(got).all())
                    mask = fa._token_mask(kind, n_frames, hw, sq, dev, sp, r)
                    leaves = [a.detach().requires_grad_(True) for a in (q_r, kg, vg)]

                    def sdpa():
                        return F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=1.0)

                    def sdpa_fb():
                        sdpa().backward(do_r)

                    ms_f = device_ms(lambda: fa.flash_attention_sp_fwd(q_r, kg, vg, *args))
                    ms_b = device_ms(lambda: fa.flash_attention_sp_bwd(q_r, kg, vg, o_in, lse_in,
                                                                       do_r, *args))
                    plain_f = time_ms(lambda: fa.flash_attention_sp_fwd_plain(q_r, kg, vg, *args),
                                      10, 1)
                    plain_b = time_ms(lambda: fa.flash_attention_sp_bwd_plain(
                        q_r, kg, vg, o_in, lse_in, do_r, *args), 10, 1)
                    with torch.no_grad():
                        lib_f = device_ms(sdpa)
                    lib_fb = device_ms(sdpa_fb)
                    (ff, fb), (bf, bb) = sp_cost(fa, kind, b, heads, n_frames, hw, d, sp, r, dtype)
                    bound_f, by_f = bound(ff, fb, dtype)
                    bound_b, by_b = bound(bf, bb, dtype)
                    res = dict(ok=bool(ok), max_abs_err=worst, errs=errs, fwd_ms=ms_f,
                               bwd_ms=ms_b, plain_fwd_ms=plain_f, plain_bwd_ms=plain_b,
                               library_fwd_ms=lib_f, library_bwd_ms=max(lib_fb - lib_f, 0.0),
                               bound_fwd_ms=bound_f, bound_bwd_ms=bound_b, bound_fwd_by=by_f,
                               bound_bwd_by=by_b, fwd_gflop=ff / 1e9, bwd_gflop=bf / 1e9,
                               fwd_mb=fb / 1e6, bwd_mb=bb / 1e6)
                    results[(kind, dname, sp, r)] = res
                    detail = " ".join(f"{n}={e:.2e}/{tl:.1e}" for n, (e, tl) in errs.items())
                    log(f"# sp-kernel {dname:8s} {kind:6s} sp={sp} rank={r} q=({b},{heads},{sq},"
                        f"{d}) kv S={s} ok={ok} {detail} | ms fwd={ms_f:.4f} bwd={ms_b:.4f} "
                        f"plain={plain_f:.4f}+{plain_b:.4f} sdpa={lib_f:.4f}+"
                        f"{res['library_bwd_ms']:.4f} bound={bound_f:.5f}+{bound_b:.5f} "
                        f"({by_f}, {by_b}; {ff / 1e9:.3f}+{bf / 1e9:.3f} GFLOP, "
                        f"{fb / 1e6:.1f}+{bb / 1e6:.1f} MB)")
                ok, errs = True, {}
                for name, got, want in (("o", torch.cat(outs, dim=2), o_one[:, :, idx]),
                                        ("dq", torch.cat(dqs, dim=2), g1[0][:, :, idx]),
                                        ("dk", dk_sum, g1[1][:, :, idx]),
                                        ("dv", dv_sum, g1[2][:, :, idx])):
                    diff = got.float() - want.float()
                    if dtype == torch.float32:
                        err, tol = float(diff.abs().max()), flash_tol(want.float(), s)
                    else:
                        err, tol = float(diff.std() / want.float().std()), TOL_BF16
                    errs[name] = (err, tol)
                    ok = ok and err <= tol
                results[(kind, dname, sp, "stack")] = dict(ok=bool(ok), errs=errs)
                detail = " ".join(f"{n}={e:.2e}/{tl:.1e}" for n, (e, tl) in errs.items())
                log(f"# sp-kernel {dname:8s} {kind:6s} sp={sp} stacked o, dq and summed dk, dv "
                    f"against the one-rank {'kernel' if kind == 'dart' else 'prefill kernel/plain'}"
                    f": ok={ok} {detail}")
    return results


def sp_rank_run(small_images, small_cond):
    """One rank of the two-rank sequence-parallel run (spawned by
    run_local_ranks, sharing cuda:0 under gloo): a small fp32 model's DART
    and just_2d steps, then the full-width gym model's three DART steps and
    one just_2d step with every launch counter zeroed before and read after
    each step. Returns numbers and CPU tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from autoregressive_diffusion_tpu_torch.models.attention import (FrameAttention,
                                                                     VideoAttention)
    from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
    from autoregressive_diffusion_tpu_torch.ops import fused_conv as fc
    from autoregressive_diffusion_tpu_torch.parallel import (check_replica_consistency,
                                                             create_mesh, seq_slice)
    from autoregressive_diffusion_tpu_torch.train import build_trainer, run_steps, synthetic_batch

    mesh = create_mesh(1, 2, "gloo", "cuda")
    dev = mesh.device
    out = dict(rank=mesh.rank, device=str(dev))

    def replicas(state):
        named = dict(state.model.named_parameters())
        named.update({f"ema{i}.{n}": v for i, e in enumerate(state.ema) for n, v in e.items()})
        return check_replica_consistency(named, mesh)

    state, step = build_trainer(dev, torch.float32, seed=3, batch=small_images.shape[0],
                                mesh=mesh, **SP_SMALL)
    images, cond = seq_slice(small_images.to(dev), mesh), seq_slice(small_cond.to(dev), mesh)
    losses = []
    for i, just_2d in enumerate((False, True)):
        state, m = step(state, images, cond, 3000 + i, just_2d=just_2d)
        losses.append(float(m["loss"]))
    out["small"] = dict(losses=losses, mismatches=replicas(state),
                        params={n: p.detach().cpu() for n, p in state.model.named_parameters()})
    del state, step
    torch.cuda.empty_cache()

    b, t = 8, 8
    state, step = build_trainer(dev, torch.bfloat16, seed=0, batch=b, mesh=mesh)
    model = state.model
    n_video = sum(isinstance(x, VideoAttention) for x in model.modules())
    n_frame = sum(isinstance(x, FrameAttention) for x in model.modules())
    images, cond = synthetic_batch(model.cfg, b, t, 1, dev)
    images, cond = seq_slice(images, mesh), seq_slice(cond, mesh)
    names = SP_COUNTERS + FLASH_COUNTERS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, counts = [], []
    for i in range(4):  # DART, DART, DART, just_2d
        for n in names:
            setattr(fa, n, 0)
        fc.conv_fwd_launches = fc.conv_bwd_launches = 0
        rows += run_steps(state, step, images, cond, 1, seed=0, just_2d_every=4, mesh=mesh)
        c = {n.replace("_launches", ""): getattr(fa, n) for n in names}
        c.update(conv_fwd=fc.conv_fwd_launches, conv_bwd=fc.conv_bwd_launches)
        counts.append(c)
        rows[-1]["grads_finite"] = all(bool(torch.isfinite(p.grad).all())
                                       for p in model.parameters())
    out["gym"] = dict(rows=rows, counts=counts, n_video=n_video, n_frame=n_frame,
                      peak_mem_mb=torch.cuda.max_memory_allocated() / 2 ** 20,
                      mismatches=replicas(state), local_batch=tuple(images.shape))
    torch.distributed.destroy_process_group()
    return out


def sp_path_phase(build_trainer, n_convs):
    """The main path of row 8: two seq ranks on cuda:0 under gloo
    (sp_rank_run), held against the one-process step of the small model on
    the card, and the gym steps' launch counts."""
    from autoregressive_diffusion_tpu_torch.parallel import run_local_ranks
    failures = []
    g = torch.Generator().manual_seed(6)
    b, t = 2, 4
    images = torch.randn((b, t, 16, 16, 4), generator=g)
    cond = torch.randint(0, 4, (b, t), generator=g)
    state, step = build_trainer(DEV, torch.float32, seed=3, batch=b, **SP_SMALL)
    want = []
    for i, just_2d in enumerate((False, True)):
        state, m = step(state, images.to(DEV), cond.to(DEV), 3000 + i, just_2d=just_2d)
        want.append(float(m["loss"]))
    want_params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    del state, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_local_ranks(sp_rank_run, 2, (images, cond), timeout=600)
    wall = time.perf_counter() - t0
    for res in ranks:
        r, small, gym = res["rank"], res["small"], res["gym"]
        dparam = max(float((small["params"][n] - w).abs().max()) for n, w in want_params.items())
        rel = max(abs(a - w) / abs(w) for a, w in zip(small["losses"], want))
        ok = rel <= 2e-4 and dparam < 2e-4 and not small["mismatches"]
        log(f"# sp small fp32 model, rank {r} of 2 on {res['device']} (gloo) vs one process on "
            f"the card: losses {small['losses']} vs {want} (max rel {rel:.2e}, tol 2e-4), "
            f"max |dparam| {dparam:.2e} (tol 2e-4), replica mismatches "
            f"{len(small['mismatches'])} ok={ok}")
        if not ok:
            failures.append(f"sp small-model step, rank {r}")
        n_video, n_frame = gym["n_video"], gym["n_frame"]
        for i, (row, c) in enumerate(zip(gym["rows"], gym["counts"])):
            j2 = row["just_2d"]
            want_c = dict(dart_sp_fwd=0 if j2 else n_video, dart_sp_bwd=0 if j2 else n_video,
                          causal_sp_fwd=0, causal_sp_bwd=0, dart_fwd=0, dart_bwd=0,
                          full_fwd=n_video + n_frame if j2 else n_frame,
                          full_bwd=n_video + n_frame if j2 else n_frame,
                          conv_fwd=n_convs, conv_bwd=n_convs)
            finite = row["loss"] == row["loss"] and abs(row["loss"]) < float("inf")
            ok = c == want_c and finite and row["grads_finite"]
            log(f"# sp gym rank {r} step {i} {'just_2d' if j2 else 'dart':7s} "
                f"loss={row['loss']:.4f} grad_norm={row['grad_norm']:.4f} "
                f"step_ms={row['seconds'] * 1e3:.1f} samples_per_sec={row['samples_per_sec']:.3f} "
                f"launches {c} ok={ok}")
            if not ok:
                failures.append(f"sp gym rank {r} step {i}: launches {c} (want {want_c}) or "
                                f"not finite")
        dart = [x for x in gym["rows"][1:] if not x["just_2d"]]
        step_ms = 1e3 * sum(x["seconds"] for x in dart) / len(dart)
        log(f"# sp gym rank {r}: local batch {gym['local_batch']}, DART step {step_ms:.1f} ms "
            f"({8e3 / step_ms:.3f} samples/s of the global batch 8, steps 1-2), just_2d step "
            f"{gym['rows'][3]['seconds'] * 1e3:.1f} ms, peak_mem_mb={gym['peak_mem_mb']:.1f}, "
            f"replica mismatches {len(gym['mismatches'])}")
        if gym["mismatches"]:
            failures.append(f"sp gym rank {r}: ranks disagree: {gym['mismatches'][:3]}")
    if [x["loss"] for x in ranks[0]["gym"]["rows"]] != [x["loss"] for x in ranks[1]["gym"]["rows"]]:
        failures.append("sp gym: the ranks report different global losses")
    log(f"# sp path: two ranks, {wall:.1f} s wall from spawn to the last result")
    return failures, ranks


# ---------------------------------------------------------------------------
# phase 10: the gym training path (gym_train.py), end to end

GYM_T = 8           # latent frames a clip: 32 frames at time compression 4
GYM_FRAME = 256     # the gym path's frame size
TOL_RESUME = 1e-6   # max |diff| / max |leaf| where a resumed run is not bit for bit


def htod_bytes(fn):
    """(result of fn(), host-to-card bytes, copies, kernels) of one call of
    fn, from a torch.profiler trace of the card's activity."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    copies = [e for e in events if "HtoD" in str(e.get("name", ""))]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    return out, sum(int(e.get("args", {}).get("bytes", 0)) for e in copies), len(copies), kernels


def np_bf16_bits(x):
    """bfloat16 bits of fp32 values, rounded to nearest even in numpy (no
    NaNs): an implementation independent of torch's cast."""
    import numpy as np
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16).reshape(np.shape(x))


def tree_diff(a, b, prefix=""):
    """(leaves, leaves not bit for bit equal, worst max|diff|/max|leaf|) of
    two trees of numpy arrays with the same keys."""
    import numpy as np
    n, unequal, worst = 0, [], 0.0
    for k in a:
        if isinstance(a[k], dict):
            m, u, w = tree_diff(a[k], b[k], f"{prefix}{k}/")
            n, unequal, worst = n + m, unequal + u, max(worst, w)
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        n += 1
        if x.shape != y.shape or not np.array_equal(x, y):
            unequal.append(prefix + k)
            if x.shape == y.shape and x.size:
                d = np.abs(x.astype(np.float64) - y.astype(np.float64)).max()
                worst = max(worst, float(d / max(np.abs(y).max(), 1e-30)))
            else:
                worst = float("inf")
    return n, unequal, worst


def gym_phase(fa, fc, n_blocks, frame_size=GYM_FRAME, extra_args=()):
    """The gym training path through gym_train.py's functions, at full
    width, in a directory under build/ that is removed afterwards:
    (a) 16 synthetic clips of 32 frames (frame_size px) encoded by the
    trained VAE on the card, one clip held against the CPU; (b) eight steps
    at batch 16 in microbatches of 8 through the training loop on streamed
    clips (data and encode inside the loop), the dashboard at step 4
    (coefs refitted, sampler callback, rollout decoded to a PNG),
    checkpoints at steps 4 and 8, every step's launches held to twice a
    batch-8 step's; (c) four steps on the encoded batch, refit, save,
    restore into a freshly built trainer, four more, against eight straight
    steps: params, EMA, moments, counts and coefs; (d) --replay 32
    --replay-device for four steps: one just_2d dispatch, then one of three
    steps, the rings on the card and only the index matrix crossing;
    (e) export_ema of the 0.050 EMA as a bf16 bundle, read back against the
    state's EMA rounded to bf16, and served by generate --unet.
    `frame_size` and `extra_args` (gym_train flags) shrink it for a
    rehearsal on the CPU."""
    import contextlib
    import io
    import numpy as np
    from autoregressive_diffusion_tpu_torch import export_ema, generate, gym_train
    from autoregressive_diffusion_tpu_torch.data import SyntheticVideoGenerator, batched
    from autoregressive_diffusion_tpu_torch.models.attention import (FrameAttention,
                                                                     VideoAttention)
    from autoregressive_diffusion_tpu_torch.models.vae import frames_to_latents
    from autoregressive_diffusion_tpu_torch.utils import (load_model, restore_train_state,
                                                          save_train_state, train_state_tree,
                                                          vae_from_bundle)

    failures, summary = [], {}
    work = ROOT / "build" / f"gym_phase_{int(time.time() * 1e3)}"
    ck, img = work / "ckpt", work / "images"
    base = ["--vae", str(ROOT / VAE_BUNDLE), "--device", DEV, "--synthetic",
            "--ckpt-dir", str(ck), "--out-dir", str(img), *extra_args]
    args = gym_train.parse_args(base + ["--steps", "8", "--dashboard-every", "4",
                                        "--ckpt-every", "4"])
    b, mb = args.batch, args.micro_batch

    def counts():
        return dict(conv_fwd=fc.conv_fwd_launches, conv_bwd=fc.conv_bwd_launches,
                    block=fc.launches, prefill=fa.launches,
                    **{n.removesuffix("_launches"): getattr(fa, n) for n in FLASH_COUNTERS})

    def zero_counts():
        fc.conv_fwd_launches = fc.conv_bwd_launches = fc.launches = fa.launches = 0
        zero_flash_counts(fa)

    def delta(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    try:
        zero_counts()  # the phase's launches: read at its end
        # (a) data and encode
        tr = gym_train.build_trainer(args, frame_size=frame_size)
        cfg = tr.unet_cfg
        res = cfg.img_resolution
        unet_name = f"unet_{tr.n_params // 10 ** 6}M"
        gen16 = SyntheticVideoGenerator(state_size=32, frame_size=frame_size, time_compression=4,
                                        training_examples=16, seed=0)
        frames, actions, _ = next(batched(gen16, b))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        enc_ms = []
        for _ in range(2):  # cold, then warm
            t0 = time.perf_counter()
            lat = tr.encode(frames)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
        enc_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        vae_cpu, _ = vae_from_bundle(str(ROOT / VAE_BUNDLE), "cpu")
        lat_cpu = frames_to_latents(vae_cpu, torch.from_numpy(frames[:1]), 0.0, args.vae_std)
        enc_err = float((lat[:1].cpu() - lat_cpu).std())
        want_shape = (b, GYM_T, res, res, cfg.img_channels)
        ok = (tuple(lat.shape) == want_shape and bool(torch.isfinite(lat).all())
              and enc_err <= TOL_E2E)
        log(f"# gym data: {frames.shape} {frames.dtype} ({frames.nbytes / 1e6:.1f} MB) -> latents "
            f"{tuple(lat.shape)} (want {want_shape}); encode {enc_ms[0]:.1f} ms cold, "
            f"{enc_ms[1]:.1f} ms warm ({b // mb} VAE calls of {mb} clips), peak {enc_peak:.1f} "
            f"MB; one clip card vs CPU std(diff)={enc_err:.2e} tol={TOL_E2E:.0e} ok={ok}")
        if not ok:
            failures.append("gym encode: shape, finiteness or card against CPU")
        summary.update(encode_ms=enc_ms, encode_peak_mb=enc_peak, encode_err=enc_err)

        # (b) eight steps through the training loop, dashboard, checkpoints
        model = tr.state.model
        n_video = sum(isinstance(m, VideoAttention) for m in model.modules())
        n_frame = sum(isinstance(m, FrameAttention) for m in model.modules())
        n_convs = len(conv_calls(cfg))
        micro = b // mb
        want_step = {False: dict(conv_fwd=micro * n_convs, conv_bwd=micro * n_convs,
                                 dart_fwd=micro * n_video, dart_bwd=micro * n_video,
                                 full_fwd=micro * n_frame, full_bwd=micro * n_frame),
                     True: dict(conv_fwd=micro * n_convs, conv_bwd=micro * n_convs,
                                dart_fwd=0, dart_bwd=0, full_fwd=micro * (n_video + n_frame),
                                full_bwd=micro * (n_video + n_frame))}
        rows, mark = [], {}
        dash, ckpts = {}, []
        coefs0 = tr.state.coefs.clone()
        orig_dashboard, orig_checkpoint = tr.dashboard, tr.checkpoint

        def dashboard(i, latents):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            out = orig_dashboard(i, latents)
            torch.cuda.synchronize()
            dash.update(out, step=i, seconds=time.perf_counter() - t0, launches=delta(c0),
                        coefs=tr.state.coefs.detach().cpu().clone())
            mark["t"], mark["c"] = time.perf_counter(), counts()
            return out

        def checkpoint(i, block=False):
            t0 = time.perf_counter()
            out = orig_checkpoint(i, block)
            ckpts.append(dict(step=i, state_step=tr.state.step, block=block,
                              foreground_s=time.perf_counter() - t0))
            mark["t"], mark["c"] = time.perf_counter(), counts()
            return out

        def on_step(i, m):
            loss = float(m["loss"])  # the step is done
            torch.cuda.synchronize()
            now = time.perf_counter()
            d = delta(mark["c"])
            row = dict(step=i, just_2d=i % 4 == 0, loss=loss, lr=tr.lrs[i],
                       ms=(now - mark["t"]) * 1e3, launches={k: d[k] for k in want_step[True]})
            row["samples_per_sec"] = b * 1e3 / row["ms"]
            rows.append(row)
            log(f"# gym step {i} {'just_2d' if row['just_2d'] else 'dart':7s} loss={loss:.4f} "
                f"lr={row['lr']:.6f} {row['ms']:.1f} ms {row['samples_per_sec']:.2f} samples/s "
                f"(next batch + encode + step) launches {row['launches']} "
                f"(want {want_step[row['just_2d']]})")
            if row["launches"] != want_step[row["just_2d"]]:
                failures.append(f"gym step {i}: launches {row['launches']}")
            if not np.isfinite(loss):
                failures.append(f"gym step {i}: loss not finite")
            mark["t"], mark["c"] = time.perf_counter(), counts()

        tr.dashboard, tr.checkpoint = dashboard, checkpoint
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mark["t"], mark["c"] = time.perf_counter(), counts()
        reached = gym_train.train_loop(tr, gym_train.stream(tr, gym_train.make_generator(tr)),
                                       on_step)
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        if reached != 8 or [r["step"] for r in rows] != list(range(8)):
            failures.append(f"gym loop reached step {reached}, rows {[r['step'] for r in rows]}")
        lr_ok = all(r["lr"] == gym_train.learning_rate_schedule(r["step"], args.ref_lr, 8 / 50,
                                                                 8 / 50) for r in rows)
        dart = [r for r in rows[1:] if not r["just_2d"]]
        loop_ms = sum(r["ms"] for r in dart) / len(dart)
        log(f"# gym loop: 8 steps, batch {b} in microbatches of {mb}, T={GYM_T}, {res}x{res}x"
            f"{cfg.img_channels} latents from {frame_size}-px clips: DART step {loop_ms:.1f} ms "
            f"({b * 1e3 / loop_ms:.3f} samples/s, data and encode inside, steps after the "
            f"first), peak {train_peak:.1f} MB, lr from the schedule {lr_ok}, "
            f"{len(tr.losses)} losses kept")
        if not lr_ok or len(tr.losses) != 8:
            failures.append("gym loop: learning rates or loss history")
        cb_calls = (2 * 32 - 1) * 5  # the MSE probe and four rollout frames, 32 steps each
        want_dash = dict(block=n_blocks * cb_calls, prefill=2 * n_video,
                         full_fwd=n_frame * (cb_calls + 2))
        got_dash = {k: dash.get("launches", {}).get(k) for k in want_dash}
        coefs = dash.get("coefs", coefs0.cpu())
        coefs_ok = bool(torch.isfinite(coefs).all()) and not torch.equal(coefs, coefs0.cpu())
        png = Path(dash.get("png", img / "none.png"))
        png_ok = png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        mse = dash.get("mse_steps", np.zeros(0))
        log(f"# gym dashboard at step {dash.get('step')}: {dash.get('seconds', 0):.2f} s, "
            f"launches {got_dash} (want {want_dash}: {n_blocks} Blocks x {cb_calls} calls, "
            f"{n_video} video layers x 2 prefills, {n_frame} frame layers x {cb_calls + 2} "
            f"model calls), coefs finite and refitted {coefs_ok} "
            f"({coefs.reshape(-1).numpy().round(4).tolist()}), mse_steps first/last "
            f"{float(mse[0]) if len(mse) else None}/{float(mse[-1]) if len(mse) else None} "
            f"({len(mse)} steps), png {png.name} {png.stat().st_size if png_ok else 0} B "
            f"training mode kept {model.training}")
        if got_dash != want_dash or not coefs_ok or not png_ok or len(mse) != 32 \
                or not np.isfinite(mse).all() or not model.training:
            failures.append("gym dashboard")
        sizes = {p.name: sum(f.stat().st_size for f in p.iterdir()) / 2 ** 20
                 for p in ck.iterdir() if p.is_dir()}
        log(f"# gym checkpoints: {[(c['step'], c['state_step'], c['block'], round(c['foreground_s'], 3)) for c in ckpts]} "
            f"(loop step, state step, blocking, foreground s); on disk {sizes} MB")
        if sorted(sizes) != ["step_000000005", "step_000000008"]:
            failures.append(f"gym checkpoints {sorted(sizes)}")
        summary.update(rows=rows, loop_dart_ms=loop_ms, loop_samples_per_sec=b * 1e3 / loop_ms,
                       train_peak_mb=train_peak, ckpt_mb=sizes, checkpoints=ckpts,
                       dashboard=dict(seconds=dash.get("seconds"), launches=got_dash,
                                      mse_steps=[float(x) for x in mse]))
        ema_tree = {n: t.detach().cpu().clone() for n, t in tr.state.ema[0].items()}
        ema_step = tr.state.step
        tr.dashboard, tr.checkpoint = orig_dashboard, orig_checkpoint
        del tr, model
        torch.cuda.empty_cache()

        # (c) resume: 4 steps, refit, save, restore fresh, 4 steps == 8 straight steps
        acts = torch.as_tensor(actions)
        args_c = gym_train.parse_args(base + ["--steps", "8", "--ckpt-dir", str(work / "resume")])
        step_ms = []

        def steps(t, first, last):
            for i in range(first, last):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = t.step(i, lat, acts)
                float(m["loss"])
                torch.cuda.synchronize()
                step_ms.append((i, (time.perf_counter() - t0) * 1e3))
            t.flush()

        def refit(t):
            t.state.coefs.copy_(torch.from_numpy(t.noise_state.fit()))

        straight = gym_train.build_trainer(args_c, frame_size=frame_size)
        steps(straight, 0, 4)
        refit(straight)
        steps(straight, 4, 8)
        want_tree = train_state_tree(straight.state)
        del straight
        torch.cuda.empty_cache()
        first = gym_train.build_trainer(args_c, frame_size=frame_size)
        steps(first, 0, 4)
        refit(first)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_train_state(args_c.ckpt_dir, first.state.step, first.state,
                                {"losses": first.losses}, block=True)
        save_s = time.perf_counter() - t0
        ckpt_mb = sum(f.stat().st_size for f in path.iterdir()) / 2 ** 20
        del first
        torch.cuda.empty_cache()
        second = gym_train.build_trainer(args_c, frame_size=frame_size)
        t0 = time.perf_counter()
        _, extra = restore_train_state(args_c.ckpt_dir, 4, second.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        second.losses, second.start = extra["losses"].tolist(), second.state.step
        steps(second, 4, 8)
        n_leaves, unequal, worst = tree_diff(train_state_tree(second.state), want_tree)
        ok = not unequal or worst <= TOL_RESUME
        outside = [ms for i, ms in step_ms[1:8] if i % 4]
        log(f"# gym resume: save {save_s:.2f} s ({ckpt_mb:.1f} MB), restore into a fresh "
            f"trainer {restore_s:.2f} s; 4 + 4 steps vs 8 straight: {n_leaves} leaves (params, "
            f"buffers, 2 EMA, mu, nu, count, coefs, step), {len(unequal)} not bit for bit "
            f"{unequal[:6]}, worst max|diff|/max|leaf| {worst:.2e} (tol {TOL_RESUME:.0e} if not "
            f"bit for bit) ok={ok}; DART step on the encoded batch (data and encode outside) "
            f"{sum(outside) / len(outside):.1f} ms ({b * 1e3 * len(outside) / sum(outside):.3f} "
            f"samples/s)")
        if not ok or len(second.losses) != 8:
            failures.append("gym resume against the straight run")
        summary.update(save_s=save_s, restore_s=restore_s, state_mb=ckpt_mb,
                       resume_unequal=unequal, resume_worst=worst,
                       step_ms_outside=sum(outside) / len(outside))
        del second, want_tree
        torch.cuda.empty_cache()

        # (d) the replay rings on the card
        args_d = gym_train.parse_args(base + ["--steps", "4", "--replay", "32",
                                              "--replay-device", "--ckpt-every", "4",
                                              "--ckpt-dir", str(work / "replay")])
        trd = gym_train.build_trainer(args_d, frame_size=frame_size)
        gen32 = SyntheticVideoGenerator(state_size=32, frame_size=frame_size, time_compression=4,
                                        training_examples=32, seed=1)
        replay = gym_train.device_replay(trd, gen32)
        dispatches, copies = [], {}
        orig_fn = trd.replay_fn

        def replay_fn(state, bz, ba, idx, seed, just_2d=False):
            if idx.shape[0] < 3:
                return orig_fn(state, bz, ba, idx, seed, just_2d)
            out, nbytes, n, kernels = htod_bytes(lambda: orig_fn(state, bz, ba, idx, seed,
                                                                 just_2d))
            copies.update(bytes=nbytes, copies=n, kernels=kernels, idx_bytes=idx.nbytes)
            return out

        def on_dispatch(i, g, m):
            dispatches.append((i, g, bool(i % 4 == 0), float(m["loss"])))

        trd.replay_fn = replay_fn
        t0 = time.perf_counter()
        reached = gym_train.replay_loop(trd, replay, on_dispatch)
        replay_s = time.perf_counter() - t0
        rings = [str(t.device) for t in replay.buffers()]
        batch_bytes = b * GYM_T * res * res * cfg.img_channels * 4
        ok = (reached == 4 and [(i, g, j) for i, g, j, _ in dispatches]
              == [(0, 1, True), (1, 3, False)] and all(r.startswith("cuda") for r in rings)
              and copies.get("kernels", 0) > 0 and copies.get("copies", 0) >= 1
              and copies["bytes"] < batch_bytes / 100)
        log(f"# gym replay --replay 32 --replay-device: dispatches (step, steps, just_2d, loss) "
            f"{dispatches}, rings on {rings}, {replay.stats()}, {replay_s:.2f} s with the fill; "
            f"the 3-step dispatch copied {copies.get('bytes')} B host to card in "
            f"{copies.get('copies')} copies (index matrix {copies.get('idx_bytes')} B; one "
            f"batch of latents {batch_bytes} B; held < 1% of it) beside {copies.get('kernels')} "
            f"kernels ok={ok}")
        if not ok:
            failures.append("gym replay on the card")
        summary.update(replay=dict(dispatches=dispatches, copies=copies, seconds=replay_s))
        del trd, replay
        torch.cuda.empty_cache()

        # (e) export the 0.050 EMA as bf16, read it back, serve it
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            bundle = export_ema.main(["--ckpt-dir", str(ck), "--cfg", str(ck / f"{unet_name}.ad"),
                                      "--ema", "0", "--dtype", "bfloat16", "--device", DEV])
        export_s = time.perf_counter() - t0
        log(text.getvalue().strip())
        _, variables = load_model(bundle)
        flat = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}.")
                else:
                    flat[prefix + k] = v

        walk(variables["params"])
        bad = [n for n, t in ema_tree.items()
               if not np.array_equal(getattr(flat.get(n), "bits", None), np_bf16_bits(t.numpy()))]
        want_name = f"{unet_name}_ema0.050_step{ema_step}_bfloat16.ad"
        png = work / "served.png"
        with contextlib.redirect_stdout(io.StringIO()) as text:
            generate.main(["--unet", str(bundle), "--vae", str(ROOT / VAE_BUNDLE),
                           "--context-frames", "2", "--gen-frames", "1", "--bench-iters", "5",
                           "--out", str(png), "--device", DEV])
        served = json.loads(text.getvalue().strip().splitlines()[-1])
        ok = (bundle.name == want_name and not bad and set(flat) == set(ema_tree)
              and served["frames_finite"] and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
              and served["decoded_shape"] == [1, 4, frame_size, frame_size, 3])
        log(f"# gym export: {bundle.name} (want {want_name}) in {export_s:.2f} s, "
            f"{bundle.stat().st_size / 2 ** 20:.1f} MB, {len(flat)} leaves, {len(bad)} not "
            f"equal to the EMA rounded to bf16 (numpy round to nearest even); generate --unet: "
            f"latents {served['frames_shape']} finite={served['frames_finite']}, decoded "
            f"{served['decoded_shape']} uint8 PNG {png.stat().st_size} B, "
            f"decode_ms_per_call={served['decode_ms_per_call']:.2f} ok={ok}")
        if not ok:
            failures.append("gym export and serve")
        summary.update(export_s=export_s, served=served)
        summary["launches"] = counts()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"# gym phase launches: {summary.get('launches')}")
    return failures, summary


def cs_kernel_summary(cs_cfg, calls, conv_results, flash_results, shapes, block_results,
                      b=2, t=16, micro=4):
    """The kernels at the CS model's shapes, bf16: sums over the causal
    convs and the attention layers of one DART microbatch (batch b, T=t)
    and of a step of `micro` microbatches, and over the attention-free
    Blocks of one denoiser call, each beside its bound and its library
    call; logged, and returned for the detail file."""
    conv = [conv_results[("cs", b, 2 * t, h, h, c, co, silu, cv, True, "bfloat16")]
            for _, (h, c, co, silu, cv) in calls]
    keys = ("fwd_ms", "bwd_ms", "unfused_fwd_ms", "unfused_bwd_ms", "plain_fwd_ms",
            "plain_bwd_ms", "bound_fwd_ms", "bound_bwd_ms")
    conv_sum = {k: sum(r[k] for r in conv) for k in keys}
    flash = {}
    for kind in ("dart", "full"):
        rs = [flash_results[("cs", c, "bfloat16")] for c in attention_calls(cs_cfg, b, t, False)
              if c[0] == kind]
        flash[kind] = {k: sum(r[k] for r in rs) for k in
                       ("fwd_ms", "bwd_ms", "library_fwd_ms", "library_bwd_ms",
                        "bound_fwd_ms", "bound_bwd_ms")}
        flash[kind]["calls"] = len(rs)
    per_call = [block_results[(sh, "bfloat16", True)] for _, sh in shapes]
    block = {k: sum(r[k] for r in per_call) for k in ("ms", "plain_ms", "bound_ms")}
    widest = max(shapes, key=lambda ns: ns[1][2])
    wide = {dt: block_results[(widest[1], dt, True)] for dt in ("float32", "bfloat16")}
    log(f"# cs-kernels conv: {len(calls)} causal convs of a DART microbatch (batch {b}, "
        f"T={t}, bf16): device ms fwd={conv_sum['fwd_ms']:.3f} bwd={conv_sum['bwd_ms']:.3f} "
        f"(a step of {micro} microbatches: {micro * conv_sum['fwd_ms']:.3f} + "
        f"{micro * conv_sum['bwd_ms']:.3f}), unfused cuDNN {conv_sum['unfused_fwd_ms']:.3f} + "
        f"{conv_sum['unfused_bwd_ms']:.3f}, bound {conv_sum['bound_fwd_ms']:.4f} + "
        f"{conv_sum['bound_bwd_ms']:.4f}, wall plain {conv_sum['plain_fwd_ms']:.2f} + "
        f"{conv_sum['plain_bwd_ms']:.2f}")
    for kind, f in flash.items():
        log(f"# cs-kernels {kind} attention: {f['calls']} layers of a DART microbatch: device "
            f"ms fwd={f['fwd_ms']:.4f} bwd={f['bwd_ms']:.4f} (a step: {micro * f['fwd_ms']:.4f}"
            f" + {micro * f['bwd_ms']:.4f}), SDPA {f['library_fwd_ms']:.4f} + "
            f"{f['library_bwd_ms']:.4f}, bound {f['bound_fwd_ms']:.5f} + "
            f"{f['bound_bwd_ms']:.5f}")
    log(f"# cs-kernels decode Block: {len(shapes)} Blocks a denoiser call, bf16: device "
        f"{block['ms']:.4f} ms, bound {block['bound_ms']:.5f} ms, wall plain "
        f"{block['plain_ms']:.3f} ms; the widest, {widest[0]} {widest[1]}: bf16 "
        f"{wide['bfloat16']['ms']:.4f} ms (bound {wide['bfloat16']['bound_ms']:.5f}, "
        f"{wide['bfloat16']['bound_by']}), fp32 {wide['float32']['ms']:.4f} ms, ok "
        f"{wide['bfloat16']['ok'] and wide['float32']['ok']}")
    return dict(conv=conv_sum, flash=flash, block=block, widest=[widest[0], list(widest[1])],
                widest_rows=wide)


# ---------------------------------------------------------------------------
# phase 11: the CS path (build_cs_dataset, cs_train, cs_rollout,
# context_probe), end to end at full width

CS_FRAME = 128        # px: the trained VAE's 4x compression gives 32x32x8 latents
CS_CLIP_FRAMES = 128  # frames a synthetic clip: 32 latent frames at time compression 4
CS_STEPS = 6


def cs_model_config(model_channels=128, max_frames=64):
    """The CS UNet's fields, as generate.build_model overrides."""
    return dict(img_resolution=32, img_channels=8, label_dim=4, model_channels=model_channels,
                channel_mult=(1, 2, 4, 4), num_blocks=2, video_attn_resolutions=(4,),
                frame_attn_resolutions=(8,), max_frames=max_frames)


class HostPeak:
    """The largest resident set of this process while the block runs,
    sampled from /proc every 20 ms (MB)."""

    def __enter__(self):
        import threading
        self.mb, self._stop = self._rss(), threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss():
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
        return 0.0

    def _run(self):
        while not self._stop.wait(0.02):
            self.mb = max(self.mb, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.mb = max(self.mb, self._rss())


def cs_phase(fa, fc, model_channels=128, n_clips=8, clip_frames=CS_CLIP_FRAMES,
             frame_size=CS_FRAME):
    """The CS path through its entry points' functions, at full width, in a
    directory under build/ that is removed afterwards: (a) build_cs_dataset
    --synthetic encodes n_clips structured clips through the trained VAE
    into .npz shards of (32, 32, 32, 8) fp16 latents, one clip held card
    against CPU, and the same latents go into an uncompressed MDS copy;
    (b) cs_train --mds for CS_STEPS steps (batch 8 in microbatches of 2,
    T=16, just_2d at steps 0 and 4), each step's launches held to 4
    microbatches' worth, loss finite, weights unit-norm, EMA moved, a
    profiled DART step, the final save; (c) the CS model in fp32 on the
    card against the CPU (prefill 4, one cached decode step, just_2d),
    with the decode Block launched for every attention-free Block; (d), (e)
    cs_eval_suite on (b)'s checkpoint: context_probe (finite losses, real
    and scrambled) and cs_rollout (4 context frames, 2 generated, 2 clips,
    32 steps; 17 Blocks a denoiser call, 6 prefill launches a prefill,
    finite MSE, a uint8 PNG), then the cached denoiser call timed and
    profiled. `model_channels`, `n_clips`, `clip_frames` and `frame_size`
    shrink it for a rehearsal on the CPU."""
    import contextlib
    import io
    import numpy as np
    from autoregressive_diffusion_tpu_torch import (build_cs_dataset, cs_eval_suite,
                                                    cs_rollout, cs_train)
    from autoregressive_diffusion_tpu_torch.data import MDSShardWriter, resize_frames_batch
    from autoregressive_diffusion_tpu_torch.generate import build_model, profile_decode
    from autoregressive_diffusion_tpu_torch.models import init_cache
    from autoregressive_diffusion_tpu_torch.models.attention import (FrameAttention,
                                                                     VideoAttention)
    from autoregressive_diffusion_tpu_torch.models.vae import encode_long_sequence
    from autoregressive_diffusion_tpu_torch.train.cli import profile_steps
    from autoregressive_diffusion_tpu_torch.utils import vae_from_bundle

    failures, summary = [], {}
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"cs_phase_{int(time.time() * 1e3)}"
    npz_dir, mds_dir, ck, out_dir = work / "npz", work / "mds", work / "ckpt", work / "rollout"
    vae_path = str(ROOT / VAE_BUNDLE)

    def counts():
        return dict(conv_fwd=fc.conv_fwd_launches, conv_bwd=fc.conv_bwd_launches,
                    block=fc.launches, prefill=fa.launches,
                    **{n.removesuffix("_launches"): getattr(fa, n) for n in FLASH_COUNTERS})

    def zero_counts():
        fc.conv_fwd_launches = fc.conv_bwd_launches = fc.launches = fa.launches = 0
        zero_flash_counts(fa)

    def delta(c0):
        return {k: v - c0[k] for k, v in counts().items()}

    total = {k: 0 for k in counts()}

    def add(d):
        for k, v in d.items():
            total[k] += v

    try:
        # (a) the dataset
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            build_cs_dataset.main(
                ["--synthetic", str(n_clips), "--clip-frames", str(clip_frames), "--frame-size",
                 str(frame_size), "--vae-ckpt", vae_path, "--out", str(npz_dir), "--device", DEV])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t_lat, res = clip_frames // 4, frame_size // 4
        shards = sorted(npz_dir.glob("*.npz"))
        shapes = set()
        with MDSShardWriter(str(mds_dir), {"mean": "ndarray", "action": "ndarray"},
                            compression=None) as w:
            for path in shards:
                with np.load(path) as z:
                    shapes.add((z["latents"].shape, str(z["latents"].dtype),
                                z["actions"].shape))
                    w.write({"mean": z["latents"], "action": z["actions"].astype(np.int64)})
        want_shapes = {((t_lat, res, res, 8), "float16", (t_lat,))}
        frames, _ = build_cs_dataset.structured_clip(np.random.default_rng(0), clip_frames)
        x = torch.from_numpy(resize_frames_batch(frames, frame_size))[None]
        lat = {}
        for d in (DEV, "cpu"):
            vae, _ = vae_from_bundle(vae_path, d)
            lat[d] = encode_long_sequence(vae, x.to(d), split_size=512).float().cpu()
        enc_err = float((lat[DEV] - lat["cpu"]).std())
        ok = shapes == want_shapes and len(shards) == n_clips and enc_err <= TOL_E2E
        log(f"# cs data: build_cs_dataset --synthetic {n_clips} --clip-frames {clip_frames} "
            f"--frame-size {frame_size} in {build_s:.2f} s -> {len(shards)} .npz shards "
            f"{sorted(shapes)} (want {sorted(want_shapes)}), MDS copy (uncompressed) "
            f"{sum(p.stat().st_size for p in mds_dir.iterdir()) / 2 ** 20:.1f} MB; clip 0 "
            f"encoded card vs CPU std(diff)={enc_err:.2e} tol={TOL_E2E:.0e} "
            f"(latent std {float(lat['cpu'].std()):.3f}) ok={ok}")
        if not ok:
            failures.append("cs dataset: shapes or card against CPU")
        summary.update(build_s=build_s, encode_err=enc_err, shards=len(shards))
        del vae, lat
        torch.cuda.empty_cache()

        # (b) cs_train --mds at full width
        args = cs_train.parse_args(["--mds", str(mds_dir), "--steps", str(CS_STEPS),
                                    "--ckpt-dir", str(ck), "--device", DEV, "--use-actions",
                                    "--model-channels", str(model_channels)])
        tr = cs_train.build_trainer(args)
        model = tr.state.model
        cfg = tr.cfg
        b, micro = args.batch, args.batch // args.micro_batch
        n_video = sum(isinstance(m, VideoAttention) for m in model.modules())
        n_frame = sum(isinstance(m, FrameAttention) for m in model.modules())
        n_convs = len(conv_calls(cfg))
        want_step = {False: dict(conv_fwd=micro * n_convs, conv_bwd=micro * n_convs,
                                 dart_fwd=micro * n_video, dart_bwd=micro * n_video,
                                 full_fwd=micro * n_frame, full_bwd=micro * n_frame),
                     True: dict(conv_fwd=micro * n_convs, conv_bwd=micro * n_convs,
                                dart_fwd=0, dart_bwd=0, full_fwd=micro * (n_video + n_frame),
                                full_bwd=micro * (n_video + n_frame))}
        ema0 = {n: v.clone() for n, v in tr.state.ema[0].items()}
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        rows, mark, saves = [], {}, []
        orig_checkpoint = tr.checkpoint

        def checkpoint(block=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with HostPeak() as peak:
                out = orig_checkpoint(block)
            saves.append(dict(block=block, seconds=time.perf_counter() - t0,
                              host_peak_mb=peak.mb))
            return out

        def on_step(i, m):
            loss = float(m["loss"])  # the step is done
            torch.cuda.synchronize()
            now = time.perf_counter()
            d = delta(mark["c"])
            row = dict(step=i, just_2d=i % 4 == 0, loss=loss, ms=(now - mark["t"]) * 1e3,
                       launches={k: d[k] for k in want_step[True]})
            row["samples_per_sec"] = b * 1e3 / row["ms"]
            rows.append(row)
            log(f"# cs step {i} {'just_2d' if row['just_2d'] else 'dart':7s} loss={loss:.4f} "
                f"{row['ms']:.1f} ms {row['samples_per_sec']:.2f} samples/s (next batch + "
                f"step) launches {row['launches']} (want {want_step[row['just_2d']]})")
            if row["launches"] != want_step[row["just_2d"]]:
                failures.append(f"cs step {i}: launches {row['launches']}")
            if not np.isfinite(loss):
                failures.append(f"cs step {i}: loss not finite")
            mark["t"], mark["c"] = time.perf_counter(), counts()

        tr.checkpoint = checkpoint
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c_train = counts()
        mark["t"], mark["c"] = time.perf_counter(), counts()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            reached = cs_train.train_loop(tr, cs_train.make_loader(tr), on_step)
        log(text.getvalue().strip())
        add(delta(c_train))
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        worst_norm = 0.0
        for n, p in model.named_parameters():
            if n.rsplit(".", 1)[-1] == "w":
                norm = p.detach().float().pow(2).sum(dim=tuple(range(p.ndim - 1))).sqrt()
                worst_norm = max(worst_norm, float((norm / p[..., 0].numel() ** 0.5 - 1)
                                                   .abs().max()))
        # the EMA moves where the weights moved (leaves behind a zero gain
        # get no gradient in the first steps, and stay where they started)
        moved = {n for n in ema0 if not torch.equal(tr.state.ema[0][n], ema0[n])}
        changed = {n for n, p in model.named_parameters() if not torch.equal(p, params0[n])}
        dart = [r for r in rows[1:] if not r["just_2d"]]
        step_ms = sum(r["ms"] for r in dart) / max(len(dart), 1)
        j2d = [r["ms"] for r in rows[1:] if r["just_2d"]]
        ok = (reached == CS_STEPS and [r["step"] for r in rows] == list(range(CS_STEPS))
              and worst_norm <= 1e-3 and moved == changed and len(moved) >= len(ema0) / 2
              and len(saves) == 1
              and np.isfinite(tr.losses).all() and len(tr.losses) == CS_STEPS)
        ckpt_mb = sum(f.stat().st_size for p in ck.iterdir() if p.is_dir()
                      for f in p.iterdir()) / 2 ** 20
        log(f"# cs train: {tr.n_params / 1e6:.1f}M params, bf16 body, batch {b} in "
            f"microbatches of {args.micro_batch}, T={args.clip_size}, 32x32x8 latents from "
            f"the MDS copy: DART step {step_ms:.1f} ms ({b * 1e3 / step_ms:.3f} samples/s, "
            f"steps after the first, next batch included), just_2d {j2d} ms, peak "
            f"{train_peak:.1f} MB; |norm-1| of w <= {worst_norm:.1e}, EMA moved in "
            f"{len(moved)}/{len(ema0)} leaves, the weights in {len(changed)}; final save {saves[0]['seconds'] if saves else 0:.2f} s "
            f"({ckpt_mb:.1f} MB on disk, host peak {saves[0]['host_peak_mb'] if saves else 0:.0f}"
            f" MB resident during the save) ok={ok}")
        if not ok:
            failures.append("cs train: steps, norms, EMA or the final save")
        del ema0, params0
        # one profiled DART step on a batch of the run's data
        latents, actions = next(cs_train.make_loader(tr))
        c_prof = counts()
        prof = profile_steps(tr.state, tr.step_fn, latents, actions, steps=1, seed=1)
        add(delta(c_prof))
        log(f"# cs profiled DART step: wall {prof['wall_ms_per_step']:.1f} ms, device busy "
            f"{prof['device_busy_ms_per_step']:.1f} ms (idle "
            f"{prof['device_idle_share']:.1%}), {prof['kernel_launches_per_step']:.0f} "
            f"launches; device ms by group "
            f"{ {k: round(v, 3) for k, v in prof['device_ms_per_step_by_group'].items()} }")
        summary.update(rows=rows, dart_step_ms=step_ms, dart_samples_per_sec=b * 1e3 / step_ms,
                       just_2d_ms=j2d, train_peak_mb=train_peak, saves=saves,
                       ckpt_mb=ckpt_mb, n_params=tr.n_params, profile=prof)
        tr.checkpoint = orig_checkpoint
        del tr, model, latents, actions
        torch.cuda.empty_cache()

        # (c) the CS model in fp32, card against CPU: the repair end to end
        c_e2e = counts()
        ok_e2e, errs = e2e_phase(lambda d: build_model(d, torch.float32, seed=1,
                                                       **cs_model_config(model_channels)),
                                 init_cache, "cs full width", 4)
        d_e2e = delta(c_e2e)
        add(d_e2e)
        n_blocks = len(decode_block_shapes(cfg))
        log(f"# cs e2e: decode Block launches on the card {d_e2e['block']} (want "
            f"{2 * n_blocks}: {n_blocks} Blocks in the cached step and in the just_2d step)")
        if not ok_e2e or d_e2e["block"] != 2 * n_blocks:
            failures.append("cs end to end, card against CPU")
        summary.update(e2e=errs)
        torch.cuda.empty_cache()

        # (d), (e) the eval suite (probe, rollout) on (b)'s checkpoint
        t0 = time.perf_counter()
        with HostPeak() as peak:
            model, step = cs_rollout.restore_model(str(ck), model_channels, torch.device(DEV),
                                                   torch.bfloat16)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        eargs = cs_eval_suite.parse_args(["--ckpt-dir", str(ck), "--mds", str(mds_dir),
                                          "--vae", vae_path, "--frames", "2", "--out",
                                          str(out_dir), "--device", DEV,
                                          "--model-channels", str(model_channels)])
        c_eval = counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            res_ = cs_eval_suite.run(model, eargs)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        log(text.getvalue().strip())
        d_eval = delta(c_eval)
        add(d_eval)
        probe, roll = res_["probe"], res_["rollout"]
        n_win = n_clips * (t_lat // 16)
        n_loss = 2 * min(4, n_win // 8)  # real and scrambled a probe batch
        calls = roll["clips"] * eargs.frames * (2 * 32 - 1)  # denoiser calls, 32 steps
        model_calls = calls + roll["clips"]  # and a prefill a clip
        want = dict(conv_fwd=n_loss * n_convs, conv_bwd=0, block=n_blocks * calls,
                    prefill=n_video * roll["clips"], dart_fwd=n_loss * n_video, dart_bwd=0,
                    full_fwd=n_loss * n_frame + n_frame * model_calls, full_bwd=0)
        png = Path(roll["strip"] or out_dir / "none.png")
        png_ok = png.exists() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        losses = np.asarray(probe["real"] + probe["scrambled"])
        ok = (d_eval == want and np.isfinite(losses).all() and len(losses) == n_loss
              and np.isfinite(roll["mse"]).all() and png_ok)
        log(f"# cs eval: restore {restore_s:.2f} s (host peak {peak.mb:.0f} MB resident), "
            f"probe + rollout {eval_s:.2f} s; probe real {probe['real']} scrambled "
            f"{probe['scrambled']} ratio {probe['ratio']:.3f}; rollout mse {roll['mse']} "
            f"persistence {roll['persistence']} ({roll['clips']} clips, 4 context + "
            f"{eargs.frames} frames, {calls} denoiser calls, "
            f"{eval_s * 1e3 / max(calls, 1):.1f} ms a call with the probe and the sampler), "
            f"png {png.stat().st_size if png_ok else 0} B; launches {d_eval} (want {want}) "
            f"ok={ok}")
        if not ok:
            failures.append("cs eval suite: launches, losses, MSE or the PNG")
        summary.update(restore_s=restore_s, restore_host_peak_mb=peak.mb, eval_s=eval_s,
                       probe=probe, rollout_mse=[float(v) for v in roll["mse"]],
                       rollout_persistence=[float(v) for v in roll["persistence"]])
        # the cached denoiser call on the trained weights
        g = torch.Generator(device=DEV).manual_seed(3)
        x = torch.randn((1, 4, 32, 32, 8), generator=g, device=DEV)
        c_dec = counts()
        with torch.no_grad():
            cache = init_cache(model, 1, device=DEV)
            _, cache = model(x, torch.full((1, 4), 0.05, device=DEV),
                             torch.zeros((1, 4), dtype=torch.long, device=DEV), cache=cache,
                             update_cache=True)
            x1, s1 = x[:, :1], torch.ones((1, 1), device=DEV)
            c1 = torch.zeros((1, 1), dtype=torch.long, device=DEV)
            for _ in range(3):
                x1 = model(x1, s1, c1, cache=cache)[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                x1 = model(x1, s1, c1, cache=cache)[0]
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3 / 20
            dec = profile_decode(model, cache, calls=10)
        add(delta(c_dec))
        log(f"# cs cached denoiser call (bf16, trained weights, 4 frames in the cache): "
            f"{call_ms:.2f} ms a call unprofiled; profiled {dec['wall_ms_per_call']:.2f} ms, "
            f"device busy {dec['device_busy_ms_per_call']:.3f} ms (decode Block "
            f"{dec['decode_block_device_ms_per_call']:.4f}), idle "
            f"{dec['device_idle_share']:.1%}, {dec['kernel_launches_per_call']:.0f} launches")
        summary.update(decode_call_ms=call_ms, decode_profile=dec)
        summary["launches"] = dict(total)
        del model, cache
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"# cs phase: {summary['seconds']:.1f} s, launches {summary.get('launches')}")
    return failures, summary


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 12: VAE training (gym_vae_train, cs_vae_train, cs_vae_adversarial,
# calibrate_lpips), end to end

VAE_FRAME = 256       # px: both VAE scripts' default frame size
GYM_VAE_STEPS = 6     # step 0 is the warm-up
CS_VAE_STEPS, ADV_STEPS = 3, 2


def leaf_errs(got: dict, want: dict) -> dict:
    """{leaf: rms(diff) / scale}: the scale is the leaf's rms, at least 1%
    of the whole tree's, or the whole tree's for a leaf below 0.1% of it
    (the gradient of a bias ahead of a train-mode BatchNorm, 0 in exact
    arithmetic); tests/test_torch_vae_train.py holds the same measure."""
    import numpy as np

    def rms(a):
        return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))

    whole = rms(np.concatenate([np.ravel(v) for v in want.values()]))
    out = {}
    for k, w in want.items():
        r = rms(w)
        scale = whole if r < 1e-3 * whole else max(r, 1e-2 * whole)
        out[k] = rms(np.asarray(got[k], np.float64) - w) / scale
    return out


def vae_step_parity(frame_size=32, clip=8, batch=2):
    """(a) One gym_vae_train step (VAE update, noise-free decode, one
    discriminator step in train mode) on the card against the same step on
    the CPU, from the same seeded weights with t and the latent noise
    injected: in float64 every loss, gradient (before the clip), parameter
    and batch_stats leaf is held at 3e-4; in fp32 (TF32 off) the losses,
    the VAE's gradients and the batch_stats are held, and the
    discriminator's gradients are recorded beside the bound: they read the
    VAE just updated, and there fp32 scatters up to 8.7e-4 between two
    correct implementations (tests/test_torch_vae_train.py)."""
    import numpy as np
    from autoregressive_diffusion_tpu_torch import gym_vae_train
    from autoregressive_diffusion_tpu_torch.data import SyntheticVideoGenerator, batched
    from autoregressive_diffusion_tpu_torch.utils import flax_variables, to_flax_names

    frames = next(batched(SyntheticVideoGenerator(clip, frame_size, 4, 4, batch, seed=5), batch))[0]
    rng = np.random.default_rng(6)
    t = rng.uniform(size=(batch,)) * 0.1
    noise = rng.normal(size=(batch, clip // 4, frame_size // 4, frame_size // 4, 8))
    argv = ["--synthetic", "--frame-size", str(frame_size), "--state-size", str(clip),
            "--batch", str(batch), "--steps", "3"]
    failures, rows = [], {}
    for dtype in (torch.float64, torch.float32):
        res = {}
        for dev in (DEV, "cpu"):
            tr = gym_vae_train.build_trainer(gym_vae_train.parse_args(argv + ["--device", dev]))
            tr.vae.to(dtype)
            tr.disc.to(dtype)
            grads = {}
            for name, tx, mod in (("vae", tr.tx_vae, tr.vae), ("disc", tr.tx_disc, tr.disc)):
                def spy(opt, count, update=tx.update, mod=mod, name=name):
                    grads[name] = to_flax_names({n: p.grad if p.grad is not None
                                                 else torch.zeros_like(p)
                                                 for n, p in mod.named_parameters()})
                    return update(opt, count)
                tx.update = spy
            m = gym_vae_train.train_step(tr, frames, torch.tensor(t, dtype=dtype),
                                         torch.tensor(noise, dtype=dtype))
            tv, td = flax_variables(tr.vae), flax_variables(tr.disc, "batch_stats")
            res[dev] = dict(metrics=m.cpu().double().numpy(), grads=grads,
                            params={**{"vae/" + k: v for k, v in flat_tree(tv["params"]).items()},
                                    **{"disc/" + k: v for k, v in flat_tree(td["params"]).items()}},
                            stats=flat_tree(td["batch_stats"]))
        c, g = res[DEV], res["cpu"]
        errs = dict(metrics=float(np.max(np.abs(c["metrics"] / g["metrics"] - 1))),
                    vae_grads=max(leaf_errs(c["grads"]["vae"], g["grads"]["vae"]).values()),
                    disc_grads=max(leaf_errs(c["grads"]["disc"], g["grads"]["disc"]).values()),
                    batch_stats=max(leaf_errs(c["stats"], g["stats"]).values()),
                    params=max(float(np.std(c["params"][k] - g["params"][k]))
                               for k in g["params"]))
        held = (("metrics", "vae_grads", "disc_grads", "batch_stats", "params")
                if dtype == torch.float64 else ("metrics", "vae_grads", "batch_stats"))
        ok = all(errs[k] <= TOL_GRAD for k in held)
        name = str(dtype).removeprefix("torch.")
        log(f"# vae-train step card vs CPU {name}: {batch} clips of {clip} frames at "
            f"{frame_size} px; losses (recon, kl, adv, disc) rel {errs['metrics']:.2e}, VAE grads "
            f"{errs['vae_grads']:.2e}, discriminator grads {errs['disc_grads']:.2e}, batch_stats "
            f"{errs['batch_stats']:.2e}, params after std(diff) {errs['params']:.2e}; held at "
            f"{TOL_GRAD:.0e}: {', '.join(held)} ok={ok}")
        if not ok:
            failures.append(f"vae-train step card vs CPU ({name})")
        rows[name] = errs
    return failures, rows


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def timed_loop(loop, tr, loader, n_steps):
    """Run a script's train_loop, each step synchronised: (its
    {step: ms}, peak device MB)."""
    marks = []

    def on_step(i, _):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    path = loop(tr, loader, on_step=on_step)
    torch.cuda.synchronize()
    ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    if len(ms) != n_steps:
        raise RuntimeError(f"{len(ms)} steps ran, {n_steps} asked")
    return path, ms, torch.cuda.max_memory_allocated() / 2 ** 20


def step_summary(ms):
    warm = ms[1:] or ms
    return dict(step_ms=ms, warm_mean_ms=sum(warm) / len(warm))


def vae_train_phase(fa, fc, frame_size=VAE_FRAME, gym_clip=32, gym_batch=4,
                    cs_cuts=((32, 2), (32, 1), (16, 2), (16, 1)), cs_small=False):
    """Phase 12, in a directory under build/ that is removed afterwards:
    (a) vae_step_parity; (b) gym_vae_train --synthetic at frame_size px,
    gym_clip frames, batch gym_batch for 6 steps (step 0 the warm-up): step
    ms, clips/s, peak MB, one profiled step's launches and busy share, and
    whether --remat was needed (run without; on running out of device
    memory, again with it); its bundle read by vae_from_bundle, a latent
    clip decoded, and generate --vae serving it for one rollout of the
    seeded gym denoiser; (c) cs_vae_train --synthetic at the full VAE for 3
    steps at the first (clip, batch) of cs_cuts that fits, then
    cs_vae_adversarial --vae <its bundle> for 2 steps, and alexnet_lpips_loss
    timed on the params that calibrate_lpips --out writes. Every kernel
    launch counter is zeroed before and read after; this path's training
    launches none, the served rollout launches the serving kernels.
    Returns (failures, summary, launches)."""
    import contextlib
    import io
    import numpy as np
    from autoregressive_diffusion_tpu_torch import (calibrate_lpips, cs_vae_adversarial,
                                                    cs_vae_train, generate, gym_vae_train)
    from autoregressive_diffusion_tpu_torch.train import perceptual
    from autoregressive_diffusion_tpu_torch.utils import vae_from_bundle
    from autoregressive_diffusion_tpu_torch.utils.profiling import window_summary

    def counts():
        return dict(conv_fwd=fc.conv_fwd_launches, conv_bwd=fc.conv_bwd_launches,
                    block=fc.launches, prefill=fa.launches,
                    **{n.removesuffix("_launches"): getattr(fa, n) for n in FLASH_COUNTERS})

    fc.conv_fwd_launches = fc.conv_bwd_launches = fc.launches = fa.launches = 0
    zero_flash_counts(fa)
    t_phase = time.perf_counter()
    work = ROOT / "build" / f"vae_train_phase_{int(time.time() * 1e3)}"
    summary = {}
    try:
        # (a) card against CPU
        failures, summary["parity"] = vae_step_parity()
        torch.cuda.empty_cache()

        # (b) the gym VAE at its full configuration
        gym_dir = work / "gym"
        base = ["--synthetic", "--frame-size", str(frame_size), "--state-size", str(gym_clip),
                "--batch", str(gym_batch), "--steps", str(GYM_VAE_STEPS), "--ckpt-dir",
                str(gym_dir), "--out-dir", str(gym_dir), "--device", DEV]
        for remat in (False, True):
            args = gym_vae_train.parse_args(base + (["--remat"] if remat else []))
            tr = gym_vae_train.build_trainer(args)
            loader, _ = gym_vae_train.make_loader(args)
            try:
                with contextlib.redirect_stdout(io.StringIO()) as text:
                    bundle, ms, peak = timed_loop(
                        lambda tr, ld, on_step: gym_vae_train.train_loop(tr, ld, None, on_step),
                        tr, loader, GYM_VAE_STEPS)
                break
            except torch.cuda.OutOfMemoryError as e:
                if remat:
                    raise
                log(f"# vae-train gym: out of device memory without --remat ({str(e)[:120]}); "
                    f"again with --remat")
                del tr, loader
                torch.cuda.empty_cache()
        log(text.getvalue().strip())
        frames = next(iter(gym_vae_train.make_loader(args)[0]))[0]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gym_vae_train.train_step(tr, frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof_row = window_summary(prof, wall, 1)
        hist = {k: v[-1] for k, v in tr.history.items()}
        s = step_summary(ms)
        clips_s = gym_batch * 1e3 / s["warm_mean_ms"]
        ok = (all(np.isfinite(v) for v in hist.values()) and tr.count == GYM_VAE_STEPS + 1
              and Path(bundle).exists())
        log(f"# vae-train gym: VAE(3, 8, 8, 8) + MixedDiscriminator, batch {gym_batch} x "
            f"{gym_clip} frames x {frame_size} px, fp32; step ms {[round(x, 1) for x in ms]} "
            f"(step 0 the warm-up), warm mean {s['warm_mean_ms']:.1f} ms = {clips_s:.3f} clips/s; "
            f"peak {peak:.1f} MB; --remat needed: {remat}; one profiled step: "
            f"{prof_row['kernel_launches']:.0f} launches, busy {prof_row['device_busy_ms']:.1f} of "
            f"{prof_row['wall_ms']:.1f} ms (idle {prof_row['device_idle_share']:.1%}), top "
            f"{prof_row['top_device_ms'][:3]}; last losses {hist} ok={ok}")
        if not ok:
            failures.append("vae-train gym steps")
        summary["gym"] = dict(s, clips_per_s=clips_s, peak_mb=peak, remat=remat,
                              profiled=prof_row, losses=hist)
        del tr
        torch.cuda.empty_cache()

        vae, _ = vae_from_bundle(bundle, DEV)
        z = torch.randn((1, gym_clip // 4, frame_size // 4, frame_size // 4, 8),
                        generator=torch.Generator(device=DEV).manual_seed(7), device=DEV)
        with torch.no_grad():
            dec = vae.decode(z, torch.full((1,), 0.1, device=DEV))[0]
        png = work / "served.png"
        with contextlib.redirect_stdout(io.StringIO()) as text:
            generate.main(["--vae", str(bundle), "--context-frames", "2", "--gen-frames", "1",
                           "--bench-iters", "3", "--out", str(png), "--device", DEV])
        served = json.loads(text.getvalue().strip().splitlines()[-1])
        ok = (tuple(dec.shape) == (1, gym_clip, frame_size, frame_size, 3)
              and bool(torch.isfinite(dec).all()) and served["frames_finite"]
              and served["decoded_shape"][-3:] == [frame_size, frame_size, 3]
              and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n")
        log(f"# vae-train gym bundle: {Path(bundle).name} {Path(bundle).stat().st_size} B, "
            f"vae_from_bundle decodes {tuple(z.shape)} -> {tuple(dec.shape)}; generate --vae: "
            f"latents {served['frames_shape']} decoded {served['decoded_shape']} in "
            f"{served['vae_decode_ms']:.2f} ms, PNG {png.stat().st_size} B ok={ok}")
        if not ok:
            failures.append("vae-train gym bundle served")
        summary["served"] = served
        del vae, dec
        torch.cuda.empty_cache()

        # (c) the CS VAE, then its adversarial finetune
        cs_dir = work / "cs"
        kind = perceptual.perceptual_kind(3)
        cuts = []
        for clip, batch in cs_cuts:
            args = cs_vae_train.parse_args(
                ["--synthetic", "--steps", str(CS_VAE_STEPS), "--clip-size", str(clip),
                 "--batch", str(batch), "--frame-size", str(frame_size), "--ckpt-dir",
                 str(cs_dir), "--device", DEV] + (["--small"] if cs_small else []))
            tr = cs_vae_train.build_trainer(args)
            try:
                with contextlib.redirect_stdout(io.StringIO()) as text:
                    cs_bundle, cs_ms, cs_peak = timed_loop(
                        cs_vae_train.train_loop, tr, cs_vae_train.frame_batches(args),
                        CS_VAE_STEPS)
                break
            except torch.cuda.OutOfMemoryError as e:
                cuts.append(f"clip {clip} x batch {batch}: out of device memory "
                            f"({str(e)[:100]})")
                log(f"# vae-train cs: {cuts[-1]}")
                del tr
                torch.cuda.empty_cache()
        else:
            raise RuntimeError(f"the CS VAE fits none of {cs_cuts}")
        log(text.getvalue().strip())
        n_params = sum(p.numel() for p in tr.vae.parameters())
        last_lr = float(tr.opt.param_groups[0]["lr"])
        del tr
        torch.cuda.empty_cache()
        s = step_summary(cs_ms)
        log(f"# vae-train cs: VAE{tuple(cs_vae_train.vae_config(cs_small).channels)} "
            f"({n_params / 1e6:.2f}M params), batch {batch} x {clip} frames x {frame_size} px "
            f"(cuts: {cuts or 'none'}), perceptual loss {kind}; step ms "
            f"{[round(x, 1) for x in cs_ms]}, warm mean {s['warm_mean_ms']:.1f} ms; peak "
            f"{cs_peak:.1f} MB; last lr {last_lr:.3e}")
        summary["cs"] = dict(s, clip=clip, batch=batch, cuts=cuts, peak_mb=cs_peak,
                             perceptual=kind, params=n_params)

        adv_args = cs_vae_adversarial.parse_args(
            ["--synthetic", "--vae", str(cs_bundle), "--steps", str(ADV_STEPS), "--frame-size",
             str(frame_size), "--ckpt-dir", str(cs_dir), "--device", DEV])
        tr = cs_vae_adversarial.build_trainer(adv_args)
        with contextlib.redirect_stdout(io.StringIO()) as text:
            adv_bundle, adv_ms, adv_peak = timed_loop(
                cs_vae_adversarial.train_loop, tr, cs_vae_train.frame_batches(adv_args),
                ADV_STEPS)
        log(text.getvalue().strip())
        ok = Path(adv_bundle).exists() and tr.count == ADV_STEPS
        del tr
        torch.cuda.empty_cache()
        s = step_summary(adv_ms)
        log(f"# vae-train cs adversarial: --vae {Path(cs_bundle).name}, batch "
            f"{adv_args.batch} x {adv_args.clip_size} frames x {frame_size} px, step ms "
            f"{[round(x, 1) for x in adv_ms]}, peak {adv_peak:.1f} MB ok={ok}")
        if not ok:
            failures.append("vae-train cs adversarial")
        summary["cs_adversarial"] = dict(s, clip=adv_args.clip_size, batch=adv_args.batch,
                                         peak_mb=adv_peak)

        cal = work / "lpips_calibrated.npz"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            params = calibrate_lpips.main(["--out", str(cal), "--device", DEV])
        cal_s = time.perf_counter() - t0
        log(text.getvalue().strip())
        on_dev = perceptual.lpips_params_to(params, DEV)
        g = torch.Generator(device=DEV).manual_seed(8)
        shape = (1, adv_args.clip_size, frame_size, frame_size, 3)
        x, y = (torch.rand(shape, generator=g, device=DEV) * 2 - 1 for _ in range(2))
        lpips_ms = time_ms(lambda: perceptual.alexnet_lpips_loss(x, y, on_dev), iters=5, warmup=1)
        val = float(perceptual.alexnet_lpips_loss(x, y, on_dev))
        ok = np.isfinite(val)
        log(f"# vae-train lpips: calibrate_lpips --out in {cal_s:.1f} s; alexnet_lpips_loss on "
            f"{shape} {lpips_ms:.2f} ms a call (CUDA events), value {val:.4f} ok={ok}")
        if not ok:
            failures.append("vae-train lpips")
        summary["lpips"] = dict(calibrate_s=cal_s, loss_ms=lpips_ms, shape=list(shape))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = counts()
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"# vae-train phase: {summary['seconds']:.1f} s, launches {launches} (the served "
        f"rollout's; the training steps launch no port kernel)")
    return failures, summary, launches


# ---------------------------------------------------------------------------
# phase 13: the original's recorded tensors on the card, dropout and remat at
# full width, the drift tool on the trained weights

FIXTURES = ROOT / "tests" / "reference_parity" / "fixtures"
REF_CONFIG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
                  channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
                  frame_attn_resolutions=(16,), channels_per_head=16, max_frames=8)
TOL_REF = 3e-4     # tests/test_reference_parity.py: every output, std(diff)
TOL_REMAT = 1e-6   # max |remat - plain| / max |plain| of each gradient leaf
EPISODES = "run_artifacts/episodes/lunarlander_heuristic_seed0_256px.npz"
R3_UNET = "saved_models/gym_r3/unet_46M_ema0.050_step40000_bfloat16.ad"


def phase_counts(fa, fc) -> dict:
    return dict(conv_fwd=fc.conv_fwd_launches, conv_bwd=fc.conv_bwd_launches,
                block=fc.launches, prefill=fa.launches,
                **{n.removesuffix("_launches"): getattr(fa, n) for n in FLASH_COUNTERS})


def zero_phase_counts(fa, fc):
    fc.conv_fwd_launches = fc.conv_bwd_launches = fc.launches = fa.launches = 0
    zero_flash_counts(fa)


def reference_checks(dev) -> list:
    """[(check, value, bound)] of the port in fp32 on `dev` against the
    original's recorded tensors, as tests/test_torch_reference_parity.py
    holds it on the CPU: the causal conv and video attention fixtures (train,
    just_2d, prefill, decode) and the Precond imported by import_torch_3d
    (train y and input gradient, just_2d, prefill, cached decode, the loss
    and the 8-step sampler). Returns the Precond too."""
    import numpy as np
    from autoregressive_diffusion_tpu_torch.models import (Precond, UNetConfig, VideoAttention,
                                                           init_cache)
    from autoregressive_diffusion_tpu_torch.models.layers import MPCausalConv3d
    from autoregressive_diffusion_tpu_torch.sampling import edm_sampler, karras_schedule
    from autoregressive_diffusion_tpu_torch.train import EDM2LossConfig, edm2_loss, init_coefs
    from autoregressive_diffusion_tpu_torch.utils.import_2d import (_conv3d_w, _conv_w,
                                                                    _import_gating,
                                                                    _qkv_mcs_to_smc,
                                                                    import_torch_3d)

    def load(name):
        return dict(np.load(FIXTURES / name))

    def tl(x):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 1, 3, 4, 2)))).to(dev)

    def t_(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def sdiff(a, b):
        return float(torch.std(a.detach().double().cpu() - b.detach().double().cpu()))

    rows = []
    z = load("conv.npz")
    conv = MPCausalConv3d(6, 8)
    st = conv.state_dict()
    st["last_frame_conv.w"] = torch.from_numpy(_conv_w(z["sd/last_frame_conv.weight.weight"]))
    st["w"] = torch.from_numpy(_conv3d_w(z["sd/weight.weight"]).copy())
    _import_gating(st, "gating", {f"g.{k}": z[f"sd/gating.{k}"] for k in
                                  ("offset", "mult", "max_gating", "min_gating")}, "g")
    conv.load_state_dict(st)
    conv.to(dev)
    with torch.no_grad():
        x, cn = tl(z["x_train"]), t_(z["c_noise_train"])
        rows.append(("conv train", sdiff(conv(x, cn, mode="train")[0], tl(z["y_train"])), TOL_REF))
        rows.append(("conv just_2d", sdiff(conv(x, cn, mode="train", just_2d=True)[0],
                                           tl(z["y_2d"])), TOL_REF))
        xe = tl(z["x_eval"])
        y, cache = conv(xe, t_(z["cn_eval"]), update_cache=True)
        rows.append(("conv prefill", sdiff(y, tl(z["y_prefill"])), TOL_REF))
        y, _ = conv(tl(z["x_decode"]), t_(z["cn_decode"]), frames=xe.shape[1], cache=cache,
                    update_cache=True)
        rows.append(("conv decode", sdiff(y, tl(z["y_decode"])), TOL_REF))

    z = load("attention.npz")
    heads = int(z["num_heads"])
    attn = VideoAttention(32, heads, max_frames=8)
    st = attn.state_dict()
    st["attn_qkv.w"] = torch.from_numpy(
        _conv_w(_qkv_mcs_to_smc(z["sd/attn_qkv.weight.weight"], heads)).copy())
    st["attn_proj.w"] = torch.from_numpy(_conv_w(z["sd/attn_proj.weight.weight"]).copy())
    attn.load_state_dict(st)
    attn.to(dev)
    with torch.no_grad():
        x = tl(z["x_train"])
        rows.append(("attention train", sdiff(attn(x, mode="train")[0], tl(z["y_train"])),
                     TOL_REF))
        rows.append(("attention just_2d", sdiff(attn(x, mode="train", just_2d=True)[0],
                                                tl(z["y_2d"])), TOL_REF))
        xe = tl(z["x_eval"])
        y, cache = attn(xe, update_cache=True)
        rows.append(("attention prefill", sdiff(y, tl(z["y_prefill"])), TOL_REF))
        y, _ = attn(tl(z["x_decode"]), cache, True, xe.shape[1])
        rows.append(("attention decode", sdiff(y, tl(z["y_decode"])), TOL_REF))

    z = load("precond.npz")
    model = Precond(UNetConfig(**REF_CONFIG), sigma_data=1.0)
    sd = {k[3:]: v for k, v in z.items() if k.startswith("sd/")}
    model.load_state_dict(import_torch_3d(model.state_dict(), sd, model.cfg))
    model = model.to(dev).eval()
    x = tl(z["x_train"]).requires_grad_(True)
    probe = tl(np.sin(np.arange(z["y_train"].size, dtype=np.float32) * 0.17)
               .reshape(z["y_train"].shape))
    y, _ = model(x, t_(z["sigma_train"]), t_(z["cond_train"]).long(), mode="train")
    (y * probe).sum().backward()
    rows.append(("precond train y", sdiff(y, tl(z["y_train"])), TOL_REF))
    rows.append(("precond train input gradient", sdiff(x.grad, tl(z["probe_grad_x"])), 1e-3))
    with torch.no_grad():
        t = z["y_2d"].shape[1]
        cond = t_(z["cond_train"]).long()[:, :t]
        xs = tl(z["x_train"])[:, :t]
        y, _ = model(xs, t_(z["sigma_train"])[:, :t], cond, just_2d=True)
        rows.append(("precond just_2d", sdiff(y, tl(z["y_2d"])), TOL_REF))
        b = xs.shape[0]
        y, cache = model(xs, torch.full((b, t), 0.05, device=dev), cond,
                         cache=init_cache(model, b, device=dev), update_cache=True)
        rows.append(("precond prefill", sdiff(y, tl(z["y_prefill"])), TOL_REF))
        y, _ = model(tl(z["x_decode"]), torch.full((b, 1), 1.7, device=dev), cond[:, :1],
                     cache=cache, update_cache=True)
        rows.append(("precond decode", sdiff(y, tl(z["y_decode"])), TOL_REF))

        zl = load("loss.npz")
        sigma = t_(zl["sigma"])
        loss, aux = edm2_loss(model, tl(zl["images"]), 0,
                              EDM2LossConfig(P_mean=1.2, P_std=1.0, sigma_data=1.0,
                                             context_noise_reduction=0.5),
                              t_(zl["cond"]).long(), init_coefs(dev), sigma=sigma,
                              noise=sigma[:, :, None, None, None] * tl(zl["noise"]))
        for name, got, want in (("loss", loss, zl["loss"]),
                                ("unweighted loss", aux["unweighted"], zl["unweighted"])):
            rows.append((f"{name} (relative)", abs(float(got) - float(want))
                         / max(1.0, abs(float(want))), 2e-3))

        zs = load("sampler.npz")
        ctx, cond = tl(zs["ctx"]), t_(zs["cond"]).long()
        b, t = ctx.shape[:2]
        t0 = float(karras_schedule(8, 0.02, 20.0, 7.0)[0])
        kw = dict(num_steps=8, sigma_min=0.02, sigma_max=20.0, rho=7.0)

        def prefill():
            return model(ctx, torch.full((b, t), 0.05, device=dev), cond,
                         cache=init_cache(model, b, device=dev), update_cache=True)[1]

        shape = tuple(tl(zs["x_init"]).shape)
        x, _, _, _ = edm_sampler(model, prefill(), shape, cond[:, :1],
                                 x_init=tl(zs["x_init"]) * t0, **kw)
        rows.append(("sampler 8 steps", sdiff(x, tl(zs["x_final"])), 1e-3))
        _, mses, mses_pred, _ = edm_sampler(model, prefill(), shape, cond[:, :1],
                                            x_init=tl(zs["x_init_target"]) * t0,
                                            target=tl(zs["target"]), **kw)
        for name, got, want in (("sampler mse_target", mses, zs["mse_target"]),
                                ("sampler mse_pred_target", mses_pred, zs["mse_pred_target"])):
            # np.testing.assert_allclose(rtol=5e-3, atol=1e-4) as a ratio to 1
            err = np.abs(got.cpu().numpy() - want) / (1e-4 + 5e-3 * np.abs(want))
            rows.append((f"{name} (allclose ratio)", float(err.max()), 1.0))
    return rows, model


def body_check(model, dev) -> list:
    """The recorded Precond has out_gain = 0 and every emb_gain = 0 (the
    original's init), so its outputs do not see the UNet body: the same
    imported weights with those gains set to 1, on the card (kernels)
    against the CPU (plain versions): train y and input gradient, prefill
    and one cached decode step."""
    import numpy as np
    from autoregressive_diffusion_tpu_torch.models import Precond, init_cache

    state = {k: (torch.ones_like(v) if k.rsplit(".", 1)[-1] in ("out_gain", "emb_gain") else v)
             for k, v in model.state_dict().items()}
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 6, 16, 16, 4)).astype(np.float32)
    sig = np.exp(rng.normal(size=(2, 6))).astype(np.float32)
    cond = rng.integers(0, 4, size=(2, 6))
    xd = rng.normal(size=(2, 1, 16, 16, 4)).astype(np.float32)
    out = {}
    for d in (dev, "cpu"):
        m = Precond(model.cfg, sigma_data=1.0)
        m.load_state_dict(state)
        m = m.to(d).eval()
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        y, _ = m(xt, torch.from_numpy(sig).to(d), torch.from_numpy(cond).to(d), mode="train")
        (y * y).sum().backward()
        with torch.no_grad():
            c = torch.from_numpy(cond[:, :3]).to(d)
            yp, cache = m(xt.detach()[:, :3], torch.full((2, 3), 0.05, device=d), c,
                          cache=init_cache(m, 2, device=d), update_cache=True)
            yd, _ = m(torch.from_numpy(xd).to(d), torch.full((2, 1), 1.7, device=d), c[:, :1],
                      cache=cache, update_cache=True)
        out[d] = [t.detach().double().cpu() for t in (y, xt.grad, yp, yd)]
    rows = []
    for name, a, b in zip(("train y", "train input gradient", "prefill", "decode"),
                          out[dev], out["cpu"]):
        rows.append((f"gains 1, card vs CPU: {name} std(diff)/std(CPU)",
                     float((a - b).std() / b.std()), TOL_REF))
    return rows


def dropout_remat_check(fa, fc, build_trainer, synthetic_batch, run_steps, edm2_loss,
                        loss_cfg, steps=3, overrides=None):
    """The gym DART step (bf16 body, batch 8, T=8) with dropout 0.1, without
    and with per-Block remat, from the same weights, batch and seed (so the
    same dropout masks): one loss + backward each, its launches counted and
    its gradients compared leaf by leaf; then `steps` train steps each
    (step 0 the warm-up) for the step time and the peak memory."""
    overrides = dict(overrides or {})
    b, t = 8, 8
    res = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        state, step = build_trainer(DEV, torch.bfloat16, seed=0, batch=b, dropout=0.1,
                                    remat=remat, **overrides)
        model = state.model
        images, cond = synthetic_batch(model.cfg, b, t, 1, torch.device(DEV))
        zero_phase_counts(fa, fc)
        loss, _ = edm2_loss(model, images, 77, loss_cfg, cond, state.coefs)
        loss.backward()
        torch.cuda.synchronize()
        counts = phase_counts(fa, fc)
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        zero_phase_counts(fa, fc)
        rows = run_steps(state, step, images, cond, steps, seed=0, just_2d_every=0)
        step_counts = {k: v / steps for k, v in phase_counts(fa, fc).items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        step_ms = [r["seconds"] * 1e3 for r in rows]
        res[remat] = dict(loss=float(loss.detach()), counts=counts, step_counts=step_counts,
                          grads=grads, peak_mb=peak, step_ms=step_ms,
                          losses=[r["loss"] for r in rows])
        n_blocks = sum(sp["kind"] == "block" for _, _, sp in model.cfg.block_layout())
        n_convs = 2 * n_blocks + 2
        n_video = sum(1 for _, _, sp in model.cfg.block_layout()
                      if sp.get("attention") == "video" and model.cfg.num_heads(sp))
        n_frame = sum(1 for _, _, sp in model.cfg.block_layout()
                      if sp.get("attention") == "frame" and model.cfg.num_heads(sp))
        del state, step, model, loss
    g0, g1 = res[False]["grads"], res[True]["grads"]
    worst, worst_name, bitwise = 0.0, "", set(g0) == set(g1)
    for n, ref in g0.items():
        d = (g1[n] - ref).abs().max()
        err = float(d / ref.abs().max().clamp_min(1e-30))
        bitwise = bitwise and bool(torch.equal(g1[n], ref))
        if err > worst:
            worst, worst_name = err, n
    # remat runs every Block's forward again inside the backward: its two
    # convs and its attention layer (every attention layer sits in a Block)
    want = {False: dict(conv_fwd=n_convs, conv_bwd=n_convs, dart_fwd=n_video,
                        dart_bwd=n_video, full_fwd=n_frame, full_bwd=n_frame),
            True: dict(conv_fwd=n_convs + 2 * n_blocks, conv_bwd=n_convs,
                       dart_fwd=2 * n_video, dart_bwd=n_video, full_fwd=2 * n_frame,
                       full_bwd=n_frame)}
    return dict(res=res, worst=worst, worst_name=worst_name, bitwise=bitwise, want=want,
                n_leaves=len(g0))


def ref_drift_phase(fa, fc, build_trainer, synthetic_batch, run_steps, edm2_loss, loss_cfg,
                    drift_frames=8, dropout_steps=3, overrides=None, unet=R3_UNET):
    """Phase 13: (a) reference_checks and body_check on the card, with the
    kernels' launches counted; (b) dropout_remat_check at full width; (c)
    rollout_drift on the r3 weights and the trained VAE over the committed
    episode 0 for drift_frames frames, every launch counter zeroed before
    and read after (17 decode Blocks a denoiser call, 6 prefill launches a
    prefill), the series finite and in drift.npz. Returns (failures,
    summary, launches)."""
    import contextlib
    import io
    import numpy as np
    from autoregressive_diffusion_tpu_torch import rollout_drift
    from autoregressive_diffusion_tpu_torch.models import UNetConfig
    from autoregressive_diffusion_tpu_torch.utils import load_model

    failures, summary = [], {}
    t_phase = time.perf_counter()

    # (a) the original's recorded tensors through the kernels, fp32
    zero_phase_counts(fa, fc)
    t0 = time.perf_counter()
    rows, model = reference_checks(torch.device(DEV))
    rows += body_check(model, torch.device(DEV))
    torch.cuda.synchronize()
    c = phase_counts(fa, fc)
    launches = dict(c)
    for name, value, bound in rows:
        ok = value <= bound
        log(f"# ref {name}: {value:.3e} (bound {bound:.0e}) ok={ok}")
        if not ok:
            failures.append(f"reference fixture {name}: {value:.3e} > {bound:.0e}")
    used = {k: c[k] for k in ("conv_fwd", "conv_bwd", "block", "prefill", "dart_fwd",
                              "dart_bwd", "full_fwd")}
    log(f"# ref launches: {c} ({time.perf_counter() - t0:.1f} s)")
    if not all(used.values()):
        failures.append(f"reference fixtures: a kernel never launched {used}")
    summary["reference"] = dict(rows=rows, launches=c)
    del model
    torch.cuda.empty_cache()

    # (b) dropout and remat at full width
    t0 = time.perf_counter()
    r = dropout_remat_check(fa, fc, build_trainer, synthetic_batch, run_steps, edm2_loss,
                            loss_cfg, dropout_steps, overrides)
    for remat in (False, True):
        x = r["res"][remat]
        for k2, v in x["counts"].items():
            launches[k2] += v + round(x["step_counts"][k2] * dropout_steps)
        got = {k2: x["counts"][k2] for k2 in r["want"][remat]}
        steady = x["step_ms"][1:] or x["step_ms"]
        log(f"# dropout 0.1 remat={remat}: loss {x['loss']:.6f}, step ms {x['step_ms']} "
            f"(mean of steps 1+ {sum(steady) / len(steady):.1f}), peak_mem_mb="
            f"{x['peak_mb']:.1f}, launches of a loss + backward {got} (want "
            f"{r['want'][remat]}), a train step {x['step_counts']}")
        if got != r["want"][remat]:
            failures.append(f"dropout remat={remat}: launches {got} != {r['want'][remat]}")
        if not all(np.isfinite(x["losses"])):
            failures.append(f"dropout remat={remat}: loss not finite")
    log(f"# remat vs plain gradients (dropout 0.1, same masks): worst max|diff|/max|plain| "
        f"{r['worst']:.3e} ({r['worst_name']}, {r['n_leaves']} leaves; tol {TOL_REMAT:.0e}), "
        f"bitwise equal={r['bitwise']}; loss {r['res'][False]['loss']!r} vs "
        f"{r['res'][True]['loss']!r} ({time.perf_counter() - t0:.1f} s)")
    if r["worst"] > TOL_REMAT:
        failures.append(f"remat gradients differ: {r['worst']:.3e}")
    summary["dropout_remat"] = {
        "worst_rel": r["worst"], "worst_leaf": r["worst_name"], "bitwise": r["bitwise"],
        **{f"remat={k}": {k2: v for k2, v in x.items() if k2 != "grads"}
           for k, x in r["res"].items()}}
    del r
    torch.cuda.empty_cache()

    # (c) the drift tool on the trained weights, committed episode 0
    t0 = time.perf_counter()
    out = ROOT / "build" / f"drift_phase_{int(time.time() * 1e3)}"
    zero_phase_counts(fa, fc)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = rollout_drift.main(["--unet", str(ROOT / unet), "--vae", str(ROOT / VAE_BUNDLE),
                                      "--episodes-file", str(ROOT / EPISODES), "--episodes", "1",
                                      "--frames", str(drift_frames), "--out", str(out),
                                      "--device", DEV])
        torch.cuda.synchronize()
        c = phase_counts(fa, fc)
        for k2, v in c.items():
            launches[k2] += v
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"# drift: {line.lstrip('# ')}")
        args = rollout_drift.parse_args(["--unet", unet, "--vae", VAE_BUNDLE])
        calls = drift_frames * (2 * args.num_steps - 1)
        cfg = UNetConfig(**{k2: tuple(v) if isinstance(v, list) else v
                            for k2, v in load_model(ROOT / unet)[0].items()})
        n_blocks = len(decode_block_shapes(cfg))  # r3: 17
        n_video = sum(1 for _, _, sp in cfg.block_layout()  # r3: 6
                      if sp.get("attention") == "video" and cfg.num_heads(sp))
        want_block, want_prefill = n_blocks * calls, n_video
        log(f"# drift launches: decode block {c['block']} (want {want_block} = {n_blocks} x "
            f"{calls} "
            f"denoiser calls), prefill {c['prefill']} (want {want_prefill}), full fwd "
            f"{c['full_fwd']}; {time.perf_counter() - t0:.1f} s, "
            f"{res['episode_seconds'][0] / calls * 1e3:.1f} ms a denoiser call with the "
            f"encode and decode")
        with np.load(out / "drift.npz") as z:
            keys = sorted(z.files)
            finite = all(bool(np.isfinite(z[k]).all()) for k in keys)
            shapes = {z[k].shape for k in keys}
        if keys != sorted(["latent_mse", "persistence_mse", "pixel_mse", "gen_std", "gt_std"]):
            failures.append(f"drift.npz keys {keys}")
        if not finite or shapes != {(drift_frames,)}:
            failures.append(f"drift series not finite or of shape {shapes}")
        if (c["block"], c["prefill"]) != (want_block, want_prefill):
            failures.append(f"drift launches block {c['block']} prefill {c['prefill']} != "
                            f"{want_block}, {want_prefill}")
        summary["drift"] = dict(series={k: v.tolist() for k, v in res["series"].items()},
                                summary=res["summary"], seconds=res["episode_seconds"],
                                launches=c, denoiser_calls=calls)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"# ref-drift phase: {summary['seconds']:.1f} s, launches {launches}")
    return failures, summary, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the detailed results here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3 and 6 (the kernel checks and times) and stop, "
                         "printing no result line: for timing kernels, not for proving the port")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / PKG / "csrc").is_dir():
        print(f"chip_smoke: the port's package {PKG}/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F
    from autoregressive_diffusion_tpu_torch.generate import GYM_CONFIG, build_model, rollout
    from autoregressive_diffusion_tpu_torch.models import UNetConfig, init_cache
    from autoregressive_diffusion_tpu_torch.ops import _build, masks
    from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
    from autoregressive_diffusion_tpu_torch.ops import fused_conv as fc
    from autoregressive_diffusion_tpu_torch.train import (build_trainer, edm2_loss,
                                                          run_steps, synthetic_batch)
    from autoregressive_diffusion_tpu_torch.train.cli import GYM_LOSS

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"# card: {smi}")
    kind = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("# TF32 off for matmuls and cuDNN convolutions: fp32 comparisons are fp32")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"# build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'cached'}")
    ptxas = {}
    for name, text in logs.items():
        ptxas[name] = ptxas_report(text)
        for fn, regs, st, ld in ptxas[name]:
            log(f"# ptxas {name}: {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")

    failures = []
    sass = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd", "decode_block", "fused_conv_fwd",
                 "fused_conv_bwd"):
        sass[name] = sass_counts(_build._lib_path(name))
        if sass[name] is None:
            log(f"# sass {name}: cuobjdump not found, instructions not counted")
            continue
        if not sass[name]:
            failures.append(f"{name}: no tensor-core kernel in its machine code")
        for fn, (n_wgmma, n_mma, n_tma, n_cpa) in sass[name].items():
            log(f"# sass {name}: {fn}: {n_wgmma} wgmma (HGMMA), {n_mma} mma.sync (HMMA), "
                f"{n_tma} TMA loads (UTMALDG), {n_cpa} cp.async (LDGSTS)")
            # the flash kernels (prefill's ring kind among them) are wgmma fed by
            # TMA; the decode Block's and the train-mode conv's mma.sync fed by
            # cp.async (csrc/conv_tc.cuh says why not wgmma)
            if not ((n_wgmma and n_tma) if name.startswith("flash") else (n_mma and n_cpa)):
                failures.append(f"{fn}: no tensor-core product or no asynchronous copy in its "
                                f"machine code")
    attn_rows = attention_phase(fa, masks, F)
    failures += [f"attention {r['dtype']} {r['case']}" for r in attn_rows if not r["ok"]]

    gym = UNetConfig(**GYM_CONFIG)
    cs_cfg = UNetConfig(**cs_model_config())
    flash_results = flash_phase(fa, masks, F, gym)
    flash_results.update(flash_phase(fa, masks, F, cs_cfg, b=2, t=16, label="cs", odd=False))
    failures += [f"flash attention {k}" for k, r in flash_results.items() if not r["ok"]]
    shapes, block_results = decode_block_phase(fc, gym)
    cs_shapes, cs_block_results = decode_block_phase(fc, cs_cfg)
    block_results.update(cs_block_results)
    failures += [f"decode block {k}" for k, r in block_results.items() if not r["ok"]]

    def conv_phases():
        calls, results = conv_phase(fc, gym)
        cs_calls, cs_results = conv_phase(fc, cs_cfg, b=2, t=16, label="cs", odd=False)
        results.update(cs_results)
        return calls, cs_calls, results

    if args.kernels_only:
        calls, cs_calls, conv_results = conv_phases()
        failures += [f"fused conv {k}" for k, r in conv_results.items() if not r["ok"]]
        conv_kernel_rows(calls, conv_results, 0, 0)
        cs_kernel_summary(cs_cfg, cs_calls, conv_results, flash_results, cs_shapes,
                          block_results)
        log(f"# kernels-only: stopped after phases 3 and 6, {time.perf_counter() - t_start:.1f} "
            f"s, {len(failures)} failures {failures}")
        return 1 if failures else 0

    tiny = dict(img_resolution=16, img_channels=4, model_channels=16, channel_mult=(1, 2),
                num_blocks=1, max_frames=8, channels_per_head=16)
    ok_small, _ = e2e_phase(lambda d: build_model(d, torch.float32, seed=1, **tiny),
                            init_cache, "small", 3)
    ok_full, e2e_full = e2e_phase(lambda d: build_model(d, torch.float32, seed=1),
                                  init_cache, "gym full width", 2)
    if not ok_small:
        failures.append("end to end, small model")
    if not ok_full:
        failures.append("end to end, full-width gym model")

    # phase 5: the main path
    model = build_model(DEV, torch.bfloat16, seed=0)
    main_run = serve_phase(rollout, fa, fc, gym, len(shapes), model, "seeded random",
                           bench_iters=20)
    failures += main_run["failures"]
    out = {k: v for k, v in main_run["out"].items() if k not in ("frames", "cache")}
    peak_mb = main_run["peak_mb"]
    launches_a, launches_b = main_run["counts"]["prefill"], main_run["counts"]["block"]
    rollout_flash = main_run["counts"]["flash"]
    del model, main_run
    torch.cuda.empty_cache()

    # phase 9: trained weights from the committed bundles (after phase 5,
    # which it extends: the same path on the r3 weights, bf16 and int8)
    trained, trained_failures = trained_phase(rollout, fa, fc, gym, shapes, init_cache)
    failures += trained_failures
    for run in trained["runs"].values():
        launches_a += run["counts"]["prefill"]
        launches_b += run["counts"]["block"]
        rollout_flash = tuple(a + b for a, b in zip(rollout_flash, run["counts"]["flash"]))
    torch.cuda.empty_cache()

    # phase 6: the train-mode conv kernels
    calls, cs_calls, conv_results = conv_phases()
    failures += [f"fused conv {k}" for k, r in conv_results.items() if not r["ok"]]
    cs_kernels = cs_kernel_summary(cs_cfg, cs_calls, conv_results, flash_results, cs_shapes,
                                   block_results)
    ok_dw, dw_err_kernel, dw_err_plain = dw_float64_check(fc)
    if not ok_dw:
        failures.append("fused conv dw2 against float64")

    # phase 7: the training path
    ok_grads, grad_err = grad_parity_phase(build_trainer, edm2_loss, GYM_LOSS, tiny, fa)
    if not ok_grads:
        failures.append("train gradients, card vs CPU")
    train_failures, train_launches, train_summary = train_phase(
        build_trainer, synthetic_batch, run_steps, fc, fa, len(calls))
    launches_cf, launches_cb = train_launches[:2]
    train_flash = train_launches[2:]
    failures += train_failures

    # phase 8: sequence parallelism
    sp_results = sp_kernel_phase(fa, masks, F)
    failures += [f"sp attention kernels {k}" for k, r in sp_results.items() if not r["ok"]]
    torch.cuda.empty_cache()
    sp_failures, sp_ranks = sp_path_phase(build_trainer, len(calls))
    failures += sp_failures

    # phase 10: the gym training path (gym_train.py) and its EMA export
    torch.cuda.empty_cache()
    gym_failures, gym_summary = gym_phase(fa, fc, len(shapes))
    failures += gym_failures
    gym_launches = gym_summary.get("launches") or {}
    launches_a += gym_launches.get("prefill", 0)
    launches_b += gym_launches.get("block", 0)
    launches_cf += gym_launches.get("conv_fwd", 0)
    launches_cb += gym_launches.get("conv_bwd", 0)
    train_flash = tuple(t + gym_launches.get(k, 0) for t, k in
                        zip(train_flash, ("dart_fwd", "dart_bwd", "full_fwd", "full_bwd")))

    # phase 11: the CS path (build_cs_dataset, cs_train, cs_rollout, context_probe)
    torch.cuda.empty_cache()
    cs_failures, cs_summary = cs_phase(fa, fc)
    failures += cs_failures
    cs_launches = cs_summary.get("launches") or {}
    launches_a += cs_launches.get("prefill", 0)
    launches_b += cs_launches.get("block", 0)
    launches_cf += cs_launches.get("conv_fwd", 0)
    launches_cb += cs_launches.get("conv_bwd", 0)
    train_flash = tuple(t + cs_launches.get(k, 0) for t, k in
                        zip(train_flash, ("dart_fwd", "dart_bwd", "full_fwd", "full_bwd")))

    # phase 12: VAE training (gym_vae_train, cs_vae_train, cs_vae_adversarial)
    torch.cuda.empty_cache()
    vae_failures, vae_summary, vae_launches = vae_train_phase(fa, fc)
    failures += vae_failures
    launches_a += vae_launches["prefill"]
    launches_b += vae_launches["block"]
    launches_cf += vae_launches["conv_fwd"]
    launches_cb += vae_launches["conv_bwd"]
    train_flash = tuple(t + vae_launches[k] for t, k in
                        zip(train_flash, ("dart_fwd", "dart_bwd", "full_fwd", "full_bwd")))

    # phase 13: the original's recorded tensors on the card, dropout and
    # remat at full width, the drift tool on the trained weights
    torch.cuda.empty_cache()
    ref_failures, ref_summary, ref_launches = ref_drift_phase(
        fa, fc, build_trainer, synthetic_batch, run_steps, edm2_loss, GYM_LOSS)
    failures += ref_failures
    launches_a += ref_launches["prefill"]
    launches_b += ref_launches["block"]
    launches_cf += ref_launches["conv_fwd"]
    launches_cb += ref_launches["conv_bwd"]
    train_flash = tuple(t + ref_launches[k] for t, k in
                        zip(train_flash, ("dart_fwd", "dart_bwd", "full_fwd", "full_bwd")))

    # the kernels line: main-path shapes in the main path's dtype (bf16)
    main_attn = next(r for r in attn_rows
                     if r["dtype"] == "bfloat16" and r["case"] == "ring off=0 t=8 F=64")
    per_call = [block_results[(s, "bfloat16", True)] for _, s in shapes]
    kernels = [
        dict(name="prefill_attention", route="cuda",
             source=f"{PKG}/csrc/flash_attention_fwd.cu",
             replaces="autoregressive_diffusion_tpu/ops/flash_attention.py:201",
             launches=launches_a, max_abs_err=main_attn["max_abs_err"], ms=main_attn["ms"],
             plain_ms=main_attn["plain_ms"], bound_ms=main_attn["bound_ms"],
             bound_by=main_attn["bound_by"], library_ms=main_attn["library_ms"],
             ok=all(r["ok"] for r in attn_rows)),
        dict(name="decode_block", route="cuda", source=f"{PKG}/csrc/decode_block.cu",
             replaces="autoregressive_diffusion_tpu/ops/fused_conv.py:1130",
             launches=launches_b, max_abs_err=max(r["max_abs_err"] for r in per_call),
             ms=sum(r["ms"] for r in per_call), plain_ms=sum(r["plain_ms"] for r in per_call),
             bound_ms=sum(r["bound_ms"] for r in per_call),
             bound_by=("operations" if sum(r["bound_by"] == "operations" for r in per_call)
                       > len(per_call) / 2 else "bytes"),
             library_ms=None, ok=all(r["ok"] for r in block_results.values())),
    ]
    kernels += conv_kernel_rows(calls, conv_results, launches_cf, launches_cb)
    # the flash kernels: sums over the attention layers of one DART step
    # (batch 8, T=8, bf16); launches over the rollout and the four steps
    dart_step = attention_calls(gym, 8, 8, False)
    flash_launches = {"dart_fwd": train_flash[0], "dart_bwd": train_flash[1],
                      "full_fwd": rollout_flash[2] + train_flash[2], "full_bwd": train_flash[3]}
    for mask_kind, line in (("dart", 177), ("full", 224)):
        rs = [flash_results[("gym", c, "bfloat16")] for c in dart_step if c[0] == mask_kind]
        for which in ("fwd", "bwd"):
            by = [r[f"bound_{which}_by"] for r in rs]
            kernels.append(dict(
                name=f"{mask_kind}_attention_{which}", route="cuda",
                source=f"{PKG}/csrc/flash_attention_{which}.cu",
                replaces=f"autoregressive_diffusion_tpu/ops/flash_attention.py:{line}",
                launches=flash_launches[f"{mask_kind}_{which}"],
                max_abs_err=max(r["max_abs_err"] for r in rs),
                ms=sum(r[f"{which}_ms"] for r in rs),
                plain_ms=sum(r[f"plain_{which}_ms"] for r in rs),
                bound_ms=sum(r[f"bound_{which}_ms"] for r in rs),
                bound_by="operations" if by.count("operations") > len(by) / 2 else "bytes",
                library_ms=sum(r[f"library_{which}_ms"] for r in rs),
                ok=all(r["ok"] for r in flash_results.values())))
    log(f"# dart/full_attention ms/plain_ms/bound_ms/library_ms are sums over the "
        f"{len(dart_step)} attention layers of one DART step (batch 8, T=8, bf16; ms and "
        f"library_ms are device times; library: F.scaled_dot_product_attention on the same "
        f"mask, for full the faster of the mask and no mask); launches: "
        f"rollout {rollout_flash}, training {tuple(train_flash)} (dart fwd/bwd, full fwd/bwd)")
    # the SP kernels: one rank's calls over the 6 video layers of a DART step
    # (sp=2, bf16, mean of the two ranks); launches over both ranks' steps
    n_video_layers = sp_ranks[0]["gym"]["n_video"]
    for which in ("fwd", "bwd"):
        rs = [sp_results[("dart", "bfloat16", 2, r)] for r in range(2)]
        errs = [v["max_abs_err"] for k, v in sp_results.items()
                if k[0] == "dart" and k[3] != "stack"]

        def per_step(key):
            return n_video_layers * sum(r[key] for r in rs) / len(rs)

        kernels.append(dict(
            name=f"dart_attention_sp_{which}", route="cuda",
            source=f"{PKG}/csrc/flash_attention_{which}.cu",
            replaces="autoregressive_diffusion_tpu/ops/flash_attention.py:326",
            launches=sum(c[f"dart_sp_{which}"] for res in sp_ranks for c in res["gym"]["counts"]),
            max_abs_err=max(errs), ms=per_step(f"{which}_ms"),
            plain_ms=per_step(f"plain_{which}_ms"), bound_ms=per_step(f"bound_{which}_ms"),
            bound_by=rs[0][f"bound_{which}_by"], library_ms=per_step(f"library_{which}_ms"),
            ok=all(v["ok"] for v in sp_results.values())))
    log(f"# dart_attention_sp ms/plain_ms/bound_ms/library_ms are one rank's sums over the "
        f"{n_video_layers} video layers of a DART step (sp=2, bf16, q (8, 4, 512, 64) against "
        f"k/v (8, 4, 1024, 64), mean of the two ranks; ms and library_ms are device times; "
        f"library: F.scaled_dot_product_attention on the same rows and mask); launches: both "
        f"ranks' four steps. The same entry points "
        f"with the causal mask (flash_attention.py:336) were checked above")
    for k in kernels:
        if k["launches"] == 0:
            failures.append(f"{k['name']} never launched on the main path")
    log("# launches of prefill_attention, decode_block and full_attention_fwd count the "
        "rollouts of phases 5 and 9 (seeded random, r3 bf16, r3 int8) and the training steps; "
        "every row also counts phase 10 (the gym training path, its sampler callback, the "
        "resume and replay steps and the served export), phase 11 (the CS path: its "
        "training steps, the card-against-CPU check, the probe, the rollout and the timed "
        "denoiser calls), phase 12 (the rollout that serves the trained VAE; VAE training "
        "launches no port kernel) and phase 13 (the reference fixtures, the dropout and remat "
        "steps, the drift rollout)")
    log("# decode_block ms/plain_ms/bound_ms are sums over the 17 Blocks of one denoiser "
        "call; prefill_attention's are at the first prefill (t_new=8, f_total=64); the "
        "ms and library_ms of both are device times (library: F.scaled_dot_product_attention "
        "on the same mask), plain_ms wall times")

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        detail = dict(card=smi, kind=kind, attention=attn_rows, ptxas=ptxas, sass=sass,
                      decode_block=[dict(shape=list(k[0]), dtype=k[1], with_ctx=k[2], **v)
                                    for k, v in block_results.items()],
                      e2e_full=e2e_full, rollout={k: v for k, v in out.items()
                                                  if k not in ("frames", "cache")},
                      peak_mem_mb=peak_mb, kernels=kernels,
                      fused_conv=[dict(kind=k[0], B=k[1], F=k[2], H=k[3], W=k[4], C=k[5],
                                       Co=k[6], silu_in=k[7], has_cvec=k[8], with_ctx=k[9],
                                       dtype=k[10], **v) for k, v in conv_results.items()],
                      conv_calls=[[n, list(sh)] for n, sh in calls],
                      dw2_err_vs_float64=dict(kernel=dw_err_kernel, plain=dw_err_plain),
                      flash_attention=[dict(kind=k[0], shape=list(k[1]), dtype=k[2], **v)
                                       for k, v in flash_results.items()],
                      train_grad_err=grad_err, train=train_summary,
                      trained=trained["summary"],
                      sp_attention=[dict(kind=k[0], dtype=k[1], sp=k[2], rank=k[3], **v)
                                    for k, v in sp_results.items()],
                      sp_path=[dict(rank=r["rank"], small_losses=r["small"]["losses"],
                                    **{k: v for k, v in r["gym"].items()})
                               for r in sp_ranks],
                      gym=gym_summary, cs=cs_summary, cs_kernels=cs_kernels,
                      vae_train=vae_summary, ref_drift=ref_summary)
        Path(args.out).write_text(json.dumps(detail, indent=1))

    log(f"# total {time.perf_counter() - t_start:.1f} s")
    if failures:
        for f_ in failures:
            print(f"chip_smoke: FAILED: {f_}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
