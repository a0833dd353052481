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
     the gym model's DART and just_2d training steps (batch 8, T=8), at the
     rollout's frame-attention shapes (b*t = 1 and 8 frames) and at odd
     shapes (T=3, hw=40, d=32, batch 1), with times of the kernels, the
     plain versions and F.scaled_dot_product_attention on the same mask
     (for the full kind also with no mask), forward and backward; kernel
     and SDPA times are device times (device_ms: the calls queued behind a
     sleeping kernel, so the host's launch cost is not counted), the wall
     time a call beside them;
  3. the fused decode-Block kernels against their plain version for every
     attention-free Block shape of the gym model, fp32 (SIMT) and bf16
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
     causal convs at batch 8, T=8, and at one odd shape (24x40, C=9, T=3,
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
     DART launch, 5 full, 58 conv forward and backward).
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


def flash_phase(fa, masks, F, cfg, b=8, t=8):
    dev = torch.device(DEV)
    gym = sorted(set(attention_calls(cfg, b, t, False) + attention_calls(cfg, b, t, True)))
    cases = ([("gym", c) for c in gym] + [("serve", c) for c in serving_calls(cfg)]
             + [("odd", ("dart", 1, 2, 3, 40, 32)), ("odd", ("full", 3, 2, 1, 40, 32))])
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

def e2e_phase(build_model, init_cache, overrides, label, ctx_frames):
    dev = torch.device(DEV)
    gpu = build_model(DEV, torch.float32, seed=1, **overrides)
    cpu = build_model("cpu", torch.float32, seed=1, **overrides)
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


def conv_phase(fc, cfg, b=8, t=8):
    """Kernels against the plain version at every distinct causal conv of
    the model (batch 8, T=8) and the odd shapes, fp32 and bf16; bf16 also
    run twice, bit for bit. Times: the forward and the backward entry point
    each on its own, and the unfused cuDNN path's forward and its backward
    (autograd over a kept graph), as device time (device_ms) and as wall
    time a call; the plain version's as wall time."""
    calls = conv_calls(cfg)
    gym = sorted(set(s for _, s in calls), key=lambda s: (-s[0], s[1], s[2], s[3], s[4]))
    cases = [("gym", b, 2 * t if ctx else t, h, h, c, co, silu, cv, ctx)
             for (h, c, co, silu, cv) in gym for ctx in (True, False)]
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
    flash_results = flash_phase(fa, masks, F, gym)
    failures += [f"flash attention {k}" for k, r in flash_results.items() if not r["ok"]]
    shapes, block_results = decode_block_phase(fc, gym)
    failures += [f"decode block {k}" for k, r in block_results.items() if not r["ok"]]
    if args.kernels_only:
        calls, conv_results = conv_phase(fc, gym)
        failures += [f"fused conv {k}" for k, r in conv_results.items() if not r["ok"]]
        conv_kernel_rows(calls, conv_results, 0, 0)
        log(f"# kernels-only: stopped after phases 3 and 6, {time.perf_counter() - t_start:.1f} "
            f"s, {len(failures)} failures {failures}")
        return 1 if failures else 0

    tiny = dict(img_resolution=16, img_channels=4, model_channels=16, channel_mult=(1, 2),
                num_blocks=1, max_frames=8, channels_per_head=16)
    ok_small, _ = e2e_phase(build_model, init_cache, tiny, "small", 3)
    ok_full, e2e_full = e2e_phase(build_model, init_cache, {}, "gym full width", 2)
    if not ok_small:
        failures.append("end to end, small model")
    if not ok_full:
        failures.append("end to end, full-width gym model")

    # phase 5: the main path
    model = build_model(DEV, torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bench_iters, n_gen, n_steps = 20, 2, 64
    fa.launches = fc.launches = 0
    zero_flash_counts(fa)
    out = rollout(model, context_frames=8, gen_frames=n_gen, num_steps=n_steps,
                  sigma_max=80.0, sigma_min=0.4, rho=2.0, reprime_frames=2,
                  bench_iters=bench_iters, seed=0)
    torch.cuda.synchronize()
    launches_a, launches_b = fa.launches, fc.launches
    rollout_flash = flash_counts(fa)
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    frames = out["frames"]
    denoiser_calls = 1 + bench_iters + n_gen * (2 * n_steps - 1)
    n_video = sum(1 for _, _, sp in gym.block_layout()
                  if sp.get("attention") == "video" and gym.num_heads(sp))
    want_a, want_b = n_video * 2, len(shapes) * denoiser_calls  # gym: 6 and 17
    n_frame = sum(1 for _, _, sp in gym.block_layout()
                  if sp.get("attention") == "frame" and gym.num_heads(sp))
    model_calls = denoiser_calls + 2  # and the prefill and the re-prime
    want_flash = (0, 0, n_frame * model_calls, 0)
    finite = bool(torch.isfinite(frames).all())
    log(f"# rollout: {n_params / 1e6:.1f}M params bf16, frames {tuple(frames.shape)} "
        f"finite={finite} cache frames={out['cache']['frames']} "
        f"prefill_s={out['prefill_s']:.4f} decode_ms_per_call={out['decode_ms_per_call']:.3f} "
        f"rollout_frames_per_sec={out['rollout_frames_per_sec']:.4f} "
        f"reprime_s={out['reprime_s']:.4f} peak_mem_mb={peak_mb:.1f}")
    log(f"# launches: prefill attention {launches_a} (want {want_a}), "
        f"decode block {launches_b} (want {want_b} = {len(shapes)} x {denoiser_calls} calls), "
        f"flash dart fwd/bwd, full fwd/bwd {rollout_flash} (want {want_flash}: "
        f"{n_frame} frame layers x {model_calls} model calls)")
    res, ch = gym.img_resolution, gym.img_channels
    if not finite or tuple(frames.shape) != (1, n_gen, res, res, ch):
        failures.append("rollout output")
    if out["cache"]["frames"] != 12:
        failures.append(f"cache frame counter {out['cache']['frames']} != 12")
    if launches_a != want_a or launches_b != want_b or rollout_flash != want_flash:
        failures.append("launch counts")

    # phase 6: the train-mode conv kernels
    calls, conv_results = conv_phase(fc, gym)
    failures += [f"fused conv {k}" for k, r in conv_results.items() if not r["ok"]]
    ok_dw, dw_err_kernel, dw_err_plain = dw_float64_check(fc)
    if not ok_dw:
        failures.append("fused conv dw2 against float64")

    # phase 7: the training path
    ok_grads, grad_err = grad_parity_phase(build_trainer, edm2_loss, GYM_LOSS, tiny, fa)
    if not ok_grads:
        failures.append("train gradients, card vs CPU")
    del model
    torch.cuda.empty_cache()
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
                      sp_attention=[dict(kind=k[0], dtype=k[1], sp=k[2], rank=k[3], **v)
                                    for k, v in sp_results.items()],
                      sp_path=[dict(rank=r["rank"], small_losses=r["small"]["losses"],
                                    **{k: v for k, v in r["gym"].items()})
                               for r in sp_ranks])
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
