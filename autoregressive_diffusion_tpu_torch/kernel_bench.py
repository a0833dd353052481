"""Time the train-mode fused gated conv kernels shape by shape on the card.

    python -m autoregressive_diffusion_tpu_torch.kernel_bench [--csv out.csv]
        [--iters 10] [--batch 8] [--frames 8] [--device cuda] [--config gym|tiny]

Counterpart of tools/kernel_bench.py (bf16, as it is). The port sends every
causal conv to the fused kernels (rows 1 and 2 of PERF.md's kernel table;
no channel gate), so the shapes are every distinct train-mode conv of the
gym configuration (the 46M model, 64x64x8 latents) in a DART step at batch
8, T = 8 (2T frames of the clean/noisy concat), as ops/fused_conv.conv_calls
lists them. For each it times, in device time (utils/profiling.device_ms:
the calls queued behind a sleeping kernel, so the host's launch cost is not
counted; it raises where the queue fills before the sleep ends), the
kernel's forward and backward entry points, each on its own, then cuDNN's
unfused path (utils/roofline.unfused_cudnn_conv, the yardstick; the port
never calls it) forward and backward (autograd over a kept graph), and
prints forward and forward + backward (the sum) beside the bound of each
(utils/roofline.conv_cost at the H100's peaks) and the kernel's share of
it. It prints the card's name and power limit first, a summed line, and a
JSON line last; --csv writes one row per shape and path. On --device cpu
the wrapper runs the plain version and the times are host times a call.
chip_smoke.py's conv phase times its shapes through conv_timers too.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .generate import GYM_CONFIG
from .models import UNetConfig
from .ops import fused_conv as fc
from .utils.device import card_line, resolve_device
from .utils.profiling import device_ms
from .utils.roofline import PEAK_FLOPS, bound, conv_cost, unfused_cudnn_conv

DTYPE = torch.bfloat16  # the training body's type, as in tools/kernel_bench.py


def host_ms(fn, iters=30, warmup=1) -> float:
    """Host time a call (the CPU, where there are no device times)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def conv_timers(args, gout, silu, with_ctx, paths=("kernel", "cudnn")) -> dict:
    """{f"{path}_{fwd|bwd}": fn} of one conv call's timed calls, for each
    path of `paths`: "kernel" the wrapper's launches (on the card its
    forward the training forward, which also writes the diff residual its
    backward reads, and its backward the backward entry point,
    ops/fused_conv._launch_conv_fwd, _launch_conv_bwd; on the CPU the plain
    version), "cudnn" the unfused cuDNN path (unfused_cudnn_conv of
    utils/roofline), "plain" the plain version. A backward other than the
    kernel's is autograd over a graph kept from one forward."""
    leaves = [None if a is None else a.detach().requires_grad_(True) for a in args]
    need = [l for l in leaves if l is not None]

    def fwd(fn):
        def run():
            with torch.no_grad():
                return fn(*args, silu, with_ctx)
        return run

    def graph_bwd(fn):
        out = fn(*leaves, silu, with_ctx)
        return lambda: torch.autograd.grad(out, need, gout, retain_graph=True)

    fns = {}
    for path in paths:
        if path == "kernel" and args[0].is_cuda:
            out, diff = fc._launch_conv_fwd(*args, silu, with_ctx, True)
            fns["kernel_fwd"] = lambda: fc._launch_conv_fwd(*args, silu, with_ctx, True)
            fns["kernel_bwd"] = lambda: fc._launch_conv_bwd(*args, gout, diff, out, silu,
                                                            with_ctx, True)
            continue
        fn = {"kernel": fc.fused_gated_conv, "cudnn": unfused_cudnn_conv,
              "plain": fc.fused_gated_conv_plain}[path]
        fns[f"{path}_fwd"], fns[f"{path}_bwd"] = fwd(fn), graph_bwd(fn)
    return fns


def bench_shape(shape, b, t, device, iters, seed):
    """Times (ms) and bounds of one DART conv shape: the kernel and the
    unfused cuDNN path (conv_timers), forward and forward + backward (the
    sum of the two), device times on the card (utils/profiling.device_ms),
    host times on the CPU."""
    h, c, co, silu, has_cv = shape
    f = 2 * t
    args, gout = fc.conv_inputs(b, f, h, h, c, co, has_cv, True, DTYPE, device, seed)
    timer = device_ms if device.type == "cuda" else host_ms
    row = {f"{k}_ms": timer(fn, iters) for k, fn in conv_timers(args, gout, silu, True).items()}
    (ff, fb), (bf, bb) = conv_cost(b, f, h, h, c, co, has_cv, True, DTYPE)
    row.update(bound_fwd_ms=bound(ff, fb, DTYPE)[0], bound_fwd_by=bound(ff, fb, DTYPE)[1],
               bound_fwd_bwd_ms=bound(ff + bf, fb + bb, DTYPE)[0],
               bound_fwd_bwd_by=bound(ff + bf, fb + bb, DTYPE)[1],
               flops_fwd=ff, flops_fwd_bwd=ff + bf)
    row["kernel_fwd_bwd_ms"] = row["kernel_fwd_ms"] + row["kernel_bwd_ms"]
    row["cudnn_fwd_bwd_ms"] = row["cudnn_fwd_ms"] + row["cudnn_bwd_ms"]
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", default=None)
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls a measurement (their launches queue behind one sleep)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8, help="latent frames T (2T in the concat)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=("gym", "tiny"), default="gym",
                    help="gym: the full-width model's convs; tiny: a few layers, for the CPU")
    args = ap.parse_args(argv)
    from .train.cli import TINY_CONFIG

    dev = resolve_device(args.device)
    print(f"# card: {card_line(dev)}", flush=True)
    cfg = UNetConfig(**{**GYM_CONFIG, **(TINY_CONFIG if args.config == "tiny" else {})})
    calls = fc.conv_calls(cfg)
    shapes = sorted(set(s for _, s in calls), key=lambda s: (-s[0], s[1], s[2], s[3], s[4]))
    unit = "device ms" if dev.type == "cuda" else "host ms (the plain version)"
    print(f"# {len(shapes)} distinct DART conv shapes of the {args.config} model's {len(calls)} "
          f"causal convs, batch {args.batch}, T={args.frames} ({2 * args.frames} frames), "
          f"bf16; {unit}, {args.iters} calls each; bound at the H100's peaks",
          flush=True)
    rows = []
    for i, shape in enumerate(shapes):
        r = bench_shape(shape, args.batch, args.frames, dev, args.iters, seed=100 + i)
        h, c, co, silu, has_cv = shape
        r.update(H=h, C=c, Co=co, silu_in=silu, has_cvec=has_cv,
                 calls_a_step=sum(s == shape for _, s in calls))
        rows.append(r)
        tf = r["flops_fwd_bwd"] / r["kernel_fwd_bwd_ms"] / 1e9
        print(f"{h:2d}x{h:<2d} {c:3d}->{co:3d} silu={int(silu)} cv={int(has_cv)} "
              f"x{r['calls_a_step']}: kernel fwd {r['kernel_fwd_ms']:.4f} f+b "
              f"{r['kernel_fwd_bwd_ms']:.4f} | cudnn fwd {r['cudnn_fwd_ms']:.4f} f+b "
              f"{r['cudnn_fwd_bwd_ms']:.4f} | bound fwd {r['bound_fwd_ms']:.4f} "
              f"({r['bound_fwd_by']}) f+b {r['bound_fwd_bwd_ms']:.4f} "
              f"({r['bound_fwd_bwd_by']}) | kernel f+b {tf:.2f} TF/s, "
              f"{100 * r['bound_fwd_bwd_ms'] / r['kernel_fwd_bwd_ms']:.1f}% of the bound, "
              f"{100 * tf * 1e12 / PEAK_FLOPS[DTYPE]:.1f}% of the peak", flush=True)
    keys = ("kernel_fwd_ms", "kernel_bwd_ms", "kernel_fwd_bwd_ms", "cudnn_fwd_ms",
            "cudnn_bwd_ms", "cudnn_fwd_bwd_ms", "bound_fwd_ms", "bound_fwd_bwd_ms")
    step = {k: sum(r[k] * r["calls_a_step"] for r in rows) for k in keys}
    print("# a DART step's convs (each shape times its calls): " + ", ".join(
        f"{k.removesuffix('_ms')} {v:.3f}" for k, v in step.items()) + f" ({unit})")
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("shape,path,pass,ms,bound_ms,tflops,pct_bound\n")
            for r in rows:
                name = f"{r['H']}x{r['H']} {r['C']}->{r['Co']} silu={int(r['silu_in'])} " \
                       f"cv={int(r['has_cvec'])}"
                for path in ("kernel", "cudnn"):
                    for which, flops in (("fwd", r["flops_fwd"]),
                                         ("fwd_bwd", r["flops_fwd_bwd"])):
                        ms, bnd = r[f"{path}_{which}_ms"], r[f"bound_{which}_ms"]
                        fh.write(f"{name},{path},{which},{ms},{bnd},{flops / ms / 1e9},"
                                 f"{100 * bnd / ms}\n")
        print(f"# wrote {args.csv}")
    summary = dict(card=card_line(dev), config=args.config,
                   batch=args.batch, frames=args.frames, timer=unit, shapes=rows, step=step)
    print(json.dumps({"kernel_bench": dict(step=step, shapes=len(rows), timer=unit)}))
    return summary


if __name__ == "__main__":
    main()
