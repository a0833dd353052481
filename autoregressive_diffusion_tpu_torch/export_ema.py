"""Export the EMA weights of a train-state checkpoint as a model bundle.

    python -m autoregressive_diffusion_tpu_torch.export_ema --ckpt-dir D \\
        --cfg D/unet_46M.ad [--step N] [--ema 0] [--dtype bfloat16] [--out DIR]

Counterpart of scripts/export_ema.py: rebuilds the train state of the
bundle's config, restores a checkpoint of gym_train (the newest unless
--step) and writes one EMA copy (0: std 0.050, 1: std 0.100) with the
bundle's kwargs and buffers as unet_{n}M_ema{std:.3f}_step{step}[_dtype].ad,
which `generate --unet` and utils/bridge.from_bundle read. bfloat16 leaves
are rounded to nearest even, as the JAX package's astype rounds them, and
written as bfloat16 bits. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np
import torch

from .models import Precond, UNetConfig
from .train import create_train_state, make_optimizer
from .utils.bridge import _config_kwargs, _nest, load_jax_variables
from .utils.checkpoint import (BFloat16Leaf, latest_step, load_model, restore_train_state,
                               save_model)
from .utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def leaf(t: torch.Tensor, dtype: str):
    """One exported leaf: fp32 as it is, fp16 by numpy's cast, bf16 rounded
    to nearest even by torch and kept as its bits."""
    t = t.detach().float().cpu()
    if dtype == "bfloat16":
        return BFloat16Leaf(t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16))
    return t.numpy().astype(dtype)


def export(ckpt_dir, cfg_bundle, step=None, ema: int = 0, out=None, dtype="float32",
           device="cuda") -> Path:
    """Write the bundle of EMA copy `ema` of checkpoint `step`; its path."""
    dev = resolve_device(device)
    kwargs, variables = load_model(cfg_bundle)
    model = Precond(UNetConfig(**_config_kwargs(kwargs)), sigma_data=1.0,
                    body_dtype=torch.bfloat16)
    load_jax_variables(model, variables)
    state = create_train_state(model.to(dev), make_optimizer(1e-3, grad_clip=0.1))
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    state, _ = restore_train_state(ckpt_dir, step, state)
    std = state.ema_stds[ema]
    tree = state.ema[ema]
    n = sum(t.numel() for t in tree.values())
    suffix = "" if dtype == "float32" else f"_{dtype}"
    path = Path(out or ckpt_dir) / f"unet_{n // 10 ** 6}M_ema{std:.3f}_step{step}{suffix}.ad"
    save_model(path, dict(kwargs),
               {"params": _nest((name, leaf(t, dtype)) for name, t in tree.items()),
                "buffers": variables["buffers"]})
    print(f"# wrote {path} (EMA std {std}, step {step})")
    return path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True, help="train-state checkpoint directory")
    ap.add_argument("--cfg", required=True,
                    help="model bundle whose kwargs and buffers to reuse (the run's "
                         "unet_{n}M.ad)")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--ema", type=int, default=0, help="EMA index (0: std 0.050, 1: 0.100)")
    ap.add_argument("--out", default=None, help="output directory (default: --ckpt-dir)")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                    help="parameter type in the bundle")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    path = export(args.ckpt_dir, args.cfg, args.step, args.ema, args.out, args.dtype,
                  args.device)
    print(f"# export took {time.perf_counter() - t0:.2f} s, {os.path.getsize(path) / 2 ** 20:.1f} MB")
    return path


if __name__ == "__main__":
    main()
