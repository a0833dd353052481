"""Make the offline-calibrated AlexNet-LPIPS params.

    python -m autoregressive_diffusion_tpu_torch.calibrate_lpips --out FILE.npz
        [--device cpu|cuda]

Counterpart of tools/calibrate_lpips.py. The trained LPIPS weights cannot be
fetched, so this makes the closest offline stand-in from fixed seeds:
  * the backbone: the pip-lpips AlexNet architecture
    (train/perceptual.py::_ALEX_SLICES) with He-init weights from a numpy
    seed and a bias of 0.05, so that half of each ReLU layer is alive;
  * the heads: the five 1x1 heads are set so that every feature layer
    contributes equally, on average, over a synthetic corpus (smoothed
    fields with sprites) under four distortion families (noise, blur, shift,
    contrast) at three strengths. Under log(lpips + eps) the global scale
    has no gradient, so the per-layer weighting is all there is to set.
Before writing, it checks that the calibrated layers contribute equally
within 1%, and that the distance grows with the distortion's strength in
every family (strictly from the first strength to the second; not falling
more than 10% from the second to the third); either failure raises.

perceptual_loss takes the file when it is saved_models/lpips_alex_calibrated.npz
(train/perceptual.py::CALIBRATED_NPZ); that file is not in the repository,
and --out has no default, so nothing writes it unasked.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .train.perceptual import _ALEX_SLICES, alexnet_lpips_distance, lpips_params_to
from .utils.device import resolve_device

_ALEX_KERNELS = [(11, 3, 64), (5, 64, 192), (3, 192, 384), (3, 384, 256), (3, 256, 256)]
FAMILIES = ("noise", "blur", "shift", "contrast")
STRENGTHS = (0.33, 0.66, 1.0)


def he_backbone(seed: int = 0):
    """Fixed-seed He-init AlexNet backbone params: [(w HWIO, b)] * 5."""
    rng = np.random.default_rng(seed)
    convs = []
    for k, cin, cout in _ALEX_KERNELS:
        std = np.sqrt(2.0 / (k * k * cin))
        convs.append((rng.normal(0, std, (k, k, cin, cout)).astype(np.float32),
                      np.full((cout,), 0.05, np.float32)))
    return convs


def corpus(n: int = 16, size: int = 64, seed: int = 1) -> np.ndarray:
    """(n, size, size, 3) images in [-1, 1]: smoothed random fields with
    hard-edged round sprites."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, size, size, 3), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        field = rng.normal(0, 1, (size, size, 3))
        for _ in range(3):  # box smoothing
            field = (field + np.roll(field, 1, 0) + np.roll(field, -1, 0)
                     + np.roll(field, 1, 1) + np.roll(field, -1, 1)) / 5
        field /= np.abs(field).max() + 1e-6
        for _ in range(3):  # sprites
            cy, cx = rng.integers(8, size - 8, 2)
            r = rng.integers(3, 8)
            field[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(-1, 1, 3)
        imgs[i] = field
    return imgs


def distort(x: np.ndarray, family: str, strength: float, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if family == "noise":
        return np.clip(x + rng.normal(0, 0.25 * strength, x.shape), -1, 1)
    if family == "blur":
        y = x.copy()
        for _ in range(max(1, int(4 * strength))):
            y = (y + np.roll(y, 1, 1) + np.roll(y, -1, 1) + np.roll(y, 1, 2)
                 + np.roll(y, -1, 2)) / 5
        return x + (y - x) * min(1.0, strength)
    if family == "shift":
        return np.roll(x, max(1, round(3 * strength)), axis=2)
    if family == "contrast":
        return np.clip(x * (1.0 - 0.6 * strength), -1, 1)
    raise ValueError(family)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@torch.no_grad()
def layer_diffs(x, y, convs, device="cpu") -> list:
    """Per layer, the (n,) mean normalized-feature squared difference that
    its head weighs: the distance with that layer's head at 1/c and the
    others at 0."""
    out = []
    for i in range(5):
        sel = [np.zeros((s[1],), np.float32) for s in _ALEX_SLICES]
        sel[i] = np.full((_ALEX_SLICES[i][1],), 1 / _ALEX_SLICES[i][1], np.float32)
        params = lpips_params_to({"convs": convs, "lins": sel}, device)
        out.append(alexnet_lpips_distance(_tensor(x, device), _tensor(y, device),
                                          params).cpu().numpy())
    return out


def contributions(imgs, convs, device="cpu") -> np.ndarray:
    """(5,) sums over the distortion corpus of each layer's mean diff."""
    contrib = np.zeros(5)
    for fam in FAMILIES:
        for s in STRENGTHS:
            for i, v in enumerate(layer_diffs(imgs, distort(imgs, fam, s), convs, device)):
                contrib[i] += v.mean()
    return contrib


def calibrate(convs, imgs, device="cpu"):
    """(params, per-layer scales): heads of c entries scale_i / c with
    scale_i = mean(contrib) / contrib_i."""
    contrib = contributions(imgs, convs, device)
    scales = contrib.mean() / np.maximum(contrib, 1e-12)
    lins = [np.full((_ALEX_SLICES[i][1],), scales[i] / _ALEX_SLICES[i][1], np.float32)
            for i in range(5)]
    return {"convs": convs, "lins": lins}, scales


@torch.no_grad()
def check(params, scales, imgs, device="cpu") -> dict:
    """The two checks: equal contributions within 1% after the calibration,
    and distances growing with the strength in every family. Returns
    {"contribution": (5,) relative, family: [distance at each strength]};
    raises ValueError on a failure."""
    post = scales * contributions(imgs, params["convs"], device)
    rel = post / post.mean()
    if not np.all(np.abs(rel - 1) < 0.01):
        raise ValueError(f"calibrated layers do not contribute equally: {rel}")
    result = {"contribution": rel}
    on_dev = lpips_params_to(params, device)
    x = _tensor(imgs, device)
    for fam in FAMILIES:
        ds = [float(alexnet_lpips_distance(x, _tensor(distort(imgs, fam, s), device),
                                           on_dev).mean()) for s in STRENGTHS]
        # strictly increasing at low strength; saturation (no fall beyond
        # 10%) allowed at the top, as trained LPIPS saturates too
        if not (ds[0] < ds[1] and ds[2] > 0.9 * ds[1] and ds[0] > 1e-5):
            raise ValueError(f"{fam}: distances not monotone in strength: {ds}")
        result[fam] = ds
    return result


def write_params(path: str, params: dict) -> None:
    """The npz calibrated_lpips_params reads: conv{i}_w, conv{i}_b, lin{i}."""
    arrays = {}
    for i, (w, b) in enumerate(params["convs"]):
        arrays[f"conv{i}_w"], arrays[f"conv{i}_b"] = w, b
    for i, lin in enumerate(params["lins"]):
        arrays[f"lin{i}"] = lin
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the .npz to write")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    imgs = corpus()
    params, scales = calibrate(he_backbone(), imgs, dev)
    result = check(params, scales, imgs, dev)
    print("per-layer contribution (want ~1):", np.round(result["contribution"], 4))
    for fam in FAMILIES:
        print(f"{fam:9s} distances vs strength: " + " ".join(f"{v:.4f}" for v in result[fam]))
    write_params(args.out, params)
    print(f"wrote {os.path.abspath(args.out)} ({os.path.getsize(args.out) / 1e6:.2f} MB)")
    return params


if __name__ == "__main__":
    main()
