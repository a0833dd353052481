"""Perceptual losses for VAE training: AlexNet-LPIPS and a random-feature
stand-in (PyTorch).

Counterpart of autoregressive_diffusion_tpu/train/perceptual.py:
  * `alexnet_lpips_distance` / `alexnet_lpips_loss`: the architecture of
    pip-lpips `LPIPS(net='alex', spatial=False)` -- the scaling layer, the
    five torchvision-AlexNet feature slices (max-pool 3/2 VALID before the
    second and third), channel-unit-normalized feature differences, the
    1x1 linear heads and the spatial mean. Its params come from torch state
    dicts (`lpips_params_from_torch`, `load_lpips_params`: the files named
    in AD_TPU_LPIPS_WEIGHTS) or from the offline calibration
    (`calibrated_lpips_params`: saved_models/lpips_alex_calibrated.npz,
    written by `calibrate_lpips`). Neither the trained weights nor the
    calibrated file are in the repository.
  * `random_feature_perceptual_loss`: the distance in the features of a
    fixed random multi-scale conv net (filters from a numpy seed), with the
    reference's log(distance + eps) compression.
  * `perceptual_loss`: what the VAE training scripts call, in the JAX
    package's order: trained LPIPS when AD_TPU_LPIPS_WEIGHTS is set, the
    calibrated LPIPS for RGB when its file exists (and
    AD_TPU_LPIPS_CALIBRATED is not "0"), the random features otherwise.

Images are channels-last (n, h, w, c) and videos (b, t, h, w, c), in
[-1, 1]; the layers permute to channels-first only around F.conv2d and the
max-pool. Params are {"convs": [(w HWIO, b)] * 5, "lins": [(c,)] * 5} of
numpy arrays or tensors; they are moved to the input's device per call
(`lpips_params_to` moves them once).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CALIBRATED_NPZ = os.path.join(ROOT, "saved_models", "lpips_alex_calibrated.npz")


@functools.lru_cache(maxsize=4)
def _random_filters(seed: int, in_ch: int, widths=(32, 64, 64)):
    """The random net's 3x3 HWIO filters, each output filter unit-norm."""
    rng = np.random.default_rng(seed)
    filters = []
    c = in_ch
    for w in widths:
        f = rng.normal(size=(3, 3, c, w)).astype(np.float32)
        f /= np.sqrt((f ** 2).sum(axis=(0, 1, 2), keepdims=True)) + 1e-8
        filters.append(f)
        c = w
    return tuple(filters)


def _conv(x: torch.Tensor, w_hwio, b=None, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """F.conv2d on channels-last x with an HWIO kernel."""
    w = torch.as_tensor(w_hwio, dtype=x.dtype, device=x.device).permute(3, 2, 0, 1)
    if b is not None:
        b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _features(x: torch.Tensor, filters) -> list:
    """The random net's three stride-2 layers, leaky ReLU 0.2, each layer's
    features unit-normalized over channels."""
    feats = []
    for f in filters:
        x = F.leaky_relu(_conv(x, f, stride=2, padding=1), 0.2)
        feats.append(x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8))
    return feats


def _frames(v: torch.Tensor) -> torch.Tensor:
    """(b, t, h, w, c) clipped to [-1, 1] as (b*t, h, w, c)."""
    return torch.clamp(v, -1, 1).reshape((-1,) + tuple(v.shape[2:]))


def random_feature_perceptual_loss(recon: torch.Tensor, frames: torch.Tensor, seed: int = 0,
                                   log_compress: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """recon, frames: (b, t, h, w, c) in [-1, 1]. The per-frame distance in
    the random net's features, log-compressed and averaged over frames."""
    filters = _random_filters(seed, frames.shape[-1])
    fx, fy = _features(_frames(recon), filters), _features(_frames(frames), filters)
    per_frame = sum(torch.mean((a - b) ** 2, dim=(1, 2, 3)) for a, b in zip(fx, fy))
    if log_compress:
        return torch.mean(torch.log(per_frame + eps))
    return torch.mean(per_frame)


# The five torchvision-AlexNet feature slices LPIPS taps: (max-pool 3/2
# before, out channels, kernel, stride, padding).
_ALEX_SLICES = (
    (False, 64, 11, 4, 2),
    (True, 192, 5, 1, 2),
    (True, 384, 3, 1, 1),
    (False, 256, 3, 1, 1),
    (False, 256, 3, 1, 1),
)
# LPIPS ScalingLayer: inputs in [-1, 1] to ImageNet-like statistics.
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def lpips_params_to(params: dict, device, dtype=torch.float32) -> dict:
    """The LPIPS params as tensors on `device` (one copy, for repeated
    calls)."""
    def t(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, dtype=dtype,
                               device=device)
    return {"convs": [(t(w), t(b)) for w, b in params["convs"]],
            "lins": [t(lin) for lin in params["lins"]]}


def alexnet_lpips_distance(x: torch.Tensor, y: torch.Tensor, params: dict,
                           eps: float = 1e-10) -> torch.Tensor:
    """The pip-lpips `LPIPS(net='alex')` forward. x, y: (n, h, w, 3) in
    [-1, 1]; returns the (n,) distances."""
    shift = torch.as_tensor(LPIPS_SHIFT, device=x.device, dtype=x.dtype)
    scale = torch.as_tensor(LPIPS_SCALE, device=x.device, dtype=x.dtype)

    def backbone(v):
        v = (v - shift) / scale
        feats = []
        for (pool, _, _, s, p), (w, b) in zip(_ALEX_SLICES, params["convs"]):
            if pool:
                v = F.max_pool2d(v.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
            v = F.relu(_conv(v, w, b, stride=s, padding=p))
            feats.append(v)
        return feats

    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for lin, a, b in zip(params["lins"], backbone(x), backbone(y)):
        # lpips normalize_tensor: v / (||v||_channels + eps)
        na = a / (torch.sqrt(torch.sum(a * a, -1, keepdim=True)) + eps)
        nb = b / (torch.sqrt(torch.sum(b * b, -1, keepdim=True)) + eps)
        lin = torch.as_tensor(lin, dtype=x.dtype, device=x.device)
        # NetLinLayer: a 1x1 conv to one channel, no bias; then the spatial mean
        total = total + torch.mean((na - nb) ** 2 @ lin, dim=(1, 2))
    return total


def alexnet_lpips_loss(recon: torch.Tensor, frames: torch.Tensor, params: dict,
                       log_compress: bool = True, eps: float = 1e-8) -> torch.Tensor:
    """(b, t, h, w, 3) in [-1, 1] -> the mean over frames of
    log(lpips + eps), the reference's reduction."""
    per_frame = alexnet_lpips_distance(_frames(recon), _frames(frames), params)
    if log_compress:
        return torch.mean(torch.log(per_frame + eps))
    return torch.mean(per_frame)


_ALEX_CONV_SHAPES = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                     (256, 384, 3, 3), (256, 256, 3, 3)]


def _numpy(val) -> np.ndarray:
    return np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val,
                      dtype=np.float32)


def lpips_params_from_torch(*state_dicts) -> dict:
    """`alexnet_lpips_distance` params from torch state dict(s): any mix of
    a torchvision AlexNet state dict (features.{0,3,6,8,10}.weight/bias), a
    pip-lpips dump (net.slice{k}.{j}.weight, lin{k}.model.1.weight) and the
    lpips v0.1 heads-only file. Tensors are found by shape -- conv weights
    by their five distinct shapes, heads as (1, c, 1, 1), the two
    256-channel heads in state-dict order -- so key prefixes do not matter.
    Raises ValueError when a piece is missing."""
    convs: dict = {}
    lins: dict = {}
    lin_chans = [s[0] for s in _ALEX_CONV_SHAPES]
    for sd in state_dicts:
        for key, val in sd.items():
            arr = _numpy(val)
            if arr.ndim != 4:
                continue
            shape = tuple(arr.shape)
            if shape[0] == 1 and shape[2:] == (1, 1) and shape[1] in lin_chans:
                idx = lin_chans.index(shape[1])
                while idx in lins and idx + 1 < 5 and lin_chans[idx + 1] == shape[1]:
                    idx += 1
                lins[idx] = arr[0, :, 0, 0]
            elif shape in _ALEX_CONV_SHAPES:
                idx = _ALEX_CONV_SHAPES.index(shape)
                bias_key = key[:-len("weight")] + "bias"
                bias = sd.get(bias_key)
                if bias is None:
                    raise ValueError(f"conv weight {key} has no bias {bias_key}")
                convs[idx] = (arr.transpose(2, 3, 1, 0), _numpy(bias))  # OIHW -> HWIO
    if sorted(convs) != [0, 1, 2, 3, 4]:
        raise ValueError(f"missing AlexNet convs: have {sorted(convs)}")
    if sorted(lins) != [0, 1, 2, 3, 4]:
        raise ValueError(f"missing LPIPS linear heads: have {sorted(lins)}")
    return {"convs": [convs[i] for i in range(5)], "lins": [lins[i] for i in range(5)]}


@functools.lru_cache(maxsize=2)
def load_lpips_params(paths: tuple) -> dict:
    """The params of torch checkpoint files (AD_TPU_LPIPS_WEIGHTS, comma
    joined, e.g. 'alexnet.pth,lpips_alex_v0.1.pth')."""
    return lpips_params_from_torch(*(torch.load(p, map_location="cpu", weights_only=True)
                                     for p in paths))


@functools.lru_cache(maxsize=1)
def calibrated_lpips_params(path: str = "") -> dict:
    """The offline-calibrated params (calibrate_lpips): the LPIPS
    architecture on a fixed-seed He-init backbone, its heads weighted so
    that every layer contributes equally on a synthetic distortion
    corpus."""
    with np.load(path or CALIBRATED_NPZ) as z:
        return {"convs": [(z[f"conv{i}_w"], z[f"conv{i}_b"]) for i in range(5)],
                "lins": [z[f"lin{i}"] for i in range(5)]}


@functools.lru_cache(maxsize=4)
def _params_on(source, device: str) -> dict:
    params = (load_lpips_params(source) if isinstance(source, tuple)
              else calibrated_lpips_params())
    return lpips_params_to(params, device)


def perceptual_kind(channels: int) -> str:
    """Which perceptual loss perceptual_loss takes for frames of `channels`
    channels: "lpips" (trained weights), "calibrated" or "random-feature"."""
    if os.environ.get("AD_TPU_LPIPS_WEIGHTS", ""):
        return "lpips"
    if (channels == 3 and os.path.exists(CALIBRATED_NPZ)
            and os.environ.get("AD_TPU_LPIPS_CALIBRATED", "1") != "0"):
        return "calibrated"
    return "random-feature"


def perceptual_loss(recon: torch.Tensor, frames: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """What the VAE training scripts call, in this order: (1) AlexNet-LPIPS
    with the trained weights in AD_TPU_LPIPS_WEIGHTS; (2) the calibrated
    AlexNet-LPIPS for RGB frames, when saved_models/lpips_alex_calibrated.npz
    exists and AD_TPU_LPIPS_CALIBRATED is not "0"; (3) the random-feature
    loss."""
    kind = perceptual_kind(frames.shape[-1])
    if kind == "lpips":
        paths = tuple(p for p in os.environ["AD_TPU_LPIPS_WEIGHTS"].split(",") if p)
        return alexnet_lpips_loss(recon, frames, _params_on(paths, str(frames.device)))
    if kind == "calibrated":
        return alexnet_lpips_loss(recon, frames, _params_on("calibrated", str(frames.device)))
    return random_feature_perceptual_loss(recon, frames, seed=seed)
