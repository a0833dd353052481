"""Debug and inspection helpers.

Counterpart of autoregressive_diffusion_tpu/utils/misc.py over the port's
tensors and dicts:
  * `EasyDict`, `assert_shape`, `tile_images` (rollout tiling);
  * `find_nonfinite`: the NaN/Inf scan over a state dict (parameters,
    gradients, optimizer moments) or any nested dict of tensors, in place of
    the JAX pytree scan;
  * `nan_guard`: an eager tripwire (the JAX one prints from compiled code;
    here it reads the flag on the host, which waits for the device);
  * `compare_caches`: the tolerant recursive comparison of two of the
    port's cache dicts (models/cache.py; the frame counter is a host int).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch


class EasyDict(dict):
    """Attribute-access dict."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert x.shape matches ref_shape; None entries are wildcards."""
    if x.ndim != len(ref_shape):
        raise AssertionError(
            f"Wrong number of dimensions: got {x.ndim}, expected {len(ref_shape)}")
    for i, (size, ref) in enumerate(zip(x.shape, ref_shape)):
        if ref is not None and size != ref:
            raise AssertionError(f"Wrong size for dimension {i}: got {size}, expected {ref}")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def tile_images(images, grid_w: Optional[int] = None,
                grid_h: Optional[int] = None) -> np.ndarray:
    """(N, H, W, C) -> (grid_h*H, grid_w*W, C) tiled image."""
    images = _numpy(images)
    n, h, w = images.shape[:3]
    if grid_w is None:
        grid_w = int(np.ceil(np.sqrt(n))) if grid_h is None else -(-n // grid_h)
    if grid_h is None:
        grid_h = -(-n // grid_w)
    pad = grid_w * grid_h - n
    if pad:
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    return (images.reshape(grid_h, grid_w, *images.shape[1:])
            .swapaxes(1, 2)
            .reshape(grid_h * h, grid_w * w, *images.shape[3:]))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}.{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def find_nonfinite(tree: Any, prefix: str = "") -> List[str]:
    """The entries of a state dict (or a nested dict or list of tensors)
    that hold NaN or Inf, as 'name: n/size non-finite' lines."""
    bad = []
    for name, leaf in _leaves(tree, prefix):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            continue
        finite = torch.isfinite(leaf)
        if not bool(finite.all()):
            n_bad = int((~finite).sum())
            bad.append(f"{name}: {n_bad}/{leaf.numel()} non-finite")
    return bad


def nan_guard(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Prints whether x holds a non-finite value; returns x unchanged."""
    bad = not bool(torch.isfinite(x).all())
    print(f"NaN-guard [{name}]: non_finite={bad}")
    return x


def compare_caches(a: Any, b: Any, rtol: float = 1e-4, atol: float = 1e-4,
                   _path: str = "") -> List[str]:
    """Recursively compare two cache dicts; the mismatches as readable
    lines (empty when they agree)."""
    diffs: List[str] = []
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                diffs.append(f"{_path}/{k}: present in only one cache")
            else:
                diffs += compare_caches(a[k], b[k], rtol, atol, f"{_path}/{k}")
        return diffs
    if a is None and b is None:
        return diffs
    if (a is None) != (b is None):
        return [f"{_path}: one side is None"]
    av, bv = _numpy(a), _numpy(b)
    if av.shape != bv.shape:
        return [f"{_path}: shape {av.shape} vs {bv.shape}"]
    if av.dtype.kind == "f":
        if not np.allclose(av, bv, rtol=rtol, atol=atol):
            err = float(np.abs(av - bv).max())
            diffs.append(f"{_path}: max abs diff {err:.3e}")
    elif not np.array_equal(av, bv):
        diffs.append(f"{_path}: values differ")
    return diffs
