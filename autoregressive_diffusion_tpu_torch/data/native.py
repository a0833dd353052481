"""ctypes bindings for the host-side data-path kernels of native/adx_data.cpp.

Counterpart of autoregressive_diffusion_tpu/data/native.py. The C++ source
is the JAX package's, used unchanged: at first use it is compiled with
`g++ -O3 -march=native -fopenmp -shared -fPIC` into `build/native/` at the
root of the checkout, under a file name that carries a hash of the source
and the flags (as ops/_build.py names the CUDA kernels), and loaded with
ctypes. A failed build raises with the compiler's output: there is no silent
fallback. `_resize_area_numpy` is the plain version the tests hold the
library against.

  resize_area_batch(frames, size, scale, offset) -> float32 (n, dh, dw, c)
  u8_to_pm1(frames)                              -> float32 in [-1, 1]
  pm1_to_u8(frames)                              -> uint8 in [0, 255]

`resize_area_batch` is cv2.INTER_AREA (a fractional box filter) fused with
an affine map of the pixel values.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "adx_data.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libadx_data-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {SOURCE.name}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.adx_resize_area_batch.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float]
            lib.adx_resize_area_batch.restype = None
            lib.adx_u8_to_f32.argtypes = [u8p, ctypes.c_int64, f32p, ctypes.c_float,
                                          ctypes.c_float]
            lib.adx_u8_to_f32.restype = None
            lib.adx_f32_to_u8.argtypes = [f32p, ctypes.c_int64, u8p, ctypes.c_float,
                                          ctypes.c_float]
            lib.adx_f32_to_u8.restype = None
            lib.adx_version.restype = ctypes.c_int
            _lib = lib
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _resize_area_numpy(frames: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The plain version: the fractional-box area resize in NumPy."""
    n, sh, sw, c = frames.shape

    def axis_matrix(src, dst):
        m = np.zeros((dst, src), np.float32)
        scale = src / dst
        for i in range(dst):
            lo, hi = i * scale, (i + 1) * scale
            b, e = int(lo), min(int(np.ceil(hi)), src)
            for j in range(b, e):
                m[i, j] = min(j + 1, hi) - max(j, lo)
            m[i] /= hi - lo
        return m

    x = np.einsum("ys,nswc->nywc", axis_matrix(sh, dh), frames.astype(np.float32))
    return np.einsum("xs,nysc->nyxc", axis_matrix(sw, dw), x)


def resize_area_batch(frames: np.ndarray, size, scale: float = 1.0,
                      offset: float = 0.0) -> np.ndarray:
    """INTER_AREA resize of (n, h, w, c) uint8 frames to (n, dh, dw, c)
    float32, fused with x * scale + offset."""
    frames = np.ascontiguousarray(frames)
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (n, h, w, c) uint8, not {frames.dtype} "
                         f"{frames.shape}")
    dh, dw = (size, size) if isinstance(size, int) else size
    n, sh, sw, c = frames.shape
    out = np.empty((n, dh, dw, c), np.float32)
    get_lib().adx_resize_area_batch(_u8p(frames), n, sh, sw, c, _f32p(out), dh, dw,
                                    scale, offset)
    return out


def u8_to_pm1(frames: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (frames / 127.5 - 1)."""
    frames = np.ascontiguousarray(frames)
    if frames.dtype != np.uint8:
        raise ValueError(f"frames must be uint8, not {frames.dtype}")
    out = np.empty(frames.shape, np.float32)
    get_lib().adx_u8_to_f32(_u8p(frames), frames.size, _f32p(out),
                            np.float32(1.0 / 127.5), np.float32(-1.0))
    return out


def pm1_to_u8(frames: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> uint8 [0, 255], clamped and rounded."""
    frames = np.ascontiguousarray(frames, np.float32)
    out = np.empty(frames.shape, np.uint8)
    get_lib().adx_f32_to_u8(_f32p(frames), frames.size, _u8p(out), np.float32(127.5),
                            np.float32(127.5))
    return out
