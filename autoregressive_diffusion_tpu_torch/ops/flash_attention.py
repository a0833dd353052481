"""Flash attention under frame masks: hand-written CUDA kernels and their
plain PyTorch versions.

Prefill (csrc/prefill_attention.cu) replaces the splash-attention prefill
kernels of the JAX package:
  * ops/flash_attention.py::prefill_cache_attention (:201) -- t_new query
    frames over the whole f_total-slot ring KV cache at a static offset,
    the wrapped ring included (PrefillMask, :96-138);
  * ops/flash_attention.py::causal_frame_attention (:184) -- the fresh,
    cacheless prefill: the same computation with offset=0, f_total=t_new.

Training (csrc/flash_attention_fwd.cu, csrc/flash_attention_bwd.cu, under
the torch.autograd.Function _FlashAttention) replaces
  * ops/flash_attention.py::dart_attention (:177) -- block-sparse attention
    over the 2T-frame DART concat (DartMask, :32-67), forward and backward;
  * ops/flash_attention.py::full_attention (:224) -- unmasked attention
    (FullMask), forward and backward.
The forward returns o and the per-row log-sum-exp; the backward recomputes
the softmax from them (FlashAttention-2), so no (S, S) tensor is kept.

All take q pre-scaled by 1/sqrt(d) and cast to the input type (the public
functions scale it, outside the Function, so autograd carries the scale
into dq), compute logits and the softmax in fp32 and write their results
in the input type.

On CUDA tensors a wrapper launches its kernel or raises; the plain versions
run only for CPU tensors (and in chip_smoke.py, as the yardstick the
kernels are held against).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build
from .masks import expand_to_tokens, frame_visible, prefill_frame_mask

# Kernel launches since the last reset (chip_smoke.py zeroes and reads
# them): the prefill kernel, and the training kernels by mask kind (one
# backward count is one call of the backward entry point, whose three
# stages run back to back on one stream).
launches = 0
dart_fwd_launches = 0
dart_bwd_launches = 0
full_fwd_launches = 0
full_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_SIGNATURES = {"ad_prefill_attention": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    ctypes.c_int)}
_FWD_SIGNATURES = {"ad_flash_attention_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int)}
_BWD_SIGNATURES = {"ad_flash_attention_bwd": (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int)}
_KINDS = {"dart": 0, "full": 1}


def prefill_attention_plain(qs, k, v, t_new: int, f_total: int, offset: int,
                            tokens_per_frame: int) -> torch.Tensor:
    """Plain version. qs (b, h, t_new*hw, d) pre-scaled; k/v
    (b, h, f_total*hw, d). fp32 logits and softmax, o in v's type."""
    fmask = prefill_frame_mask(t_new, f_total, offset)
    mask = torch.as_tensor(expand_to_tokens(fmask, tokens_per_frame),
                           device=qs.device)
    logits = torch.einsum("bhqc,bhkc->bhqk", qs.float(), k.float())
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkc->bhqc", p, v.float()).to(v.dtype)


def _launch(qs, k, v, t_new, f_total, offset, hw) -> torch.Tensor:
    global launches
    if not (k.is_cuda and v.is_cuda and k.device == qs.device == v.device):
        raise ValueError("prefill attention: q, k, v must be on one CUDA device")
    if qs.dtype not in _DTYPES or not (qs.dtype == k.dtype == v.dtype):
        raise ValueError(f"prefill attention: dtypes {qs.dtype}, {k.dtype}, "
                         f"{v.dtype}; expected one of float32/bfloat16")
    if qs.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"prefill attention: shapes {tuple(qs.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = qs.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError("prefill attention: q and k/v disagree on b, h, d")
    if sq != t_new * hw or k.shape[2] != f_total * hw:
        raise ValueError(f"prefill attention: Sq={sq}, Sk={k.shape[2]} do not "
                         f"match t_new={t_new}, f_total={f_total}, hw={hw}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"prefill attention: head dim {d} not in {_HEAD_DIMS}")
    if not (0 <= offset and 1 <= t_new):
        raise ValueError(f"prefill attention: offset={offset}, t_new={t_new}")
    if not (qs.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("prefill attention: q, k, v must be contiguous")
    o = torch.empty_like(qs)
    lib = _build.load("prefill_attention", _SIGNATURES)
    err = lib.ad_prefill_attention(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b * h, sq, k.shape[2], d, hw, t_new, f_total, offset,
        _DTYPES[qs.dtype], torch.cuda.current_stream(qs.device).cuda_stream)
    _build.check(lib, err, "prefill attention")
    launches += 1
    return o


def prefill_attention(qs, k, v, t_new: int, f_total: int, offset: int,
                      tokens_per_frame: int) -> torch.Tensor:
    """The kernel's function on pre-scaled q: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if qs.device.type == "cpu":
        return prefill_attention_plain(qs, k, v, t_new, f_total, offset,
                                       tokens_per_frame)
    return _launch(qs, k, v, t_new, f_total, offset, tokens_per_frame)


def _prescale(q):
    return (q * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def causal_frame_attention(q, k, v, n_frames: int, tokens_per_frame: int):
    """Frame-causal prefill attention, no cache. q, k, v: (b, heads, T*hw, d)."""
    return prefill_attention(_prescale(q), k, v, n_frames, n_frames, 0,
                             tokens_per_frame)


def prefill_cache_attention(q, k, v, t_new: int, f_total: int, offset: int,
                            tokens_per_frame: int):
    """Warm-cache prefill: q (b, heads, t_new*hw, d) over the full ring
    k/v (b, heads, f_total*hw, d) holding `offset` earlier frames."""
    return prefill_attention(_prescale(q), k, v, t_new, f_total, offset,
                             tokens_per_frame)


# ---------------------------------------------------------------------------
# Training: DART and full flash attention, forward and backward

@functools.lru_cache(maxsize=32)
def _token_mask_np(kind: str, n_frames: int, hw: int, s: int) -> np.ndarray:
    f = np.arange(s) // hw
    return frame_visible(kind, f[:, None], f[None, :], n_frames)


def _token_mask(kind: str, n_frames: int, hw: int, s: int, device) -> torch.Tensor:
    """(S, S) bool mask of the predicate the kernels evaluate (a copy of
    the cached array, which no caller can then change)."""
    return torch.tensor(_token_mask_np(kind, n_frames, hw, s), device=device)


def flash_attention_fwd_plain(qs, k, v, kind: str, n_frames: int, hw: int):
    """Plain version of the forward kernel. qs (pre-scaled), k, v:
    (..., S, d). Returns (o in v's type, lse fp32 (..., S))."""
    logits = torch.einsum("...qc,...kc->...qk", qs.float(), k.float())
    mask = _token_mask(kind, n_frames, hw, qs.shape[-2], qs.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("...qk,...kc->...qc", p, v.float())
    return o.to(v.dtype), lse


def flash_attention_bwd_plain(qs, k, v, o, lse, do, kind: str, n_frames: int, hw: int):
    """Plain version of the backward kernels, by the explicit formula:
    P = exp(qs k^T - lse) under the mask, delta = rowsum(dO * o),
    dS = P * (dO v^T - delta); dq = dS k, dk = dS^T qs, dv = P^T dO.
    Returns (dq, dk, dv) in the input types."""
    qf, kf, vf, dof = qs.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("...qc,...kc->...qk", qf, kf)
    mask = _token_mask(kind, n_frames, hw, qs.shape[-2], qs.device)
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1)
    dp = torch.einsum("...qc,...kc->...qk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("...qk,...kc->...qc", ds, kf)
    dk = torch.einsum("...qk,...qc->...kc", ds, qf)
    dv = torch.einsum("...qk,...qc->...kc", p, dof)
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_args(kind, n_frames, hw, *tensors):
    """Check the training kernels' arguments; returns (b, h, S, d)."""
    qs = tensors[0]
    if kind not in _KINDS:
        raise ValueError(f"flash attention: unknown mask kind {kind!r}")
    if qs.ndim != 4:
        raise ValueError(f"flash attention: q must be (b, heads, S, d), got {tuple(qs.shape)}")
    if qs.dtype not in _DTYPES:
        raise ValueError(f"flash attention: dtype {qs.dtype} not float32/bfloat16")
    b, h, s, d = qs.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {d} not in {_HEAD_DIMS}")
    if kind == "dart" and s != 2 * n_frames * hw:
        raise ValueError(f"flash attention: S={s} is not 2 * {n_frames} frames * {hw}")
    for t in tensors:
        if not t.is_cuda or t.device != qs.device:
            raise ValueError("flash attention: every tensor must be on q's CUDA device")
        if t.dtype != qs.dtype or t.shape != qs.shape:
            raise ValueError(f"flash attention: {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(qs.shape)} {qs.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash attention: tensors must be contiguous")
    return b, h, s, d


def _launch_fwd(qs, k, v, kind, n_frames, hw):
    global dart_fwd_launches, full_fwd_launches
    b, h, s, d = _flash_args(kind, n_frames, hw, qs, k, v)
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=qs.device)
    lib = _build.load("flash_attention_fwd", _FWD_SIGNATURES)
    err = lib.ad_flash_attention_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, s, d, _KINDS[kind], n_frames, hw, _DTYPES[qs.dtype],
        torch.cuda.current_stream(qs.device).cuda_stream)
    _build.check(lib, err, "flash attention forward")
    if kind == "dart":
        dart_fwd_launches += 1
    else:
        full_fwd_launches += 1
    return o, lse


def _launch_bwd(qs, k, v, o, lse, do, kind, n_frames, hw):
    global dart_bwd_launches, full_bwd_launches
    b, h, s, d = _flash_args(kind, n_frames, hw, qs, k, v, o, do)
    if (lse.device != qs.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, s) or not lse.is_contiguous()):
        raise ValueError(f"flash attention: lse is {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}; expected contiguous {(b, h, s)} float32")
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=qs.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.ad_flash_attention_bwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, s, d, _KINDS[kind], n_frames, hw, _DTYPES[qs.dtype],
        torch.cuda.current_stream(qs.device).cuda_stream)
    _build.check(lib, err, "flash attention backward")
    if kind == "dart":
        dart_bwd_launches += 1
    else:
        full_bwd_launches += 1
    return dq, dk, dv


def flash_attention_fwd(qs, k, v, kind: str, n_frames: int, hw: int):
    """(o, lse) of pre-scaled q: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. kind "dart" (S = 2 * n_frames * hw) or "full"."""
    if qs.device.type == "cpu":
        return flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw)
    return _launch_fwd(qs, k, v, kind, n_frames, hw)


def flash_attention_bwd(qs, k, v, o, lse, do, kind: str, n_frames: int, hw: int):
    """(dq, dk, dv) of pre-scaled q: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors."""
    if qs.device.type == "cpu":
        return flash_attention_bwd_plain(qs, k, v, o, lse, do, kind, n_frames, hw)
    return _launch_bwd(qs, k, v, o, lse, do, kind, n_frames, hw)


class _FlashAttention(torch.autograd.Function):
    """Masked flash attention of pre-scaled q under autograd. The forward
    saves its inputs, o and lse; the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, qs, k, v, kind, n_frames, hw):
        o, lse = flash_attention_fwd(qs, k, v, kind, n_frames, hw)
        ctx.mask = (kind, n_frames, hw)
        ctx.save_for_backward(qs, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(qs, k, v, o, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None


def dart_attention(q, k, v, n_frames: int, tokens_per_frame: int):
    """DART-masked flash attention over the 2T-frame concat, differentiable
    in q, k and v. q, k, v: (b, heads, 2*T*hw, d)."""
    return _FlashAttention.apply(_prescale(q).contiguous(), k.contiguous(), v.contiguous(),
                                 "dart", n_frames, tokens_per_frame)


def full_attention(q, k, v):
    """Unmasked flash attention, differentiable in q, k and v.
    q, k, v: (batch, heads, S, d)."""
    s = q.shape[2]
    return _FlashAttention.apply(_prescale(q).contiguous(), k.contiguous(), v.contiguous(),
                                 "full", 1, s)
