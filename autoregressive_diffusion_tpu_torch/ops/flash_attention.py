"""Flash attention under frame masks: hand-written CUDA kernels and their
plain PyTorch versions.

Prefill replaces the splash-attention prefill kernels of the JAX package
(bf16: the tensor-core flash forward of csrc/flash_attention_fwd.cu under
the ring mask, entry point ad_flash_attention_ring_fwd; fp32: the SIMT
kernel of csrc/prefill_attention.cu):
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

Sequence parallel (the same two kernels through their entry points
ad_flash_attention_sp_fwd / _sp_bwd, under the same Function) replaces
  * ops/flash_attention.py::dart_attention_sp (:326) and
    ::causal_frame_attention_sp (:336) -- splash with q_seq_shards = sp
    (:286-323): each rank of a `seq` process group keeps its query rows,
    all-gathers K and V (parallel/collectives.py::gather_kv, whose backward
    reduce-scatters dK and dV) and attends its rows to the whole clip.
Under "dart" a rank's rows are its local DART concat (its clean frames,
then the same frames noisy) and the gathered K/V come rank-major; the
kernels map every frame index to its global frame (ops/masks.shard_frame)
before the mask rule, so nothing is permuted. The context that routes
train-mode attention here is set_sp_context / sp_context /
sp_flash_supported, as in the JAX package.

All take q pre-scaled by 1/sqrt(d) and cast to the input type (the public
functions scale it, outside the Function, so autograd carries the scale
into dq), compute logits and the softmax in fp32 and write their results
in the input type. The training kernels run fp32 on the CUDA cores and
bf16 on the tensor cores, where P (and in the backward dS) is rounded to
bf16 before it multiplies V (dO, Q, K), as the bf16 operands require.

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

import torch.distributed as dist

from ..parallel.collectives import gather_kv
from . import _build
from .masks import expand_to_tokens, frame_visible, prefill_frame_mask, shard_frame

# Kernel launches since the last reset (chip_smoke.py zeroes and reads
# them): the prefill kernel, and the training kernels by mask kind, without
# and with sequence parallelism (one backward count is one call of the
# backward entry point, whose three stages run back to back on one stream).
launches = 0
dart_fwd_launches = 0
dart_bwd_launches = 0
full_fwd_launches = 0
full_bwd_launches = 0
dart_sp_fwd_launches = 0
dart_sp_bwd_launches = 0
causal_sp_fwd_launches = 0
causal_sp_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_SIGNATURES = {"ad_prefill_attention": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ctypes.c_int)}
_FWD_SIGNATURES = {
    "ad_flash_attention_ring_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p], ctypes.c_int),
    "ad_flash_attention_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
    "ad_flash_attention_sp_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p], ctypes.c_int)}
_BWD_SIGNATURES = {
    "ad_flash_attention_bwd": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int),
    "ad_flash_attention_sp_bwd": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p], ctypes.c_int)}
_KINDS = {"dart": 0, "full": 1, "causal": 2}


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
    qs, k, v = (_tma_aligned(t) for t in (qs, k, v))
    o = torch.empty_like(qs)
    args = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b * h, sq, k.shape[2], d,
            hw, t_new, f_total, offset, torch.cuda.current_stream(qs.device).cuda_stream)
    if qs.dtype == torch.float32:
        lib = _build.load("prefill_attention", _SIGNATURES)
        err = lib.ad_prefill_attention(*args)
    else:
        lib = _build.load("flash_attention_fwd", _FWD_SIGNATURES)
        err = lib.ad_flash_attention_ring_fwd(*args)
    _build.check(lib, err, "prefill attention")
    launches += 1
    return o


def _tma_aligned(t):
    """t, or a copy of it when it is bf16 and its data does not start on a
    16-byte boundary (a contiguous view at an odd storage offset): the
    tensor-core kernels read bf16 tensors by TMA, which needs one."""
    return t.clone() if t.dtype == torch.bfloat16 and t.data_ptr() % 16 else t


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
# Training: DART and full flash attention, forward and backward; the same
# kernels sequence parallel (sp_rank = the query rows' seq rank, else None)

@functools.lru_cache(maxsize=32)
def _token_mask_np(kind: str, n_frames: int, hw: int, s: int, sp: int = 1,
                   sp_rank: int = 0) -> np.ndarray:
    """(S, sp*S) bool mask of the predicate the kernels evaluate: the S query
    rows of seq rank `sp_rank` against the keys gathered from all `sp`
    ranks, each frame index mapped to its global frame (masks.shard_frame);
    sp = 1 is the (S, S) mask of one rank."""
    t_local = n_frames // sp
    qf = shard_frame(np.arange(sp_rank * s, (sp_rank + 1) * s) // hw, t_local, n_frames, kind)
    kf = shard_frame(np.arange(sp * s) // hw, t_local, n_frames, kind)
    return frame_visible(kind, qf[:, None], kf[None, :], n_frames)


def _token_mask(kind: str, n_frames: int, hw: int, s: int, device, sp: int = 1,
                sp_rank: int = 0) -> torch.Tensor:
    """The mask of _token_mask_np on `device` (a copy of the cached array,
    which no caller can then change)."""
    return torch.tensor(_token_mask_np(kind, n_frames, hw, s, sp, sp_rank), device=device)


def _mask_of(qs, k, kind, n_frames, hw, sp_rank):
    sp = 1 if sp_rank is None else k.shape[-2] // qs.shape[-2]
    return _token_mask(kind, n_frames, hw, qs.shape[-2], qs.device, sp, sp_rank or 0)


def flash_attention_fwd_plain(qs, k, v, kind: str, n_frames: int, hw: int, sp_rank=None):
    """Plain version of the forward kernel. qs (pre-scaled): (..., Sq, d);
    k, v: (..., Sk, d), Sk = Sq but under sequence parallelism (sp_rank =
    the rank of qs's rows, k and v gathered from all ranks: Sk = sp * Sq).
    Returns (o in v's type, lse fp32 (..., Sq))."""
    logits = torch.einsum("...qc,...kc->...qk", qs.float(), k.float())
    mask = _mask_of(qs, k, kind, n_frames, hw, sp_rank)
    logits = logits.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("...qk,...kc->...qc", p, v.float())
    return o.to(v.dtype), lse


def flash_attention_bwd_plain(qs, k, v, o, lse, do, kind: str, n_frames: int, hw: int,
                              sp_rank=None):
    """Plain version of the backward kernels, by the explicit formula:
    P = exp(qs k^T - lse) under the mask, delta = rowsum(dO * o),
    dS = P * (dP - delta); dq = dS k, dk = dS^T qs, dv = P^T dO.
    Returns (dq, dk, dv) in the input types; under sequence parallelism dk
    and dv are the sums over this rank's query rows only."""
    qf, kf, vf, dof = qs.float(), k.float(), v.float(), do.float()
    logits = torch.einsum("...qc,...kc->...qk", qf, kf)
    mask = _mask_of(qs, k, kind, n_frames, hw, sp_rank)
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1)
    dp = torch.einsum("...qc,...kc->...qk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("...qk,...kc->...qc", ds, kf)
    dk = torch.einsum("...qk,...qc->...kc", ds, qf)
    dv = torch.einsum("...qk,...qc->...kc", p, dof)
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_sp_fwd_plain(qs, k, v, kind: str, n_frames: int, hw: int, sp_rank: int):
    """Plain version of the sequence-parallel forward: the Sq rows of seq
    rank sp_rank against the Sk = sp * Sq gathered rows of k and v."""
    return flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw, sp_rank)


def flash_attention_sp_bwd_plain(qs, k, v, o, lse, do, kind: str, n_frames: int, hw: int,
                                 sp_rank: int):
    """Plain version of the sequence-parallel backward: dq of the local rows,
    this rank's partial dk and dv over all gathered rows."""
    return flash_attention_bwd_plain(qs, k, v, o, lse, do, kind, n_frames, hw, sp_rank)


def _flash_args(kind, n_frames, hw, sp_rank, rows, keys):
    """Check the training kernels' arguments: `rows` are shaped as q (q, and
    o and dO in the backward), `keys` as k (k, v). Returns (b, h, Sq, Sk, d)."""
    qs, k = rows[0], keys[0]
    kinds = ("dart", "full") if sp_rank is None else ("dart", "causal")
    if kind not in kinds:
        raise ValueError(f"flash attention: mask kind {kind!r} not in {kinds}")
    if qs.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash attention: q and k must be (b, heads, S, d), got "
                         f"{tuple(qs.shape)}, {tuple(k.shape)}")
    if qs.dtype not in _DTYPES:
        raise ValueError(f"flash attention: dtype {qs.dtype} not float32/bfloat16")
    b, h, sq, d = qs.shape
    sk = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {d} not in {_HEAD_DIMS}")
    if sp_rank is None:
        if sk != sq or (kind == "dart" and sq != 2 * n_frames * hw):
            raise ValueError(f"flash attention: Sq={sq}, Sk={sk}; a DART S is "
                             f"2 * {n_frames} frames * {hw}")
    else:
        sp, fq = sk // sq, sq // hw
        t_local = fq // 2 if kind == "dart" else fq
        if (sk % sq or sq % hw or not 0 <= sp_rank < sp or (kind == "dart" and fq % 2)
                or n_frames != sp * t_local):
            raise ValueError(f"flash attention: Sq={sq}, Sk={sk}, hw={hw}, rank {sp_rank}: "
                             f"not a {kind} shard of {n_frames} frames")
    for group, shape in ((rows, (b, h, sq, d)), (keys, (b, h, sk, d))):
        for t in group:
            if not t.is_cuda or t.device != qs.device:
                raise ValueError("flash attention: every tensor must be on q's CUDA device")
            if t.dtype != qs.dtype or tuple(t.shape) != shape:
                raise ValueError(f"flash attention: {tuple(t.shape)} {t.dtype}, expected "
                                 f"{shape} {qs.dtype}")
            if not t.is_contiguous():
                raise ValueError("flash attention: tensors must be contiguous")
    return b, h, sq, sk, d


def _count(kind, sp_rank, which):
    name = f"{kind}_{'' if sp_rank is None else 'sp_'}{which}_launches"
    globals()[name] += 1


def _launch_fwd(qs, k, v, kind, n_frames, hw, sp_rank=None):
    b, h, sq, sk, d = _flash_args(kind, n_frames, hw, sp_rank, (qs,), (k, v))
    qs, k, v = (_tma_aligned(t) for t in (qs, k, v))
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    lib = _build.load("flash_attention_fwd", _FWD_SIGNATURES)
    ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    if sp_rank is None:
        err = lib.ad_flash_attention_fwd(*ptrs, b * h, sq, d, _KINDS[kind], n_frames, hw,
                                         _DTYPES[qs.dtype], stream)
    else:
        err = lib.ad_flash_attention_sp_fwd(*ptrs, b * h, sq, sk, d, _KINDS[kind], n_frames,
                                            hw, sp_rank, _DTYPES[qs.dtype], stream)
    _build.check(lib, err, "flash attention forward")
    _count(kind, sp_rank, "fwd")
    return o, lse


def _launch_bwd(qs, k, v, o, lse, do, kind, n_frames, hw, sp_rank=None):
    b, h, sq, sk, d = _flash_args(kind, n_frames, hw, sp_rank, (qs, o, do), (k, v))
    qs, k, v, o, do = (_tma_aligned(t) for t in (qs, k, v, o, do))
    if (lse.device != qs.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"flash attention: lse is {tuple(lse.shape)} {lse.dtype} on "
                         f"{lse.device}; expected contiguous {(b, h, sq)} float32")
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    if sp_rank is None:
        err = lib.ad_flash_attention_bwd(*ptrs, b * h, sq, d, _KINDS[kind], n_frames, hw,
                                         _DTYPES[qs.dtype], stream)
    else:
        err = lib.ad_flash_attention_sp_bwd(*ptrs, b * h, sq, sk, d, _KINDS[kind], n_frames,
                                            hw, sp_rank, _DTYPES[qs.dtype], stream)
    _build.check(lib, err, "flash attention backward")
    _count(kind, sp_rank, "bwd")
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


def flash_attention_sp_fwd(qs, k, v, kind: str, n_frames: int, hw: int, sp_rank: int):
    """(o, lse) of the pre-scaled query rows of seq rank sp_rank against the
    gathered k, v: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. kind "dart" or "causal"; n_frames is T of the whole clip."""
    if qs.device.type == "cpu":
        return flash_attention_sp_fwd_plain(qs, k, v, kind, n_frames, hw, sp_rank)
    return _launch_fwd(qs, k, v, kind, n_frames, hw, sp_rank)


def flash_attention_sp_bwd(qs, k, v, o, lse, do, kind: str, n_frames: int, hw: int,
                           sp_rank: int):
    """(dq, partial dk, partial dv) of the sequence-parallel forward: the
    CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    if qs.device.type == "cpu":
        return flash_attention_sp_bwd_plain(qs, k, v, o, lse, do, kind, n_frames, hw, sp_rank)
    return _launch_bwd(qs, k, v, o, lse, do, kind, n_frames, hw, sp_rank)


class _FlashAttention(torch.autograd.Function):
    """Masked flash attention of pre-scaled q under autograd. The forward
    saves its inputs, o and lse; the backward recomputes the softmax.
    sp_rank: None, or the seq rank of q's rows (k, v gathered)."""

    @staticmethod
    def forward(ctx, qs, k, v, kind, n_frames, hw, sp_rank):
        if sp_rank is None:
            o, lse = flash_attention_fwd(qs, k, v, kind, n_frames, hw)
        else:
            o, lse = flash_attention_sp_fwd(qs, k, v, kind, n_frames, hw, sp_rank)
        ctx.mask = (kind, n_frames, hw)
        ctx.sp_rank = sp_rank
        ctx.save_for_backward(qs, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        if ctx.sp_rank is None:
            grads = flash_attention_bwd(qs, k, v, o, lse, do.contiguous(), *ctx.mask)
        else:
            grads = flash_attention_sp_bwd(qs, k, v, o, lse, do.contiguous(), *ctx.mask,
                                           ctx.sp_rank)
        return (*grads, None, None, None, None)


def dart_attention(q, k, v, n_frames: int, tokens_per_frame: int):
    """DART-masked flash attention over the 2T-frame concat, differentiable
    in q, k and v. q, k, v: (b, heads, 2*T*hw, d)."""
    return _FlashAttention.apply(_prescale(q).contiguous(), k.contiguous(), v.contiguous(),
                                 "dart", n_frames, tokens_per_frame, None)


def full_attention(q, k, v):
    """Unmasked flash attention, differentiable in q, k and v.
    q, k, v: (batch, heads, S, d)."""
    s = q.shape[2]
    return _FlashAttention.apply(_prescale(q).contiguous(), k.contiguous(), v.contiguous(),
                                 "full", 1, s, None)


# ---------------------------------------------------------------------------
# Sequence parallel: Q rows stay on their seq rank, K/V are all-gathered

def _sp_apply(kind, q, k, v, n_frames, tokens_per_frame, group):
    kg, vg = gather_kv(k.contiguous(), v.contiguous(), group)
    return _FlashAttention.apply(_prescale(q).contiguous(), kg, vg, kind, n_frames,
                                 tokens_per_frame, dist.get_rank(group))


def dart_attention_sp(q, k, v, n_frames: int, tokens_per_frame: int, group):
    """Sequence-parallel DART flash attention, differentiable in q, k and v.
    q, k, v: (b, heads, 2*t_l*hw, d), this rank's local DART concat (its t_l
    = n_frames / sp clean frames, then the same frames noisy) of a clip of
    n_frames = T frames split over the seq process group `group`. Returns
    this rank's rows."""
    return _sp_apply("dart", q, k, v, n_frames, tokens_per_frame, group)


def causal_frame_attention_sp(q, k, v, n_frames: int, tokens_per_frame: int, group):
    """Sequence-parallel frame-causal flash attention, differentiable in q,
    k and v. q, k, v: (b, heads, t_l*hw, d), this rank's contiguous run of
    t_l = n_frames / sp frames of the clip."""
    return _sp_apply("causal", q, k, v, n_frames, tokens_per_frame, group)


# The SP context: lets train-mode VideoAttention (and the causal convs'
# halo, models/layers.py) reach the sequence-parallel path. As in the JAX
# package it is process-wide: a training script that splits the clip's
# frames over a seq group installs its mesh (parallel/mesh.py) here.
_SP_CTX = None


def set_sp_context(mesh):
    """Install (or clear, mesh=None) the sequence-parallel context: a
    parallel.Mesh whose seq group train-mode layers split frames over."""
    global _SP_CTX
    _SP_CTX = mesh
    return mesh


def sp_context():
    return _SP_CTX


def sp_flash_supported(n_frames_local: int) -> bool:
    """Whether train-mode attention takes the sequence-parallel kernels: an
    SP context with sp > 1 is installed. Raises when a rank holds fewer
    than 2 frames (the causal convs' halo reads 2 frames of the previous
    rank). The JAX package's splash tile gate (S % (sp * 128)) is not
    carried over."""
    mesh = _SP_CTX
    if mesh is None or mesh.sp <= 1:
        return False
    if n_frames_local < 2:
        raise ValueError(f"sequence parallelism needs at least 2 frames a rank, got "
                         f"{n_frames_local} (sp={mesh.sp})")
    return True
