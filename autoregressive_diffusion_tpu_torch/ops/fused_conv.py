"""The fused conv kernels and their plain PyTorch versions: the train-mode
fused gated causal conv (csrc/fused_conv_fwd.cu, csrc/fused_conv_bwd.cu,
under a torch.autograd.Function) and the fused attention-free decode Block
(csrc/decode_block.cu).

`fused_gated_conv` replaces
autoregressive_diffusion_tpu/ops/fused_conv.py::fused_gated_conv (:784,
forward pallas_call :830, backward _fused_bwd :879) on channels-last
tensors, without the TPU's packed lane layout: the input transform
(x * cvec, mp_silu), the 3x3 conv on every frame of the DART concat, the
2x3x3 context conv over the past clean frames (ones before the clip start)
and the gate blend, in one forward call; dx, dw2, dw3, dcvec and dgates in
one backward call. bf16 runs on the tensor cores (an implicit GEMM behind
an elementwise prologue), fp32 on SIMT kernels; the type alone picks the
path. The plain version fixes the order of roundings that the kernels
follow: the transform is fp32 and is rounded to the working type, the
products take it and the weights in the working type and are summed in
fp32, the blend is fp32 and the result is rounded once. The bf16 backward
adds one rounding: it forms the gated output gradients (dy2d, dctx) in
fp32 and rounds them to bf16 before its products.

`fused_decode_block` replaces autoregressive_diffusion_tpu/ops/fused_conv.py::fused_decode_block
(:1130, Pallas kernel _decode_kernel :1069), bf16 on the tensor cores and
fp32 on SIMT kernels (csrc/decode_block.cu): one T=1 cached-decode step of
an attention-free Block -- [enc: 1x1 skip, pixel norm] -> mp_silu -> conv0
3x3 + context conv over the 2-frame ring a0, gate g0 -> *cv -> mp_silu ->
conv1 3x3 + context over ring a1, gate g1 -> residual mp_sum -> clip. It
also returns this step's transformed conv inputs t0, t1 for the caller's
ring update. The plain version follows the TPU kernel's numerics: the skip
product and the pixel norm are fp32, the convolutions take t0/t1 and the
rings in the working type and sum in fp32.

On CUDA tensors a wrapper launches its kernel or raises; the plain
versions run only for CPU tensors (and in chip_smoke.py, as the yardstick
the kernel is held against).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# Fused-Block launches since the last reset (chip_smoke.py zeroes and reads
# it). One count is one Block: the kernel's three stages run back to back.
launches = 0
# Train-mode fused gated conv: forward and backward calls (one count is one
# call of an entry point, whose kernels run back to back on one stream).
conv_fwd_launches = 0
conv_bwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"ad_decode_block": (
    [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p],
    ctypes.c_int)}
_FWD_SIGNATURES = {
    "ad_fused_conv_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
                          ctypes.c_int),
    "ad_fused_conv_fwd_scratch": ([ctypes.c_int] * 8, ctypes.c_longlong)}
_BWD_SIGNATURES = {
    "ad_fused_conv_bwd": ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
                          ctypes.c_int),
    "ad_fused_conv_bwd_scratch": ([ctypes.c_int] * 8, ctypes.c_longlong)}


def _silu_f32(z):
    return torch.sigmoid(z) * z * (1.0 / 0.596)


def _conv3x3(x, w):
    """x (B, H, W, C) fp32, w (3, 3, C, Co) -> (B, H, W, Co), zero padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def _blend(a, b, g):
    """mp_sum with a per-batch gate g (B,)."""
    g = g[:, None, None, None]
    return (a + (b - a) * g) * torch.rsqrt((1 - g) ** 2 + g ** 2)


def fused_decode_block_plain(x, a0, a1, wsk, w20, w30, w21, w31, cv, gates,
                             flavor: str, res_t: float, clip, with_ctx: bool):
    """Plain version; arguments as for fused_decode_block."""
    dt = x.dtype
    c0 = w20.shape[-2]
    xf = x[:, 0].float()
    if flavor == "enc":
        h = xf @ wsk.float() if wsk is not None else xf
        n = torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True) + 1e-24)
        h = h / (1e-4 + n * (c0 ** -0.5))
        res = h
    else:
        h = xf
        res = xf @ wsk.float() if wsk is not None else xf
    g = gates.float()
    t0 = _silu_f32(h).to(dt)
    y = _conv3x3(t0.float(), w20)
    if with_ctx:
        ctx = (_conv3x3(a0[:, 0].float(), w30[0])
               + _conv3x3(a0[:, 1].float(), w30[1]))
        y = _blend(y, ctx, g[:, 0])
    t1 = _silu_f32(y * cv.float()[:, None, None, :]).to(dt)
    y = _conv3x3(t1.float(), w21)
    if with_ctx:
        ctx = (_conv3x3(a1[:, 0].float(), w31[0])
               + _conv3x3(a1[:, 1].float(), w31[1]))
        y = _blend(y, ctx, g[:, 1])
    out = (res + (y - res) * res_t) * ((1 - res_t) ** 2 + res_t ** 2) ** -0.5
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    return out.to(dt)[:, None], t0[:, None], t1[:, None]


def _check(name, t, shape, dtype, device):
    if t is None:
        raise ValueError(f"fused kernel: {name} is required")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused kernel: {name} is {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}; expected {tuple(shape)} {dtype} on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"fused kernel: {name} must be contiguous")


# csrc/decode_block.cu: the prologue stages a pixel's Cin inputs in shared
# memory (MAX_CIN); a launch has at most 65535 rows of blocks.
_DECODE_MAX_CIN = 1024
_MAX_GRID_ROWS = 65535
_TC_SMEM = 58880  # tc::SMEM, the bf16 kernels' stage ring, which the prologue reuses


def check_decode_block_shape(b: int, t: int, h: int, w: int, cin: int, c0: int, co: int,
                             flavor: str, has_skip: bool) -> None:
    """Raise ValueError for a Block step that the decode-Block kernels
    cannot take: x (b, t, h, w, cin), conv0 C0 -> Co. C0 and Co have no
    limit of their own (csrc/decode_block.cu says why); Cin is bounded by
    the prologue's staging, and the grid by the rows of the bf16 kernel's
    first launch at its smallest split (the SIMT grids are smaller)."""
    if flavor not in ("enc", "dec"):
        raise ValueError(f"decode block: unknown flavor {flavor!r}")
    if t != 1:
        raise ValueError(f"decode block: T={t}, the kernel is the T=1 step")
    if min(b, h, w, cin, c0, co) <= 0:
        raise ValueError(f"decode block: empty shape B={b} H={h} W={w} Cin={cin} C0={c0} "
                         f"Co={co}")
    if flavor == "enc" and c0 != co:
        raise ValueError(f"decode block: enc flavor needs C0 == Co ({c0}, {co})")
    if flavor == "dec" and c0 != cin:
        raise ValueError(f"decode block: dec flavor needs C0 == Cin ({c0}, {cin})")
    if not has_skip and cin != co:
        raise ValueError(f"decode block: no skip weight but Cin={cin} != Co={co}")
    if cin > _DECODE_MAX_CIN:
        raise ValueError(f"decode block: Cin={cin} > {_DECODE_MAX_CIN}, the prologue's "
                         f"shared-memory staging of a pixel's inputs")
    tiles = -(-h // 8) * -(-w // 8)
    pro_ppw = min(4, _TC_SMEM // (16 * cin))  # pixels a warp: 4 warps x 4-byte floats
    rows = 2 * b * tiles * -(-co // 32) + -(-(b * h * w) // (4 * pro_ppw))
    if rows > _MAX_GRID_ROWS:
        raise ValueError(f"decode block: {rows} rows of blocks > {_MAX_GRID_ROWS}")


def _launch(x, a0, a1, wsk, w20, w30, w21, w31, cv, gates, flavor, res_t,
            clip, with_ctx):
    global launches
    dt, dev = x.dtype, x.device
    if dt not in _DTYPES:
        raise ValueError(f"decode block: dtype {dt} not float32/bfloat16")
    b, t, h, w, cin = x.shape
    c0, co = w20.shape[-2], w20.shape[-1]
    check_decode_block_shape(b, t, h, w, cin, c0, co, flavor, wsk is not None)
    _check("x", x, (b, 1, h, w, cin), dt, dev)
    _check("w20", w20, (3, 3, c0, co), dt, dev)
    _check("w21", w21, (3, 3, co, co), dt, dev)
    _check("cv", cv, (b, co), dt, dev)
    _check("gates", gates, (b, 2), torch.float32, dev)
    if wsk is not None:
        _check("wsk", wsk, (cin, co), dt, dev)
    if with_ctx:
        _check("a0", a0, (b, 2, h, w, c0), dt, dev)
        _check("a1", a1, (b, 2, h, w, co), dt, dev)
        _check("w30", w30, (2, 3, 3, c0, co), dt, dev)
        _check("w31", w31, (2, 3, 3, co, co), dt, dev)
    else:  # the kernel reads no context
        a0 = a1 = w30 = w31 = None
    y = torch.empty((b, 1, h, w, co), dtype=dt, device=dev)
    t0 = torch.empty((b, 1, h, w, c0), dtype=dt, device=dev)
    t1 = torch.empty((b, 1, h, w, co), dtype=dt, device=dev)
    res = torch.empty((b, h, w, co), dtype=torch.float32, device=dev)
    # the bf16 kernels' context sums (ctx0, ctx1), fp32
    ctx = (torch.empty((2, b, h, w, co), dtype=torch.float32, device=dev)
           if with_ctx and dt == torch.bfloat16 else None)

    def ptr(v):
        return None if v is None else v.data_ptr()

    lib = _build.load("decode_block", _SIGNATURES)
    err = lib.ad_decode_block(
        x.data_ptr(), ptr(a0), ptr(a1), ptr(wsk), w20.data_ptr(), ptr(w30),
        w21.data_ptr(), ptr(w31), cv.data_ptr(), gates.data_ptr(),
        y.data_ptr(), t0.data_ptr(), t1.data_ptr(), res.data_ptr(), ptr(ctx),
        b, h, w, cin, c0, co, int(flavor == "enc"), int(wsk is not None),
        int(bool(with_ctx)), float(res_t),
        float(clip) if clip is not None else 0.0, int(clip is not None),
        _DTYPES[dt], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "decode block")
    launches += 1
    return y, t0, t1


def fused_decode_block(x, a0, a1, wsk, w20, w30, w21, w31, cv, gates,
                       flavor: str, res_t: float, clip, with_ctx: bool):
    """Fused eval/decode Block step (T=1), channels-last.

    x:     (B, 1, H, W, Cin) Block input (after resample)
    a0:    (B, 2, H, W, C0) conv_res0 ring (transformed frames t-2, t-1);
           C0 = Co for the enc flavor, Cin for dec. None when not with_ctx.
    a1:    (B, 2, H, W, Co) conv_res1 ring, None when not with_ctx
    wsk:   (Cin, Co) 1x1 skip weight or None
    w20/w21: (3, 3, C0/Co, Co) normalized 2D weights
    w30/w31: (2, 3, 3, C0/Co, Co) context weights (index 0 = frame t-2)
    cv:    (B, Co) noise-embedding modulation between the convs
    gates: (B, 2) fp32 [conv0 gate, conv1 gate]
    Returns (y (B,1,H,W,Co), t0 (B,1,H,W,C0), t1 (B,1,H,W,Co)).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_decode_block_plain(x, a0, a1, wsk, w20, w30, w21, w31, cv,
                                        gates, flavor, res_t, clip, with_ctx)
    return _launch(x, a0, a1, wsk, w20, w30, w21, w31, cv, gates, flavor,
                   res_t, clip, with_ctx)


# ---------------------------------------------------------------------------
# Train-mode fused gated causal conv

def fused_gated_conv_plain(x, w2, w3, cvec, gates, silu_in: bool, with_ctx: bool):
    """Plain version of fused_gated_conv (same arguments); differentiable
    by autograd in x, w2, w3, cvec and gates."""
    dt = x.dtype
    b, f, h, w, c = x.shape
    a = x.float()
    if cvec is not None:
        a = a * cvec.float()[:, :, None, None, :]
    if silu_in:
        a = _silu_f32(a)
    a = a.to(dt).float()
    y2d = _conv3x3(a.reshape(b * f, h, w, c), w2).reshape(b, f, h, w, -1)
    if not with_ctx:
        return y2d.to(dt)
    t = f // 2
    # h[t], h[t+1] = clean frames t-2, t-1; ones before the clip start
    ones = torch.ones((b, 2, h, w, c), dtype=a.dtype, device=a.device)
    hist = torch.cat([ones, a[:, :t - 1]], dim=1)
    ctx = (_conv3x3(hist[:, :t].reshape(b * t, h, w, c), w3[0])
           + _conv3x3(hist[:, 1:t + 1].reshape(b * t, h, w, c), w3[1]))
    ctx = ctx.reshape(b, t, h, w, -1)
    ctx = torch.cat([ctx, ctx], dim=1)  # the clean half's context serves both
    g = gates.float()[:, :, None, None, None]
    out = (y2d + (ctx - y2d) * g) * torch.rsqrt((1 - g) ** 2 + g ** 2)
    return out.to(dt)


def _conv_args(x, w2, w3, cvec, gates, with_ctx):
    """Check the arguments of the conv kernels; returns (b, f, h, w, c, co)."""
    if x.ndim != 5:
        raise ValueError(f"fused conv: x must be (B, F, H, W, C), got {tuple(x.shape)}")
    dt, dev = x.dtype, x.device
    if dt not in _DTYPES:
        raise ValueError(f"fused conv: dtype {dt} not float32/bfloat16")
    b, f, h, w, c = x.shape
    co = w2.shape[-1]
    _check("x", x, (b, f, h, w, c), dt, dev)
    _check("w2", w2, (3, 3, c, co), dt, dev)
    if cvec is not None:
        _check("cvec", cvec, (b, f, c), dt, dev)
    if with_ctx:
        if f % 2:
            raise ValueError(f"fused conv: the DART concat has an even frame count, got {f}")
        _check("w3", w3, (2, 3, 3, c, co), dt, dev)
        _check("gates", gates, (b, f), torch.float32, dev)
    return b, f, h, w, c, co


def _ptr(v):
    return None if v is None else v.data_ptr()


def _scratch(lib, fn, dev, *dims):
    """Uninitialised scratch of the size the library's `fn` gives for these
    dimensions (torch's allocations are 256-byte aligned)."""
    return torch.empty(getattr(lib, fn)(*dims), dtype=torch.uint8, device=dev)


def _launch_conv_fwd(x, w2, w3, cvec, gates, silu_in, with_ctx, want_diff):
    global conv_fwd_launches
    b, f, h, w, c, co = _conv_args(x, w2, w3, cvec, gates, with_ctx)
    if not with_ctx:
        w3 = gates = None
    out = torch.empty((b, f, h, w, co), dtype=x.dtype, device=x.device)
    diff = torch.empty_like(out) if (with_ctx and want_diff) else None
    lib = _build.load("fused_conv_fwd", _FWD_SIGNATURES)
    dims = (b, f, h, w, c, co, int(bool(with_ctx)), _DTYPES[x.dtype])
    scratch = _scratch(lib, "ad_fused_conv_fwd_scratch", x.device, *dims)
    err = lib.ad_fused_conv_fwd(
        x.data_ptr(), w2.data_ptr(), _ptr(w3), _ptr(cvec), _ptr(gates),
        out.data_ptr(), _ptr(diff), scratch.data_ptr(), b, f, h, w, c, co,
        int(bool(silu_in)), int(bool(with_ctx)), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "fused conv forward")
    conv_fwd_launches += 1
    return out, diff


def _launch_conv_bwd(x, w2, w3, cvec, gates, gout, diff, out, silu_in, with_ctx,
                     need_dx):
    global conv_bwd_launches
    b, f, h, w, c, co = _conv_args(x, w2, w3, cvec, gates, with_ctx)
    dt, dev = x.dtype, x.device
    _check("gout", gout, (b, f, h, w, co), dt, dev)
    if with_ctx:
        _check("diff", diff, (b, f, h, w, co), dt, dev)
        _check("out", out, (b, f, h, w, co), dt, dev)
    else:
        w3 = gates = diff = out = None
    dx = torch.empty_like(x) if need_dx else None
    dw2 = torch.empty_like(w2)
    dw3 = torch.empty_like(w3) if with_ctx else None
    dcvec = torch.empty_like(cvec) if cvec is not None else None
    dgates = torch.empty_like(gates) if with_ctx else None
    lib = _build.load("fused_conv_bwd", _BWD_SIGNATURES)
    scratch = _scratch(lib, "ad_fused_conv_bwd_scratch", dev, b, f, h, w, c, co,
                       int(bool(with_ctx)), _DTYPES[dt])
    err = lib.ad_fused_conv_bwd(
        x.data_ptr(), w2.data_ptr(), _ptr(w3), _ptr(cvec), _ptr(gates),
        gout.data_ptr(), _ptr(diff), _ptr(out), _ptr(dx), dw2.data_ptr(), _ptr(dw3),
        _ptr(dcvec), _ptr(dgates), scratch.data_ptr(), b, f, h, w, c, co,
        int(bool(silu_in)), int(bool(with_ctx)), _DTYPES[dt],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused conv backward")
    conv_bwd_launches += 1
    return dx, dw2, dw3, dcvec, dgates


class _FusedGatedConv(torch.autograd.Function):
    """The two conv kernels under autograd (CUDA tensors only). The forward
    saves its inputs, its result and diff = ctx - y2d; the backward
    recomputes the transformed activations from x."""

    @staticmethod
    def forward(ctx, x, w2, w3, cvec, gates, silu_in, with_ctx):
        want = any(ctx.needs_input_grad)
        out, diff = _launch_conv_fwd(x, w2, w3, cvec, gates, silu_in, with_ctx, want)
        ctx.silu_in, ctx.with_ctx = silu_in, with_ctx
        ctx.save_for_backward(x, w2, w3, cvec, gates, diff, out if with_ctx else None)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, w2, w3, cvec, gates, diff, out = ctx.saved_tensors
        dx, dw2, dw3, dcvec, dgates = _launch_conv_bwd(
            x, w2, w3, cvec, gates, gout.contiguous(), diff, out, ctx.silu_in,
            ctx.with_ctx, ctx.needs_input_grad[0])
        return dx, dw2, dw3, dcvec, dgates, None, None


def fused_gated_conv(x, w2, w3, cvec, gates, silu_in: bool, with_ctx: bool):
    """Train-mode fused transform + 3x3 conv + context conv + gate blend,
    channels-last, differentiable in x, w2, w3, cvec and gates.

    x:     (B, 2T, H, W, C) DART concat, clean frames [0, T), noisy [T, 2T);
           float32 or bfloat16. With with_ctx=False: (B, F, H, W, C), F
           independent frames (the just_2d step).
    w2:    (3, 3, C, Co) normalized 2D weight, x's type
    w3:    (2, 3, 3, C, Co) normalized context weight, index 0 = frame t-2
    cvec:  (B, 2T, C) per-(frame, channel) scale in x's type, or None
    gates: (B, 2T) fp32 per-frame gate
    w3 and gates are unread (and may be None) when with_ctx is False.
    Returns (B, 2T, H, W, Co) in x's type.
    The CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return fused_gated_conv_plain(x, w2, w3, cvec, gates, silu_in, with_ctx)
    if not with_ctx:
        w3 = gates = None
    return _FusedGatedConv.apply(x, w2, w3, cvec, gates, bool(silu_in), bool(with_ctx))


def conv_calls(cfg):
    """[(module name, (H, C, Co, silu_in, has_cvec))] of every causal conv
    of the model (a models.UNetConfig), in execution order: the shapes the
    train-mode fused conv runs at."""
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


def conv_inputs(b, f, h, w, c, co, has_cv, with_ctx, dtype, device, seed):
    """([x, w2, w3, cvec, gates], the output gradient) of one fused conv
    call, seeded normal draws (the weights normalized as the model's are)."""
    from .numerics import mp_weight
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device=device)

    args = [rn(b, f, h, w, c).to(dtype), mp_weight(rn(3, 3, c, co)).to(dtype),
            mp_weight(rn(2, 3, 3, c, co)).to(dtype) if with_ctx else None,
            (1.0 + 0.3 * rn(b, f, c)).to(dtype) if has_cv else None,
            (0.05 + 0.9 * torch.rand((b, f), generator=g, device=device)) if with_ctx else None]
    return args, rn(b, f, h, w, co).to(dtype)
