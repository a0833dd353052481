"""The port's cost model: the least time the card could take for a piece of work.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the operations it does (a multiply-add is two) over the card's peak
rate for their type. The peaks are an H100 SXM's, dense (no sparsity):

  * bf16 on the tensor cores 989e12 operations/s, fp32 on the CUDA cores
    67e12;
  * HBM3 3.35e12 bytes/s.

Costs, each ((operations, bytes)) of one call at the shapes given:
  * flash_cost, sp_cost: the flash-attention kernels (rows 4, 7 and 8 of
    PERF.md's kernel table), over the (query, key) pairs their mask lets
    through;
  * block_cost: the fused decode Block (row 3);
  * conv_cost: the train-mode fused gated conv, forward and backward
    (rows 1, 2);
  * denoiser_call_cost: one call of the whole denoiser, layer by layer:
    the kernels' work and the plain PyTorch products around them (the
    attention Blocks' convs, qkv and projection, the cached decode
    attention, the embedding).
unfused_cudnn_conv is the yardstick the conv kernels are timed against
(cuDNN's F.conv2d plus elementwise ops in the working type); the port
never calls it.

Used by chip_smoke.py, decode_budget.py and kernel_bench.py; torch-only.
"""
from __future__ import annotations

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12                                    # H100 SXM, HBM3


def item_size(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def bound(flops, nbytes, dtype):
    """(ms, "operations" or "bytes"): the larger of the two floors."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def flash_cost(kind, b, heads, n_frames, hw, d, dtype):
    """((forward operations, bytes), (backward operations, bytes)) of one
    flash-attention call, kind "dart" (S = 2 n_frames hw) or "full" (S =
    hw): a multiply-add is two operations, over the (query, key) pairs the
    mask lets through; the forward reads q, k, v and writes o and lse, the
    backward reads q, k, v, o, dO and lse and writes dq, dk, dv."""
    from ..ops.masks import train_frame_mask
    if kind == "dart":
        s = 2 * n_frames * hw
        pairs = int(train_frame_mask(n_frames).sum()) * hw * hw
    else:
        s = hw
        pairs = s * s
    bh = b * heads
    mat = bh * s * d * item_size(dtype)
    return ((4 * d * pairs * bh, 4 * mat + 4 * bh * s),
            (10 * d * pairs * bh, 8 * mat + 4 * bh * s))


def sp_cost(kind, b, heads, n_frames, hw, d, sp, rank, dtype):
    """((forward operations, bytes), (backward operations, bytes)) of one
    seq rank's sequence-parallel call: a multiply-add is two operations,
    over the (query, key) pairs the rank's mask lets through; the forward
    reads its q rows and the gathered k, v and writes o and lse rows, the
    backward reads q, o, dO, lse rows and k, v and writes dq rows and the
    partial dk, dv."""
    from ..ops.flash_attention import _token_mask_np
    s = (2 if kind == "dart" else 1) * n_frames * hw
    sq = s // sp
    pairs = int(_token_mask_np(kind, n_frames, hw, sq, sp, rank).sum())
    bh = b * heads
    item = item_size(dtype)
    rows, keys = bh * sq * d * item, bh * s * d * item
    return ((4 * d * pairs * bh, 2 * rows + 2 * keys + 4 * bh * sq),
            (10 * d * pairs * bh, 4 * rows + 4 * keys + 4 * bh * sq))


def _block_parts(shape, with_ctx=True):
    """(operations, activation elements, weight elements) of one fused
    Block step (shape = (H, Cin, C0, Co, flavor, has_skip)): both convs'
    and the skip's multiply-adds; x, the conv caches and cv read, y and
    the two cache frames written."""
    h, cin, c0, co, _, has_skip = shape
    taps = 27 if with_ctx else 9
    hw = h * h
    flops = 2 * hw * (taps * c0 * co + taps * co * co + (cin * co if has_skip else 0))
    acts = (hw * cin + (2 * hw * (c0 + co) if with_ctx else 0) + co
            + hw * (co + c0 + co))
    weights = taps * (c0 + co) * co + (cin * co if has_skip else 0)
    return flops, acts, weights


def block_cost(shape, dtype, with_ctx=True):
    """(operations, bytes) of one fused decode Block call: each input read
    once, each output written once, the weights in the working type."""
    flops, acts, weights = _block_parts(shape, with_ctx)
    return flops, (acts + weights) * item_size(dtype) + 8


def conv_cost(b, f, h, w, c, co, has_cv, with_ctx, dtype):
    """((forward operations, bytes), (backward operations, bytes)) of the
    train-mode fused gated conv: a multiply-add is two operations; each
    input read once, each output written once (the forward's diff residual
    included). The backward's dx counts the context taps that exist (not
    the ones frames before the clip), its dw every product of the forward."""
    t = f // 2
    mac = b * h * w * c * co * 9
    item = item_size(dtype)
    n_x, n_o = b * f * h * w * c, b * f * h * w * co
    n_w = 9 * c * co * (3 if with_ctx else 1)
    n_cv = b * f * c if has_cv else 0
    fwd = 2 * mac * (f + (2 * t if with_ctx else 0))
    fwd_bytes = item * (n_x + n_w + n_cv + n_o * (2 if with_ctx else 1)) + 4 * b * f
    ctx_taps = max(t - 1, 0) + max(t - 2, 0) if with_ctx else 0
    bwd = 2 * mac * (f + ctx_taps) + 2 * mac * (f + (2 * t if with_ctx else 0))
    bwd_bytes = (item * (2 * n_x + 2 * n_w + 2 * n_cv + n_o * (3 if with_ctx else 1))
                 + 8 * b * f)
    return (fwd, fwd_bytes), (bwd, bwd_bytes)


def unfused_cudnn_conv(x, w2, w3, cvec, gates, silu_in, with_ctx):
    """The unfused path in the working type: elementwise transform, one
    F.conv2d per frame, one F.conv2d over the two past clean frames stacked
    on channels, gate blend. A yardstick only; the port never calls it."""
    import torch.nn.functional as F
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
    t = x.shape[1] // 2
    hist = torch.cat([torch.ones_like(a[:, :2]), a[:, :t - 1]], dim=1)
    xs = torch.cat([hist[:, :t], hist[:, 1:t + 1]], dim=-1)
    ctx = conv(xs, w3.permute(1, 2, 0, 3, 4).reshape(3, 3, 2 * a.shape[-1], -1))
    ctx = torch.cat([ctx, ctx], dim=1)
    g = gates.to(x.dtype)[:, :, None, None, None]
    return (y2d + (ctx - y2d) * g) * ((1 - g) ** 2 + g ** 2) ** -0.5


def denoiser_call_cost(cfg, dtype, ring_frames: int, weight_item: int = 4,
                       just_2d: bool = False) -> list:
    """[(layer, route, operations, bytes)] of one T = 1 denoiser call at
    batch 1 against a cache whose K/V rings hold `ring_frames` frames (a
    cached call), or of the cacheless just_2d call. route: "decode_block"
    (the fused Block kernel), "full_attention" (the flash kernel of a frame
    layer; under just_2d every attention layer) or "plain" (PyTorch
    products). Operations: every multiply-add as two. Bytes: each weight
    read once at `weight_item` bytes an element (4: the fp32 master
    weights the call normalizes; 1: int8 decode weights, their per-channel
    scales left out), each activation, conv cache frame and K/V table read
    or written once in `dtype`. Elementwise work (norms, gates, RoPE,
    softmax) adds bytes the kernels fuse and no products; it is not
    counted."""
    item = item_size(dtype)
    taps = 9 if just_2d else 27
    rows = []

    def add(layer, route, flops, acts, weights):
        rows.append((layer, route, flops, acts * item + weights * weight_item))

    emb_w = cfg.cnoise * cfg.cemb + cfg.label_dim * cfg.cemb
    add("embedding", "plain", 2 * emb_w, 2 * cfg.cnoise + cfg.label_dim + cfg.cemb, emb_w)
    for side, name, spec in cfg.block_layout():
        layer = name if side == "out" else f"{side}_{name}"
        res, cin, co = spec["res"], spec["cin"], spec["cout"]
        hw = res * res
        if spec["kind"] == "conv":
            ctx = 0 if just_2d else 2 * hw * cin
            add(layer, "plain", 2 * hw * taps * cin * co, hw * (cin + co) + ctx,
                taps * cin * co)
            continue
        add(f"{layer}.emb_linear", "plain", 2 * cfg.cemb * co, cfg.cemb + co, cfg.cemb * co)
        c0 = co if spec["flavor"] == "enc" else cin
        flops, acts, weights = _block_parts((res, cin, c0, co, spec["flavor"], cin != co),
                                            not just_2d)
        heads = cfg.num_heads(spec)
        add(f"{layer}.convs", "plain" if heads else "decode_block", flops, acts, weights)
        if not heads:
            continue
        d = co // heads
        add(f"{layer}.attn_qkv_proj", "plain", 2 * hw * 4 * co * co, hw * (co + 3 * co + 2 * co),
            4 * co * co)
        if spec["attention"] == "video" and not just_2d:
            keys = (ring_frames + 1) * hw
            add(f"{layer}.attention", "plain", 4 * d * heads * hw * keys,
                2 * ring_frames * hw * co, 0)
        else:
            (f_ops, f_bytes), _ = flash_cost("full", 1, heads, 1, hw, d, dtype)
            rows.append((f"{layer}.attention", "full_attention", f_ops, f_bytes))
    return rows
