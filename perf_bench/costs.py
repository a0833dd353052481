"""The benchmark's cost model: peaks of the card and the least time a piece of work needs.

A frozen copy of the port's cost model at the time the benchmark was
defined, so that a later change to the program cannot move the yardstick.
A kernel's bound is the larger of two times: its bytes (each input read
once, each output written once) over the memory rate, and its operations
(a multiply-add is two) over the peak rate for their type. The peaks are
the published dense rates of one H100 SXM at its full 700 W limit; a card
set below it reads lower shares, which is why every result names the
card's power limit.

  * flash_cost: one flash-attention call under the DART or full mask;
  * block_cost: one fused decode-Block call (a cached T = 1 step);
  * conv_cost: the train-mode fused gated conv, forward and backward;
  * denoiser_call_cost: one cached T = 1 denoiser call at batch 1, layer
    by layer (the kernels and the plain products around them);
  * train_step_cost: the products of one training step (forward and
    backward, no recompute) over a batch.
The kernel-name groups say which device kernels each per-layer metric
reads.
"""
from __future__ import annotations

import numpy as np

from perf_bench.spec import cemb, cnoise, conv_calls, heads, layout

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12                            # H100 SXM, HBM3
ITEM = {"bfloat16": 2, "float32": 4}

# Device-kernel names by group (substrings of the kernels' names).
DECODE_BLOCK_KERNELS = ("decode_block_tc", "decode_prologue_kernel", "decode_conv_kernel")
ATTENTION_KERNELS = ("flash_attn_",)
CONV_FWD_KERNELS = ("fused_conv_fwd_kernel", "conv_fwd_prologue", "conv_fwd_pack_w",
                    "conv_fwd_tc")
CONV_BWD_KERNELS = ("transpose_w_kernel", "dx_kernel", "dw_kernel", "conv_bwd_prologue",
                    "conv_bwd_grad_prologue", "conv_bwd_pack_w", "conv_bwd_dx_tc",
                    "conv_bwd_dw_tc", "dw_finalize", "dcv_finalize", "dgates_kernel")


def in_group(name: str, group) -> bool:
    return any(k in name for k in group)


def bound_s(flops, nbytes, dtype="bfloat16") -> float:
    """The least seconds: the larger of the operations' and the bytes' floors."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def train_frame_mask(n_frames: int) -> np.ndarray:
    """(2T, 2T) DART mask at frame granularity: clean query i sees clean
    frames <= i; noisy query T + i sees clean frames < i and itself."""
    t = n_frames
    q = np.arange(2 * t)[:, None]
    k = np.arange(2 * t)[None, :]
    clean_q, clean_k = q < t, k < t
    return ((clean_q & clean_k & (k <= q)) | ((~clean_q) & clean_k & (k < q - t))
            | ((~clean_q) & (~clean_k) & (q == k)))


def flash_cost(kind, b, nheads, n_frames, hw, d, dtype):
    """((forward operations, bytes), (backward operations, bytes)) of one
    flash-attention call, kind "dart" (S = 2 n_frames hw) or "full" (S = hw),
    over the (query, key) pairs the mask lets through; the backward as the
    kernels run it (the softmax recomputed)."""
    if kind == "dart":
        s = 2 * n_frames * hw
        pairs = int(train_frame_mask(n_frames).sum()) * hw * hw
    else:
        s = hw
        pairs = s * s
    bh = b * nheads
    mat = bh * s * d * ITEM[dtype]
    return ((4 * d * pairs * bh, 4 * mat + 4 * bh * s),
            (10 * d * pairs * bh, 8 * mat + 4 * bh * s))


def _block_parts(shape, with_ctx=True):
    """(operations, activation elements, weight elements) of one fused Block
    step, shape = (H, Cin, C0, Co, flavor, has_skip)."""
    h, cin, c0, co, _, has_skip = shape
    taps = 27 if with_ctx else 9
    hw = h * h
    flops = 2 * hw * (taps * c0 * co + taps * co * co + (cin * co if has_skip else 0))
    acts = hw * cin + (2 * hw * (c0 + co) if with_ctx else 0) + co + hw * (co + c0 + co)
    weights = taps * (c0 + co) * co + (cin * co if has_skip else 0)
    return flops, acts, weights


def block_cost(shape, dtype="bfloat16", with_ctx=True):
    """(operations, bytes) of one fused decode-Block call at batch 1."""
    flops, acts, weights = _block_parts(shape, with_ctx)
    return flops, (acts + weights) * ITEM[dtype] + 8


def block_bound_s(shape, batch, dtype="bfloat16", with_ctx=True) -> float:
    """The least seconds of one decode-Block launch over `batch` sessions:
    operations and activations scale with the batch, the weights are read once."""
    flops, acts, weights = _block_parts(shape, with_ctx)
    return bound_s(batch * flops, (batch * acts + weights) * ITEM[dtype] + 8 * batch, dtype)


def conv_cost(b, f, h, w, c, co, has_cv, with_ctx, dtype="bfloat16"):
    """((forward operations, bytes), (backward operations, bytes)) of the
    train-mode fused gated conv; the backward's dx counts the context taps
    that exist (not the ones frames before the clip), its dw every product
    of the forward."""
    t = f // 2
    mac = b * h * w * c * co * 9
    item = ITEM[dtype]
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


def denoiser_call_cost(cfg, dtype, ring_frames: int, weight_item: int = 4) -> list:
    """[(layer, route, operations, bytes)] of one cached T = 1 denoiser call
    at batch 1 against K/V rings holding `ring_frames` frames. route:
    "decode_block", "full_attention" or "plain". Elementwise work is not
    counted."""
    item = ITEM[dtype]
    rows = []

    def add(layer, route, flops, acts, weights):
        rows.append((layer, route, flops, acts * item + weights * weight_item))

    emb_w = cnoise(cfg) * cemb(cfg) + cfg.get("label_dim", 0) * cemb(cfg)
    add("embedding", "plain", 2 * emb_w,
        2 * cnoise(cfg) + cfg.get("label_dim", 0) + cemb(cfg), emb_w)
    for side, name, spec in layout(cfg):
        lyr = name if side == "out" else f"{side}_{name}"
        res, cin, co = spec["res"], spec["cin"], spec["cout"]
        hw = res * res
        if spec["kind"] == "conv":
            add(lyr, "plain", 2 * hw * 27 * cin * co, hw * (cin + co) + 2 * hw * cin,
                27 * cin * co)
            continue
        add(f"{lyr}.emb_linear", "plain", 2 * cemb(cfg) * co, cemb(cfg) + co, cemb(cfg) * co)
        c0 = co if spec["flavor"] == "enc" else cin
        flops, acts, weights = _block_parts((res, cin, c0, co, spec["flavor"], cin != co))
        nh = heads(cfg, spec)
        add(f"{lyr}.convs", "plain" if nh else "decode_block", flops, acts, weights)
        if not nh:
            continue
        d = co // nh
        add(f"{lyr}.attn_qkv_proj", "plain", 2 * hw * 4 * co * co,
            hw * (co + 3 * co + 2 * co), 4 * co * co)
        if spec["attention"] == "video":
            keys = (ring_frames + 1) * hw
            add(f"{lyr}.attention", "plain", 4 * d * nh * hw * keys, 2 * ring_frames * hw * co, 0)
        else:
            (f_ops, f_bytes), _ = flash_cost("full", 1, nh, 1, hw, d, dtype)
            rows.append((f"{lyr}.attention", "full_attention", f_ops, f_bytes))
    return rows


def _forward_products(cfg, b, t, just_2d):
    """[(kind, forward operations)] of one train-mode forward over b clips of
    t frames: the DART concat of 2t frames, or t frames under just_2d."""
    f = t if just_2d else 2 * t
    ce = cemb(cfg)
    out = [("dense", 2 * b * f * (cnoise(cfg) * ce + cfg.get("label_dim", 0) * ce))]
    for _, _, spec in layout(cfg):
        res, cin, co = spec["res"], spec["cin"], spec["cout"]
        hw = res * res
        if spec["kind"] == "conv":
            (fw, _), _ = conv_cost(b, f, res, res, cin, co, False, not just_2d)
            out.append(("input_conv" if not out[1:] else "conv", fw))
            continue
        out.append(("dense", 2 * b * f * ce * co))  # emb_linear
        if cin != co:
            out.append(("dense", 2 * b * f * hw * cin * co))  # 1x1 skip
        c0 = co if spec["flavor"] == "enc" else cin
        for ci in (c0, co):
            (fw, _), _ = conv_cost(b, f, res, res, ci, co, False, not just_2d)
            out.append(("conv", fw))
        nh = heads(cfg, spec)
        if not nh:
            continue
        d = co // nh
        out.append(("dense", 2 * b * f * hw * 4 * co * co))  # qkv and projection
        if spec["attention"] == "video" and not just_2d:
            pairs = int(train_frame_mask(t).sum()) * hw * hw
        else:
            pairs = f * hw * hw
        out.append(("attention", 4 * d * pairs * b * nh))
    return out


def train_step_cost(cfg, b, t, just_2d) -> float:
    """Operations of one training step over b clips of t frames: the
    forward's products and, for the backward, twice each (the input's and
    the weight's gradient; the attention's four products without the
    recomputed softmax), but for the input conv, whose input needs no
    gradient (once). Elementwise work is not counted."""
    total = 0.0
    for kind, fw in _forward_products(cfg, b, t, just_2d):
        total += fw * (2 if kind == "input_conv" else 3)
    return total


def train_conv_bound_s(cfg, b, t, just_2d, dtype="bfloat16") -> float:
    """Summed bounds (forward and backward) of every fused-conv call of one
    microbatch's forward and backward: b clips of t frames."""
    f = t if just_2d else 2 * t
    total = 0.0
    for h, c, co, has_cv in conv_calls(cfg):
        (fo, fb), (bo, bb) = conv_cost(b, f, h, h, c, co, has_cv, not just_2d, dtype)
        total += bound_s(fo, fb, dtype) + bound_s(bo, bb, dtype)
    return total
