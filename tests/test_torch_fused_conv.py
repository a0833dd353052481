"""The port's train-mode fused gated conv on the CPU, where the wrapper runs
its plain version: forward and all five gradients against the JAX package's
oracle `fused_gated_conv_reference` (through pack_x / unpack_out on the JAX
side only) and `jax.grad` of it, for every flag combination, fp32, at
max |diff| <= 1e-4 (fp32 sums in another order); and once against the
Pallas kernel itself in interpret mode. Inputs come from seeded numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.ops import fused_conv as jfc
from autoregressive_diffusion_tpu_torch.ops import fused_conv as fc

TOL = 1e-4
B, T, H, W, C, CO = 2, 3, 8, 16, 9, 8
NAMES = ("x", "w2", "w3", "cvec", "gates")


def make_inputs(seed=0, c=C, co=CO):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.normal(size=(B, 2 * T, H, W, c)).astype(f32),
        w2=(0.2 * rng.normal(size=(3, 3, c, co))).astype(f32),
        w3=(0.2 * rng.normal(size=(2, 3, 3, c, co))).astype(f32),
        cvec=(1 + 0.1 * rng.normal(size=(B, 2 * T, c))).astype(f32),
        gates=rng.uniform(0.05, 0.95, size=(B, 2 * T)).astype(f32),
        probe=np.cos(0.37 * np.arange(B * 2 * T * H * W * co)).reshape(
            B, 2 * T, H, W, co).astype(f32))


def jax_conv(fn, x, w2, w3, cvec, gates, silu_in, with_ctx, *extra):
    """fn (the oracle or the Pallas kernel) on the port's layouts."""
    b, t2 = x.shape[:2]
    t = t2 // 2
    cvp = (None if cvec is None
           else cvec.reshape(b, 2, t, -1).transpose(0, 2, 1, 3))
    gp = gates.reshape(b, 2, t).transpose(0, 2, 1)
    o = fn(jfc.pack_x(x, H, W), w2, w3, cvp, gp, H, W, silu_in, with_ctx, *extra)
    return jfc.unpack_out(o, H, W, w2.shape[-1])


def torch_run(inp, silu_in, has_cv, with_ctx):
    """(out, grads by name) of the port's wrapper on CPU tensors."""
    leaves = {n: torch.from_numpy(inp[n]).requires_grad_(True) for n in NAMES}
    before = (fc.conv_fwd_launches, fc.conv_bwd_launches)
    out = fc.fused_gated_conv(leaves["x"], leaves["w2"], leaves["w3"],
                              leaves["cvec"] if has_cv else None, leaves["gates"],
                              silu_in, with_ctx)
    (out * torch.from_numpy(inp["probe"])).sum().backward()
    # the launch counters move only where a kernel is launched
    assert (fc.conv_fwd_launches, fc.conv_bwd_launches) == before
    return out.detach().numpy(), {n: l.grad for n, l in leaves.items()}


@pytest.mark.parametrize("silu_in", [True, False])
@pytest.mark.parametrize("has_cv", [True, False])
@pytest.mark.parametrize("with_ctx", [True, False])
def test_plain_matches_jax_reference(silu_in, has_cv, with_ctx):
    inp = make_inputs()
    out_t, grads_t = torch_run(inp, silu_in, has_cv, with_ctx)

    def loss(x, w2, w3, cvec, gates):
        o = jax_conv(jfc.fused_gated_conv_reference, x, w2, w3,
                     cvec if has_cv else None, gates, silu_in, with_ctx)
        return jnp.sum(o * inp["probe"]), o

    args = [jnp.asarray(inp[n]) for n in NAMES]
    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                             has_aux=True)(*args)
    assert out_t.shape == out_j.shape == (B, 2 * T, H, W, CO)
    assert np.abs(out_t - np.asarray(out_j)).max() <= TOL
    for name, gj in zip(NAMES, grads_j):
        gt = grads_t[name]
        unused = ((name == "cvec" and not has_cv)
                  or (name in ("w3", "gates") and not with_ctx))
        if unused:  # no gradient reaches an unread argument
            assert gt is None and float(jnp.abs(gj).max()) == 0.0, name
            continue
        assert np.abs(gt.numpy() - np.asarray(gj)).max() <= TOL, name


def test_plain_matches_pallas_kernel_interpret():
    """Forward and gradients against the TPU kernel run in interpret mode
    (its channel padding included: C=9 is padded to 16 on that side)."""
    inp = make_inputs(seed=1)
    out_t, grads_t = torch_run(inp, True, True, True)

    def loss(x, w2, w3, cvec, gates):
        o = jax_conv(jfc.fused_gated_conv, x, w2, w3, cvec, gates, True, True, True)
        return jnp.sum(o * inp["probe"]), o

    args = [jnp.asarray(inp[n]) for n in NAMES]
    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                             has_aux=True)(*args)
    assert np.abs(out_t - np.asarray(out_j)).max() <= TOL
    for name, gj in zip(NAMES, grads_j):
        assert np.abs(grads_t[name].numpy() - np.asarray(gj)).max() <= TOL, name


def test_just_2d_takes_an_odd_frame_count_and_no_context_arguments():
    inp = make_inputs(seed=2)
    x = torch.from_numpy(inp["x"][:, :5])
    w2 = torch.from_numpy(inp["w2"])
    out = fc.fused_gated_conv(x, w2, None, None, None, False, False)
    want = fc._conv3x3(x.reshape(-1, H, W, C), w2).reshape(B, 5, H, W, CO)
    assert out.shape == (B, 5, H, W, CO)
    assert float((out - want).abs().max()) <= 1e-6


def test_bf16_rounds_where_the_kernels_round():
    """bf16: the transform is fp32 and rounded to bf16 once, products are
    summed in fp32, the result is rounded once."""
    inp = make_inputs(seed=3)
    t = {n: torch.from_numpy(inp[n]) for n in NAMES}
    bf = {n: (v if n == "gates" else v.bfloat16()) for n, v in t.items()}
    out = fc.fused_gated_conv(bf["x"], bf["w2"], bf["w3"], bf["cvec"], bf["gates"], True, True)
    assert out.dtype == torch.bfloat16
    a = fc._silu_f32(bf["x"].float() * bf["cvec"].float()[:, :, None, None, :])
    a = a.bfloat16().float()
    ones = torch.ones_like(a[:, :2])
    hist = torch.cat([ones, a[:, :T - 1]], dim=1)
    y2d = fc._conv3x3(a.reshape(-1, H, W, C), bf["w2"]).reshape(B, 2 * T, H, W, CO)
    ctx = (fc._conv3x3(hist[:, :T].reshape(-1, H, W, C), bf["w3"][0])
           + fc._conv3x3(hist[:, 1:].reshape(-1, H, W, C), bf["w3"][1])).reshape(B, T, H, W, CO)
    g = bf["gates"][:, :, None, None, None]
    want = ((y2d + (torch.cat([ctx, ctx], 1) - y2d) * g)
            * torch.rsqrt((1 - g) ** 2 + g ** 2)).bfloat16()
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# The bf16 kernels' decomposition (csrc/conv_tc.cuh, fused_conv_fwd.cu,
# fused_conv_bwd.cu), written out in torch: the padded buffer with its two
# ones frames, each tap a shifted read of the zero-padded halo, the
# transposed convolution of dx on flipped weights, dcvec as per-tile partial
# sums, dw as per-share partial sums of (frame, tile) units summed in share
# order, and dy2d / dctx rounded to bf16 where the kernel rounds them.

def _mp_dsilu(z):
    """mp_silu's derivative (conv_tile.cuh::mp_dsilu)."""
    s = torch.sigmoid(z)
    return s * (1 + z * (1 - s)) / 0.596


def _taps(buf, wk, h, w):
    """sum over the 9 taps of buf shifted by the tap (buf zero-padded by one
    pixel: (..., h + 2, w + 2, K)) times wk[tap] (3, 3, K, N)."""
    return sum(buf[..., dy:dy + h, dx:dx + w, :] @ wk[dy, dx] for dy in range(3) for dx in range(3))


def _pad(t, k):
    """(..., h, w, c) -> (..., h + 2, w + 2, k): the halo's zero pixels and
    channels up to k."""
    return torch.nn.functional.pad(t, (0, k - t.shape[-1], 1, 1, 1, 1))


def _tiles(h, w):
    return [(y, x) for y in range(0, h, 8) for x in range(0, w, 8)]


def _dw_shares(a_frames, d_frames, h, w, shares):
    """sum_p a(p + tap) d(p) as the weight-gradient kernel sums it: units
    (frame, 8x8 tile) dealt to `shares` shares (u = s, s + S, ...), a partial
    sum a share, then the partials in share order. a_frames (n, h + 2, w + 2,
    Cp) padded, d_frames (n, h, w, Co) -> (3, 3, Cp, Co)."""
    tiles = _tiles(h, w)
    units = [(fr, t) for fr in range(a_frames.shape[0]) for t in tiles]
    parts = []
    for s in range(shares):
        part = torch.zeros((3, 3, a_frames.shape[-1], d_frames.shape[-1]))
        for fr, (y0, x0) in units[s::shares]:
            ny, nx = min(8, h - y0), min(8, w - x0)
            d = d_frames[fr, y0:y0 + ny, x0:x0 + nx].reshape(-1, d_frames.shape[-1])
            for dy in range(3):
                for dx in range(3):
                    a = a_frames[fr, y0 + dy:y0 + dy + ny, x0 + dx:x0 + dx + nx]
                    part[dy, dx] += a.reshape(-1, a.shape[-1]).T @ d
        parts.append(part)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def kernel_decomposition(x, w2, w3, cvec, gates, gout, silu_in, with_ctx, round_grads,
                         shares=3):
    """(out, dx, dw2, dw3, dcvec, dgates) the way the bf16 kernels compute
    them, in fp32 throughout but for dy2d and dctx, which are rounded to
    bf16 when round_grads is set."""
    b, f, h, w, c = x.shape
    co, t = w2.shape[-1], f // 2
    cp, cop = -(-c // 16) * 16, -(-co // 16) * 16
    nones = 2 if with_ctx else 0
    z = x * cvec[:, :, None, None, :] if cvec is not None else x
    a = fc._silu_f32(z) if silu_in else z
    # the forward prologue's buffer (B, F + nones, H + 2, W + 2, Cp): ones frames first
    buf = _pad(torch.cat([torch.ones((b, nones, h, w, c)), a], 1), cp)
    buf[:, :nones, :, :, c:] = 0.0

    def packed(wk, kin, kout):  # (3, 3, C, Co) padded to (3, 3, kin, kout)
        return torch.nn.functional.pad(wk, (0, kout - wk.shape[-1], 0, kin - wk.shape[-2]))

    y2d = _taps(buf[:, nones:], packed(w2, cp, cop), h, w)[..., :co]
    g = r = diff = None
    if with_ctx:
        # ctx[t] reads buffer frames t and t + 1: h[t] and h[t + 1]
        ctx = (_taps(buf[:, :t], packed(w3[0], cp, cop), h, w)
               + _taps(buf[:, 1:t + 1], packed(w3[1], cp, cop), h, w))[..., :co]
        g = gates[:, :, None, None, None]
        r = torch.rsqrt((1 - g) ** 2 + g ** 2)
        diff = torch.cat([ctx, ctx], 1) - y2d
        out = (y2d + diff * g) * r
        dy2d = gout * (1 - g) * r
        dctx = gout[:, :t] * (g * r)[:, :t] + gout[:, t:] * (g * r)[:, t:]
    else:
        out, dy2d, dctx = y2d, gout, None
    if round_grads and with_ctx:
        dy2d, dctx = dy2d.bfloat16().float(), dctx.bfloat16().float()

    def flipped(wk):  # the dx convolution's weights: taps flipped, channel axes swapped
        return packed(wk.flip(0, 1).transpose(-1, -2), cop, c)

    dy_pad = _pad(dy2d, cop)
    da = _taps(dy_pad, flipped(w2), h, w)
    if with_ctx:
        dctx_pad = _pad(dctx, cop)
        clean = torch.zeros_like(da[:, :t])
        # clean frame t is h[t + 2]: ctx[t + 1] read it through w3[1], ctx[t + 2] through w3[0]
        clean[:, :t - 1] += _taps(dctx_pad[:, 1:], flipped(w3[1]), h, w)
        clean[:, :t - 2] += _taps(dctx_pad[:, 2:], flipped(w3[0]), h, w)
        da = da + torch.cat([clean, torch.zeros_like(clean)], 1)
    dz = da * (_mp_dsilu(z) if silu_in else 1.0)
    dx = dz * cvec[:, :, None, None, :] if cvec is not None else dz
    dcvec = None
    if cvec is not None:  # per-tile partial sums, then the tiles in order
        prod = dz * x
        dcvec = sum(prod[:, :, y0:y0 + 8, x0:x0 + 8].sum((2, 3)) for y0, x0 in _tiles(h, w))
    # weight gradients: kind 0 every frame's (a[f], dy2d[f]); w3[k] (h[t + k], dctx[t])
    dw2 = _dw_shares(buf[:, nones:].reshape(b * f, h + 2, w + 2, cp), dy2d.reshape(b * f, h, w, co),
                     h, w, shares)[:, :, :c]
    dw3 = dgates = None
    if with_ctx:
        dw3 = torch.stack([_dw_shares(buf[:, k:t + k].reshape(b * t, h + 2, w + 2, cp),
                                      dctx.reshape(b * t, h, w, co), h, w, shares)[:, :, :c]
                           for k in (0, 1)])
        dgates = (gout * (diff * r - out * (2 * g - 1) * r * r)).sum((2, 3, 4))
    return out, dx, dw2, dw3, dcvec, dgates


@pytest.mark.parametrize("silu_in,has_cv,with_ctx", [(True, True, True), (False, False, True),
                                                     (True, True, False)])
def test_kernel_decomposition_matches_jax_reference(silu_in, has_cv, with_ctx):
    """The decomposition, fp32 with the bf16 rounding of dy2d / dctx off,
    against the JAX oracle and jax.grad at TOL; with the rounding on, within
    bf16's precision of it (std(diff)/std(ref) <= 1e-2, the card's bf16
    tolerance)."""
    inp = make_inputs(seed=4)
    t = {n: torch.from_numpy(inp[n]) for n in NAMES}
    gout = torch.from_numpy(inp["probe"])
    cv = t["cvec"] if has_cv else None
    got = kernel_decomposition(t["x"], t["w2"], t["w3"], cv, t["gates"], gout, silu_in,
                               with_ctx, round_grads=False)

    def loss(x, w2, w3, cvec, gates):
        o = jax_conv(jfc.fused_gated_conv_reference, x, w2, w3,
                     cvec if has_cv else None, gates, silu_in, with_ctx)
        return jnp.sum(o * inp["probe"]), o

    args = [jnp.asarray(inp[n]) for n in NAMES]
    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                             has_aux=True)(*args)
    want = [np.asarray(out_j)] + [np.asarray(gj) for gj in grads_j]
    rounded = kernel_decomposition(t["x"], t["w2"], t["w3"], cv, t["gates"], gout, silu_in,
                                   with_ctx, round_grads=True)
    for name, g, r, wj in zip(("out",) + NAMES, got, rounded, want):
        if g is None:  # an unread argument: no gradient reaches it
            assert float(np.abs(wj).max()) == 0.0, name
            continue
        assert g.shape == wj.shape, name
        assert np.abs(g.numpy() - wj).max() <= TOL, name
        rel = np.std(r.numpy() - wj) / np.std(wj)
        assert rel <= 1e-2, (name, rel)
