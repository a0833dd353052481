"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: without a CUDA device each test skips with the reason (the
kernels have no CPU mode; their plain versions are held against the JAX
package in test_torch_ops.py, test_torch_decode_block.py,
test_torch_fused_conv.py and test_torch_flash_attention.py). On the card
(tests/conftest.py sets up JAX, which these tests do not need):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
from autoregressive_diffusion_tpu_torch.ops import fused_conv as fc
from autoregressive_diffusion_tpu_torch.ops import masks
from autoregressive_diffusion_tpu_torch.ops.numerics import mp_weight


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got, want):
    return float((got.float() - want.float()).std() / want.float().std())


PREFILL_SHAPES = [  # b, heads, d, hw, t_new, f_total, offset
    (1, 4, 64, 64, 8, 8, 0), (1, 4, 64, 64, 8, 64, 0), (1, 4, 64, 64, 2, 64, 10),
    (1, 4, 64, 64, 8, 64, 60), (1, 4, 64, 64, 3, 5, 0),  # the rollout's head shape
    (1, 4, 16, 64, 8, 64, 0),     # d = 16
    (1, 4, 32, 64, 2, 64, 10),    # d = 32, the re-prime
    (1, 2, 128, 64, 8, 64, 60),   # d = 128, the wrapped ring
    (2, 4, 64, 40, 8, 64, 60),    # hw = 40: frames split across tiles; batch 2, wrapped
    (1, 3, 64, 40, 2, 64, 10),    # hw = 40, the re-prime
    (2, 2, 64, 40, 5, 5, 0),      # hw = 40, fresh causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_prefill_kernel_matches_plain(cuda, dtype, shape):
    """The rollout's shapes, other head dims, frames that straddle 64-row
    tiles (the per-token mask of partly visible tiles), batch 2, the
    wrapped ring and the re-prime."""
    b, heads, d, hw, t_new, f_total, offset = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    q = (torch.randn((b, heads, t_new * hw, d), generator=g, device=cuda) * d ** -0.5).to(dtype)
    k = torch.randn((b, heads, f_total * hw, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, heads, f_total * hw, d), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.prefill_attention(q, k, v, t_new, f_total, offset, hw)
    want = fa.prefill_attention_plain(q, k, v, t_new, f_total, offset, hw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        assert rel_err(got, want) <= 1e-2


def misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past an aligned
    address (a view at an odd storage offset)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return buf.view(t.shape).copy_(t)


@pytest.mark.cuda
def test_misaligned_bf16_views_are_taken(cuda):
    """bf16 views that do not start on a 16-byte boundary go through the
    flash and prefill wrappers (copied before the TMA launch) and give the
    plain versions' results."""
    g = torch.Generator(device=cuda).manual_seed(4)
    hw, t_new, f_total = 64, 2, 8
    q, k, v = ((torch.randn((1, 4, n * hw, 64), generator=g, device=cuda) / 8).bfloat16()
               for n in (t_new, f_total, f_total))
    qm, km, vm = misaligned(q), misaligned(k), misaligned(v)
    assert qm.data_ptr() % 16 and qm.is_contiguous()
    got = fa.prefill_attention(qm, km, vm, t_new, f_total, 3, hw)
    want = fa.prefill_attention_plain(q, k, v, t_new, f_total, 3, hw)
    assert rel_err(got, want) <= 1e-2
    qs, k, v, do = flash_inputs(cuda, torch.bfloat16, "dart", 1, 2, 2, 64, 64, seed=8)
    qs_m, k_m, v_m, do_m = (misaligned(a) for a in (qs, k, v, do))
    o, lse = fa.flash_attention_fwd(qs_m, k_m, v_m, "dart", 2, 64)
    o_p, lse_p = fa.flash_attention_fwd_plain(qs, k, v, "dart", 2, 64)
    grads = fa.flash_attention_bwd(qs_m, k_m, v_m, misaligned(o_p), lse_p, do_m, "dart", 2, 64)
    grads_p = fa.flash_attention_bwd_plain(qs, k, v, o_p, lse_p, do, "dart", 2, 64)
    torch.cuda.synchronize()
    assert rel_err(o, o_p) <= 1e-2
    assert float((lse - lse_p).abs().max()) <= flash_tol(lse_p, qs.shape[2])
    for a, w in zip(grads, grads_p):
        assert rel_err(a, w) <= 1e-2


def gym_block_shapes():
    """(H, Cin, C0, Co, flavor, has_skip) of the gym denoiser's 17
    attention-free Blocks, in execution order (chip_smoke.py's
    decode_block_shapes)."""
    from autoregressive_diffusion_tpu_torch.generate import GYM_CONFIG
    from autoregressive_diffusion_tpu_torch.models import UNetConfig
    out = []
    for _, _, spec in UNetConfig(**GYM_CONFIG).block_layout():
        if spec["kind"] == "block" and spec["attention"] is None:
            cin, co = spec["cin"], spec["cout"]
            c0 = co if spec["flavor"] == "enc" else cin
            out.append((spec["res"], cin, c0, co, spec["flavor"], cin != co))
    return out


def block_args(dev, dtype, shape, with_ctx, b=1, seed=1):
    h, cin, c0, co, flavor, skip = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    return [rn(b, 1, h, h, cin).to(dtype),
            rn(b, 2, h, h, c0).to(dtype) if with_ctx else None,
            rn(b, 2, h, h, co).to(dtype) if with_ctx else None,
            mp_weight(rn(cin, co)).to(dtype) if skip else None,
            mp_weight(rn(3, 3, c0, co)).to(dtype), mp_weight(rn(2, 3, 3, c0, co)).to(dtype),
            mp_weight(rn(3, 3, co, co)).to(dtype), mp_weight(rn(2, 3, 3, co, co)).to(dtype),
            (1 + 0.5 * rn(b, co)).to(dtype), 0.1 + 0.8 * torch.rand((b, 2), generator=g,
                                                                     device=dev)]


BLOCK_CASES = (  # (H, Cin, C0, Co, flavor, has_skip), batch
    [(s, 1) for s in gym_block_shapes()]                         # the gym model's 17 Blocks
    + [((16, 16, 16, 16, "enc", False), 1), ((8, 256, 256, 256, "dec", False), 1)]
    + [((16, 256, 256, 256, "dec", False), 2), ((32, 32, 64, 64, "enc", True), 2),
       ((24, 40, 24, 24, "enc", True), 2),    # ragged tiles; a stage part empty (24 channels)
       ((20, 20, 20, 12, "dec", True), 2)])   # channels no multiple of 8: no cp.async


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BLOCK_CASES)
@pytest.mark.parametrize("with_ctx", [True, False])
def test_decode_block_kernel_matches_plain(cuda, dtype, case, with_ctx):
    """Every attention-free Block of the gym denoiser, small and odd
    shapes, and batch 2 (each row its own gates, modulation and rings),
    with and without the context, against the plain version."""
    shape, b = case
    args = block_args(cuda, dtype, shape, with_ctx, b=b)
    before = fc.launches
    got = fc.fused_decode_block(*args, shape[4], 0.3, 256.0, with_ctx)
    want = fc.fused_decode_block_plain(*args, shape[4], 0.3, 256.0, with_ctx)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-3
        else:
            assert rel_err(a, w) <= 1e-2


def cs_block_shapes():
    """(H, Cin, C0, Co, flavor, has_skip) of the CS denoiser's 17
    attention-free Blocks, distinct, in execution order."""
    from autoregressive_diffusion_tpu_torch.cs_train import cs_config
    out = []
    for _, _, spec in cs_config().block_layout():
        if spec["kind"] == "block" and spec["attention"] is None:
            cin, co = spec["cin"], spec["cout"]
            c0 = co if spec["flavor"] == "enc" else cin
            if (spec["res"], cin, c0, co, spec["flavor"], cin != co) not in out:
                out.append((spec["res"], cin, c0, co, spec["flavor"], cin != co))
    return out


WIDE_BLOCKS = (  # C0 up to the prologue's Cin limit of 1024
    cs_block_shapes()                      # 4x4 Blocks and dec 16x16 C0 = 768 among them
    + [(8, 1024, 1024, 512, "dec", True),  # dec C0 = Cin = 1024
       (4, 1024, 1024, 512, "dec", True),  # the same on a frame smaller than a tile
       (8, 512, 1024, 1024, "enc", True),  # enc C0 = Co = 1024
       (16, 768, 768, 768, "dec", False)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WIDE_BLOCKS)
@pytest.mark.parametrize("with_ctx", [True, False])
def test_decode_block_kernel_at_wide_c0(cuda, dtype, shape, with_ctx):
    """Every attention-free Block of the CS denoiser and C0 = 768 and 1024
    (dec and enc) against the plain version, as above."""
    fc.check_decode_block_shape(1, 1, shape[0], shape[0], *shape[1:4], shape[4], shape[5])
    args = block_args(cuda, dtype, shape, with_ctx, seed=5)
    before = fc.launches
    got = fc.fused_decode_block(*args, shape[4], 0.3, 256.0, with_ctx)
    want = fc.fused_decode_block_plain(*args, shape[4], 0.3, 256.0, with_ctx)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-3
        else:
            assert rel_err(a, w) <= 1e-2


@pytest.mark.cuda
def test_serving_bf16_kernels_repeat_bit_for_bit(cuda):
    """The bf16 prefill and decode-Block kernels, run twice on the same
    inputs, give the same bits: the split reductions are summed in a fixed
    order, without atomics."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn((1, 4, n * 64, 64), generator=g, device=cuda).bfloat16()
               for n in (8, 64, 64))

    def prefill():
        return fa.prefill_attention(q, k, v, 8, 64, 60, 64)

    first = prefill().clone()
    assert torch.equal(first, prefill())
    for shape in [(8, 256, 256, 256, "dec", False), (16, 256, 256, 256, "dec", False),
                  (64, 96, 96, 32, "dec", True)]:
        args = block_args(cuda, torch.bfloat16, shape, True, seed=13)
        first = [t.clone() for t in fc.fused_decode_block(*args, shape[4], 0.3, 256.0, True)]
        second = fc.fused_decode_block(*args, shape[4], 0.3, 256.0, True)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b), shape


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda):
    q = torch.zeros((1, 4, 64, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.prefill_attention(q, q, q, 1, 1, 0, 64)
    x = torch.zeros((1, 2, 8, 8, 16), device=cuda)
    w = torch.zeros((3, 3, 16, 16), device=cuda)
    with pytest.raises(ValueError):  # T=2 is not the decode step
        fc.fused_decode_block(x, None, None, None, w, None, w, None,
                              torch.zeros((1, 16), device=cuda),
                              torch.zeros((1, 2), device=cuda), "enc", 0.3, None, False)


# ---------------------------------------------------------------------------
# train-mode fused gated conv: forward and backward kernels

def conv_inputs(dev, dtype, b, t2, h, w, c, co, has_cv, with_ctx, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=g, device=dev)

    x = rn(b, t2, h, w, c).to(dtype)
    w2 = mp_weight(rn(3, 3, c, co)).to(dtype)
    w3 = mp_weight(rn(2, 3, 3, c, co)).to(dtype) if with_ctx else None
    cv = (1 + 0.3 * rn(b, t2, c)).to(dtype) if has_cv else None
    gates = (0.05 + 0.9 * torch.rand((b, t2), generator=g, device=dev)) if with_ctx else None
    gout = rn(b, t2, h, w, co).to(dtype)
    return [x, w2, w3, cv, gates], gout


def conv_run(fn, args, gout, silu_in, with_ctx):
    """(out, {name: grad}) of fn on fresh leaf copies of args."""
    leaves = [None if a is None else a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*leaves, silu_in, with_ctx)
    out.backward(gout)
    names = ("dx", "dw2", "dw3", "dcvec", "dgates")
    return out.detach(), {n: l.grad for n, l in zip(names, leaves) if l is not None}


CONV_SHAPES = [  # b, 2T (or F), h, w, c, co
    (2, 6, 16, 16, 32, 32), (1, 6, 24, 40, 9, 32), (2, 4, 8, 8, 96, 64),
    (1, 8, 16, 16, 32, 8), (1, 2, 8, 8, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("silu_in,has_cv,with_ctx", [(True, True, True), (True, False, True),
                                                     (False, False, True), (True, True, False),
                                                     (False, False, False)])
def test_fused_conv_kernels_match_plain(cuda, dtype, shape, silu_in, has_cv, with_ctx):
    b, t2, h, w, c, co = shape
    if not with_ctx:
        t2 -= 1  # the just_2d step takes any frame count
    args, gout = conv_inputs(cuda, dtype, b, t2, h, w, c, co, has_cv, with_ctx)
    before = (fc.conv_fwd_launches, fc.conv_bwd_launches)
    out_k, grads_k = conv_run(fc.fused_gated_conv, args, gout, silu_in, with_ctx)
    assert (fc.conv_fwd_launches, fc.conv_bwd_launches) == (before[0] + 1, before[1] + 1)
    out_p, grads_p = conv_run(fc.fused_gated_conv_plain, args, gout, silu_in, with_ctx)
    torch.cuda.synchronize()
    assert set(grads_k) == set(grads_p)
    for name, got, want in [("out", out_k, out_p)] + [(n, grads_k[n], grads_p[n])
                                                      for n in grads_p]:
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if dtype == torch.float32:
            # the same fp32 products summed in another order: sums of up to
            # B*F*H*W terms (weight gradients), held relative to the largest
            # reference value
            tol = 2e-5 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol, name
        elif name == "dgates":
            # the kernel reads the residuals diff and out in bf16 where the
            # plain version's autograd keeps them in fp32: each of the
            # n = H*W*Co terms of a frame's sum is off by up to 2^-9 of its
            # size (about 1), so the sum is held to 4 * 2^-9 * sqrt(n)
            tol = 4 * 2 ** -9 * (h * w * co) ** 0.5
            assert float((got - want).abs().max()) <= tol, name
        else:
            assert rel_err(got, want) <= 1e-2, name


GYM_CONV_SHAPES = [  # b, 2T (or F), h, w, c, co
    (2, 4, 64, 64, 9, 32),    # the gym stem: C = 9, padded to 16 channels in bf16
    (2, 4, 64, 64, 32, 8),    # the gym out conv: Co = 8, a quarter of a 32-output tile
    (1, 4, 16, 16, 384, 96)]  # 24 16-channel chunks, a ragged 64-output tile


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GYM_CONV_SHAPES)
@pytest.mark.parametrize("silu_in,has_cv,with_ctx", [(True, True, True), (False, False, True),
                                                     (False, False, False)])
def test_fused_conv_kernels_match_plain_at_gym_widths(cuda, dtype, shape, silu_in, has_cv,
                                                      with_ctx):
    """The stem's and the out conv's channel counts at the gym's 64x64 and
    a deep 16x16 conv, held to chip_smoke.py's rules: fp32 as above; bf16
    at std(diff)/std(ref) <= 1e-2 for every output, and dgates, where that
    fails, to 4 * 2^-9 * sqrt(n) of max |diff| (at these widths and scales
    the terms of a frame's dgates sum are larger than 1, and the kernel and
    the plain version each stand about as far from an fp32 reference)."""
    b, t2, h, w, c, co = shape
    if not with_ctx:
        t2 -= 1
    args, gout = conv_inputs(cuda, dtype, b, t2, h, w, c, co, has_cv, with_ctx)
    out_k, grads_k = conv_run(fc.fused_gated_conv, args, gout, silu_in, with_ctx)
    out_p, grads_p = conv_run(fc.fused_gated_conv_plain, args, gout, silu_in, with_ctx)
    torch.cuda.synchronize()
    assert set(grads_k) == set(grads_p)
    for name, got, want in [("out", out_k, out_p)] + [(n, grads_k[n], grads_p[n])
                                                      for n in grads_p]:
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert bool(torch.isfinite(got).all()), name
        if dtype == torch.float32:
            tol = 2e-5 * max(1.0, float(want.abs().max()))
            assert float((got - want).abs().max()) <= tol, name
        elif rel_err(got, want) > 1e-2:
            assert name == "dgates", name
            tol = 4 * 2 ** -9 * (h * w * co) ** 0.5
            assert float((got - want).abs().max()) <= tol, name


@pytest.mark.cuda
def test_fused_conv_bf16_kernels_repeat_bit_for_bit(cuda):
    """The bf16 forward and backward, run twice on the same inputs, give the
    same bits: the weight gradients' shares and dcvec's tiles are summed in
    a fixed order, without atomics."""
    for shape, ctx in [((2, 6, 16, 16, 32, 32), True), ((2, 4, 8, 8, 96, 64), True),
                       ((1, 3, 24, 40, 9, 32), False)]:
        b, t2, h, w, c, co = shape
        args, gout = conv_inputs(cuda, torch.bfloat16, b, t2, h, w, c, co, True, ctx, seed=9)
        out1, g1 = conv_run(fc.fused_gated_conv, args, gout, True, ctx)
        out2, g2 = conv_run(fc.fused_gated_conv, args, gout, True, ctx)
        torch.cuda.synchronize()
        assert torch.equal(out1, out2), shape
        for name in g1:
            assert torch.equal(g1[name], g2[name]), (shape, name)


@pytest.mark.cuda
def test_fused_conv_takes_misaligned_bf16_views(cuda):
    """No TMA reads the caller's tensors: the bf16 prologues read x, cvec and
    gout element by element and write the aligned buffers the products read,
    so views that start 2 bytes past a 16-byte boundary are taken as they
    are and give the aligned inputs' results bit for bit."""
    args, gout = conv_inputs(cuda, torch.bfloat16, 1, 4, 16, 16, 32, 32, True, True, seed=10)
    moved = [a if a is None or a.dtype != torch.bfloat16 else misaligned(a) for a in args]
    assert moved[0].data_ptr() % 16 and moved[0].is_contiguous()
    out_a, g_a = conv_run(fc.fused_gated_conv, args, gout, True, True)
    out_m, g_m = conv_run(fc.fused_gated_conv, moved, misaligned(gout), True, True)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_m)
    for name in g_a:
        assert torch.equal(g_a[name], g_m[name]), name


@pytest.mark.cuda
def test_fused_conv_backward_is_the_forwards_derivative(cuda):
    """Directional finite differences of the forward KERNEL against the
    backward kernel's gradients, fp32, at a tiny shape."""
    args, gout = conv_inputs(cuda, torch.float32, 1, 4, 8, 8, 9, 8, True, True, seed=3)
    _, grads = conv_run(fc.fused_gated_conv, args, gout, True, True)
    g = torch.Generator(device=cuda).manual_seed(4)
    eps = 1e-2
    for i, name in enumerate(("dx", "dw2", "dw3", "dcvec", "dgates")):
        v = torch.randn(args[i].shape, generator=g, device=cuda)
        v = v / v.norm()
        vals = []
        for sgn in (1, -1):
            moved = list(args)
            moved[i] = args[i] + sgn * eps * v
            out = fc.fused_gated_conv(*moved, True, True)
            vals.append(float((out.double() * gout.double()).sum()))
        fd = (vals[0] - vals[1]) / (2 * eps)
        an = float((grads[name].double() * v.double()).sum())
        assert abs(fd - an) <= 2e-2 * max(1.0, abs(an)), (name, fd, an)


@pytest.mark.cuda
def test_fused_conv_refuses_bad_inputs(cuda):
    args, _ = conv_inputs(cuda, torch.float32, 1, 4, 8, 8, 16, 16, True, True)
    x, w2, w3, cv, gates = args
    with pytest.raises(ValueError):  # odd frame count with the context branch
        fc.fused_gated_conv(x[:, :3].contiguous(), w2, w3, None, gates[:, :3].contiguous(),
                            True, True)
    with pytest.raises(ValueError):  # not contiguous
        fc.fused_gated_conv(x.transpose(2, 3), w2, w3, cv, gates, True, True)
    with pytest.raises(ValueError):  # weights in another type
        fc.fused_gated_conv(x, w2.bfloat16(), w3, cv, gates, True, True)


# ---------------------------------------------------------------------------
# DART and full flash attention: forward and backward kernels

EPS32 = 6e-8  # fp32 unit roundoff

FLASH_SHAPES = [  # kind, b, heads, n_frames, hw, d  (full: S = hw)
    ("dart", 8, 4, 8, 64, 64),     # gym video layer, S = 1024
    ("full", 128, 2, 1, 256, 64),  # gym frame layer
    ("full", 64, 4, 1, 64, 64),    # gym just_2d video layer
    ("full", 1, 2, 1, 256, 64),    # serving frame layer, one frame: B*H = 2 at S = 256
    ("full", 8, 2, 1, 256, 64),    # serving prefill of 8 frames
    ("dart", 1, 2, 3, 40, 32),     # odd: hw not a multiple of the tile
    ("dart", 1, 2, 2, 40, 64),     # tiles straddle frames and the clean/noisy halves
    ("full", 3, 2, 1, 40, 32),
    ("dart", 2, 2, 2, 16, 16),
    ("dart", 1, 1, 2, 48, 128),
    ("full", 2, 2, 1, 100, 128),   # ragged S: one whole tile and 36 rows
    ("full", 2, 3, 1, 72, 16),     # ragged S, d = 16
    ("full", 1, 2, 1, 200, 32),
]


def flash_inputs(dev, dtype, kind, b, heads, n_frames, hw, d, seed=5):
    s = 2 * n_frames * hw if kind == "dart" else hw
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, heads, s, d), generator=g, device=dev) for _ in range(4))
    return (q * d ** -0.5).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)


def flash_tol(want, s):
    """fp32: the same products and exponentials summed in another order, a
    random walk of rounding errors over a sum of up to S terms, each step up
    to the unit roundoff of the largest value."""
    return 8 * EPS32 * s ** 0.5 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernels_match_plain(cuda, dtype, shape):
    kind, b, heads, n_frames, hw, d = shape
    qs, k, v, do = flash_inputs(cuda, dtype, kind, *shape[1:])
    s = qs.shape[2]
    before = (fa.dart_fwd_launches, fa.dart_bwd_launches, fa.full_fwd_launches,
              fa.full_bwd_launches)
    o, lse = fa.flash_attention_fwd(qs, k, v, kind, n_frames, hw)
    o_p, lse_p = fa.flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw)
    got = fa.flash_attention_bwd(qs, k, v, o_p, lse_p, do, kind, n_frames, hw)
    want = fa.flash_attention_bwd_plain(qs, k, v, o_p, lse_p, do, kind, n_frames, hw)
    torch.cuda.synchronize()
    after = (fa.dart_fwd_launches, fa.dart_bwd_launches, fa.full_fwd_launches,
             fa.full_bwd_launches)
    step = (1, 1, 0, 0) if kind == "dart" else (0, 0, 1, 1)
    assert after == tuple(a + s_ for a, s_ in zip(before, step))
    assert lse.dtype == torch.float32 and lse.shape == lse_p.shape
    assert float((lse - lse_p).abs().max()) <= flash_tol(lse_p, s)
    for name, a, w in [("o", o, o_p), ("dq", got[0], want[0]), ("dk", got[1], want[1]),
                       ("dv", got[2], want[2])]:
        assert a.shape == w.shape and a.dtype == w.dtype == dtype, name
        assert bool(torch.isfinite(a).all()), name
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= flash_tol(w, s), name
        else:
            assert rel_err(a, w) <= 1e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("sp_rank", [None, 1])
def test_flash_bf16_kernels_repeat_bit_for_bit(cuda, sp_rank):
    """The bf16 tensor-core kernels, run twice on the same inputs, give the
    same bits: no atomics and no sum whose order depends on scheduling."""
    n_frames, hw = 8, 64
    qs, k, v, do = flash_inputs(cuda, torch.bfloat16, "dart", 4, 2, n_frames, hw, 64, seed=11)
    if sp_rank is None:
        def run():
            o, lse = fa.flash_attention_fwd(qs, k, v, "dart", n_frames, hw)
            return (o, lse) + fa.flash_attention_bwd(qs, k, v, o, lse, do, "dart", n_frames, hw)
    else:
        sq = qs.shape[2] // 2
        q_r, do_r = (a[:, :, sp_rank * sq:(sp_rank + 1) * sq].contiguous() for a in (qs, do))

        def run():
            o, lse = fa.flash_attention_sp_fwd(q_r, k, v, "dart", n_frames, hw, sp_rank)
            return (o, lse) + fa.flash_attention_sp_bwd(q_r, k, v, o, lse, do_r, "dart",
                                                         n_frames, hw, sp_rank)
    first = [t.clone() for t in run()]
    second = run()
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n_frames,hw", [("dart", 2, 40), ("full", 1, 40)])
def test_flash_backward_is_the_forwards_derivative(cuda, kind, n_frames, hw):
    """Directional finite differences of the forward KERNEL against the
    backward kernels' gradients, fp32."""
    qs, k, v, do = flash_inputs(cuda, torch.float32, kind, 1, 2, n_frames, hw, 32, seed=6)
    o, lse = fa.flash_attention_fwd(qs, k, v, kind, n_frames, hw)
    grads = fa.flash_attention_bwd(qs, k, v, o, lse, do, kind, n_frames, hw)
    g = torch.Generator(device=cuda).manual_seed(7)
    eps = 1e-2
    args = [qs, k, v]
    for i, name in enumerate(("dq", "dk", "dv")):
        dirn = torch.randn(args[i].shape, generator=g, device=cuda)
        dirn = dirn / dirn.norm()
        vals = []
        for sgn in (1, -1):
            moved = list(args)
            moved[i] = args[i] + sgn * eps * dirn
            out, _ = fa.flash_attention_fwd(*moved, kind, n_frames, hw)
            vals.append(float((out.double() * do.double()).sum()))
        fd = (vals[0] - vals[1]) / (2 * eps)
        an = float((grads[i].double() * dirn.double()).sum())
        assert abs(fd - an) <= 2e-2 * max(1.0, abs(an)), (name, fd, an)


@pytest.mark.cuda
def test_flash_attention_refuses_bad_inputs(cuda):
    qs, k, v, do = flash_inputs(cuda, torch.float32, "dart", 1, 2, 2, 16, 32)
    with pytest.raises(ValueError):  # half precision
        fa.flash_attention_fwd(qs.half(), k.half(), v.half(), "dart", 2, 16)
    with pytest.raises(ValueError):  # S is not 2 * n_frames * hw
        fa.flash_attention_fwd(qs, k, v, "dart", 3, 16)
    with pytest.raises(ValueError):  # not contiguous
        fa.flash_attention_fwd(qs.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3),
                               "full", 1, 32)
    with pytest.raises(ValueError):  # k in another type
        fa.flash_attention_fwd(qs, k.bfloat16(), v, "full", 1, 64)
    with pytest.raises(ValueError):  # head dim 48
        x = torch.zeros((1, 1, 64, 48), device=cuda)
        fa.flash_attention_fwd(x, x, x, "full", 1, 64)
    o, lse = fa.flash_attention_fwd(qs, k, v, "dart", 2, 16)
    with pytest.raises(ValueError):  # lse of the wrong shape
        fa.flash_attention_bwd(qs, k, v, o, lse[:, :, :-1].contiguous(), do, "dart", 2, 16)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        fa.flash_attention_bwd(qs, k, v, o, lse, do.cpu(), "dart", 2, 16)


def attention_float64(q, k, v, kind, n_frames, hw):
    """The plain masked attention in float64 on q's device, differentiable:
    softmax(q k^T / sqrt(d)) v under the kind's mask."""
    qs = q.double() * q.shape[-1] ** -0.5
    logits = torch.einsum("...qc,...kc->...qk", qs, k.double())
    mask = fa._mask_of(qs, k, kind, n_frames, hw, None)
    return torch.einsum("...qk,...kc->...qc",
                        torch.softmax(logits.masked_fill(~mask, float("-inf")), -1), v.double())


@pytest.mark.cuda
def test_flash_attention_autograd_through_the_kernels(cuda):
    """dart_attention and full_attention under autograd on the card run the
    kernels, and their output and gradients equal a float64 version of the
    plain path computed on the card, within 8 roundoffs (flash_tol)."""
    qs, k, v, do = flash_inputs(cuda, torch.float32, "dart", 1, 2, 3, 40, 32, seed=8)
    for fn, args, mask in ((fa.dart_attention, (3, 40), ("dart", 3, 40)),
                           (fa.full_attention, (), ("full", 1, qs.shape[2]))):
        leaves = [a.detach().requires_grad_(True) for a in (qs, k, v)]
        before = fa.dart_bwd_launches + fa.full_bwd_launches
        out = fn(*leaves, *args)
        out.backward(do)
        assert fa.dart_bwd_launches + fa.full_bwd_launches == before + 1
        ref = [a.detach().double().requires_grad_(True) for a in (qs, k, v)]
        want = attention_float64(*ref, *mask)
        want.backward(do.double())
        for a, w in zip([out] + [l.grad for l in leaves], [want] + [r.grad for r in ref]):
            w = w.detach()
            assert float((a.detach().double() - w).abs().max()) <= flash_tol(w, qs.shape[2])


# ---------------------------------------------------------------------------
# sequence-parallel flash attention: the same kernels through their SP entry
# points, one seq rank's query rows against the K/V gathered from all ranks

SP_SHAPES = [  # kind, b, heads, n_frames, hw, d, sp
    ("dart", 8, 4, 8, 64, 64, 2),     # gym video layer split over 2 ranks
    ("causal", 8, 4, 16, 64, 64, 2),  # the same token count, frame-causal
    ("dart", 2, 2, 8, 64, 64, 4),     # ... over 4 ranks
    ("causal", 2, 2, 16, 64, 64, 4),
    ("dart", 1, 2, 4, 40, 32, 2),     # odd: key tiles straddle frames and halves
    ("causal", 1, 2, 6, 40, 32, 3),
    ("causal", 1, 2, 8, 40, 32, 4),
    ("dart", 1, 2, 4, 24, 16, 4),
    ("dart", 1, 1, 4, 48, 128, 2),
]


def gathered_to_clip(kind, n_frames, hw, s, sp):
    """The clip's token index of each token of the rank-major gathered
    layout: x_gathered = x_clip[:, :, index]."""
    j = np.arange(s)
    return torch.from_numpy(masks.shard_frame(j // hw, n_frames // sp, n_frames, kind) * hw
                            + j % hw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SP_SHAPES)
def test_sp_flash_kernels_match_plain(cuda, dtype, shape):
    kind, b, heads, n_frames, hw, d, sp = shape
    s = (2 if kind == "dart" else 1) * n_frames * hw
    sq = s // sp
    qs, k, v, do = flash_inputs(cuda, dtype, "full", b, heads, 1, s, d, seed=9)
    counters = (f"{kind}_sp_fwd_launches", f"{kind}_sp_bwd_launches")
    for r in range(sp):
        q_r, do_r = (a[:, :, r * sq:(r + 1) * sq].contiguous() for a in (qs, do))
        before = tuple(getattr(fa, c) for c in counters)
        o, lse = fa.flash_attention_sp_fwd(q_r, k, v, kind, n_frames, hw, r)
        o_p, lse_p = fa.flash_attention_sp_fwd_plain(q_r, k, v, kind, n_frames, hw, r)
        got = fa.flash_attention_sp_bwd(q_r, k, v, o_p, lse_p, do_r, kind, n_frames, hw, r)
        want = fa.flash_attention_sp_bwd_plain(q_r, k, v, o_p, lse_p, do_r, kind, n_frames, hw, r)
        torch.cuda.synchronize()
        assert tuple(getattr(fa, c) for c in counters) == tuple(x + 1 for x in before)
        assert float((lse - lse_p).abs().max()) <= flash_tol(lse_p, s)
        for name, a, w in [("o", o, o_p), ("dq", got[0], want[0]), ("dk", got[1], want[1]),
                           ("dv", got[2], want[2])]:
            assert a.shape == w.shape and a.dtype == w.dtype == dtype, name
            assert bool(torch.isfinite(a).all()), name
            if dtype == torch.float32:
                assert float((a - w).abs().max()) <= flash_tol(w, s), name
            else:
                assert rel_err(a, w) <= 1e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sp", [2, 4])
def test_sp_shards_add_up_to_the_one_rank_kernel(cuda, dtype, sp):
    """At the gym's DART shape: the shards' stacked o equals the one-rank
    DART kernel's, their dq its rows, and their partial dk, dv summed over
    the ranks its dk, dv -- all in the rank-major gathered token order."""
    b, heads, n_frames, hw, d = 8, 4, 8, 64, 64
    s = 2 * n_frames * hw
    sq = s // sp
    qs, k, v, do = flash_inputs(cuda, dtype, "dart", b, heads, n_frames, hw, d, seed=10)
    o, lse = fa.flash_attention_fwd(qs, k, v, "dart", n_frames, hw)
    grads = fa.flash_attention_bwd(qs, k, v, o, lse, do, "dart", n_frames, hw)
    idx = gathered_to_clip("dart", n_frames, hw, s, sp).to(cuda)
    qg, kg, vg, dog, og = (a[:, :, idx].contiguous() for a in (qs, k, v, do, o))
    lseg = lse[:, :, idx].contiguous()
    outs, dqs, dk, dv = [], [], 0.0, 0.0
    for r in range(sp):
        rows = slice(r * sq, (r + 1) * sq)
        q_r, do_r, o_r, lse_r = (a[:, :, rows].contiguous() for a in (qg, dog, og, lseg))
        outs.append(fa.flash_attention_sp_fwd(q_r, kg, vg, "dart", n_frames, hw, r)[0])
        dq_r, dk_r, dv_r = fa.flash_attention_sp_bwd(q_r, kg, vg, o_r, lse_r, do_r, "dart",
                                                     n_frames, hw, r)
        dqs.append(dq_r)
        dk, dv = dk + dk_r.float(), dv + dv_r.float()
    torch.cuda.synchronize()
    for name, got, want in [("o", torch.cat(outs, dim=2), og),
                            ("dq", torch.cat(dqs, dim=2), grads[0][:, :, idx]),
                            ("dk", dk, grads[1][:, :, idx]), ("dv", dv, grads[2][:, :, idx])]:
        if dtype == torch.float32:
            assert float((got.float() - want.float()).abs().max()) <= flash_tol(want, s), name
        else:
            assert rel_err(got, want) <= 1e-2, name


@pytest.mark.cuda
def test_sp_flash_attention_refuses_bad_shards(cuda):
    qs, k, v, _ = flash_inputs(cuda, torch.float32, "dart", 1, 2, 4, 16, 32)
    q_r = qs[:, :, :64].contiguous()
    with pytest.raises(ValueError):  # rank 2 of 2
        fa.flash_attention_sp_fwd(q_r, k, v, "dart", 4, 16, 2)
    with pytest.raises(ValueError):  # n_frames is not sp * t_local
        fa.flash_attention_sp_fwd(q_r, k, v, "dart", 3, 16, 0)
    with pytest.raises(ValueError):  # full attention is per frame, never split
        fa.flash_attention_sp_fwd(q_r, k, v, "full", 1, 64, 0)


# ---------------------------------------------------------------------------
# int8 decode weights and the VAE on the card

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(img_resolution=16, img_channels=8, label_dim=4, model_channels=16,
             channel_mult=(1, 2), num_blocks=1, max_frames=8, channels_per_head=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BLOCK_CASES[:17])
def test_decode_block_kernel_on_int8_weights(cuda, dtype, case):
    """The int8 path hands the decode Block its dequantized weights
    (MPCausalConv3d.decode_weights under quant): the kernel on weights that
    are int8 * per-channel scale, every gym Block's shape, against its plain
    version."""
    from autoregressive_diffusion_tpu_torch.train.quantize import quantize_weight

    shape, b = case
    args = block_args(cuda, dtype, shape, True, b=b)
    for i in (3, 4, 5, 6, 7):  # wsk, w20, w30, w21, w31
        if args[i] is not None:
            q, s = quantize_weight(args[i].float().cpu().numpy())
            args[i] = (torch.from_numpy(q).float() * torch.from_numpy(s)).to(cuda, dtype)
    before = fc.launches
    got = fc.fused_decode_block(*args, shape[4], 0.3, 256.0, True)
    want = fc.fused_decode_block_plain(*args, shape[4], 0.3, 256.0, True)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-3
        else:
            assert rel_err(a, w) <= 1e-2


@pytest.mark.cuda
def test_int8_model_on_the_card_matches_the_cpu(cuda):
    """A small int8 (decode_quant) model: prefill and a cached call on the
    card (kernels) against the CPU (plain versions), fp32; int8 K/V rings;
    the cached call launches the decode Block kernel."""
    from autoregressive_diffusion_tpu_torch.generate import build_model, int8_model
    from autoregressive_diffusion_tpu_torch.models import init_cache

    cpu = int8_model(build_model("cpu", torch.float32, seed=4, **SMALL))
    gpu = int8_model(build_model(cuda, torch.float32, seed=4, **SMALL))
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 4, 16, 16, 8), generator=g)
    s = torch.full((1, 4), 0.05)
    s[:, -1] = 1.5
    c = torch.zeros((1, 4), dtype=torch.long)
    outs = {}
    with torch.no_grad():
        for m, d in ((cpu, torch.device("cpu")), (gpu, cuda)):
            cache = init_cache(m, 1, device=d)
            y0, cache = m(x[:, :3].to(d), s[:, :3].to(d), c[:, :3].to(d), cache=cache,
                          update_cache=True)
            assert {cache["dec"]["8x8_in0"]["attn"][n].dtype for n in "kv"} == {torch.int8}
            before = fc.launches
            y1, _ = m(x[:, 3:].to(d), s[:, 3:].to(d), c[:, 3:].to(d), cache=cache)
            if d.type == "cuda":
                torch.cuda.synchronize()
                assert fc.launches > before
            outs[d.type] = (y0.cpu(), y1.cpu())
    for a, w in zip(outs["cuda"], outs["cpu"]):
        assert float((a.double() - w.double()).std()) <= 3e-4


@pytest.mark.cuda
def test_trained_vae_on_the_card_matches_the_cpu(cuda):
    """latents_to_frames with the trained VAE bundle on the card against
    the CPU: float pixels within std(diff) 3e-4, uint8 within 1."""
    from autoregressive_diffusion_tpu_torch.models.vae import latents_to_pixels
    from autoregressive_diffusion_tpu_torch.utils import vae_from_bundle

    path = ROOT / "saved_models" / "vae_lunar_lander.ad"
    gpu, _ = vae_from_bundle(path, cuda)
    cpu, _ = vae_from_bundle(path, "cpu")
    lat = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 2, 32, 32, 8))
                           .astype(np.float32))
    got = latents_to_pixels(gpu, lat.to(cuda), 0.0, 1.0).cpu()
    want = latents_to_pixels(cpu, lat, 0.0, 1.0)
    assert got.shape == (1, 8, 128, 128, 3) and bool(torch.isfinite(got).all())
    assert float((got.double() - want.double()).std()) <= 3e-4
    assert int((got.to(torch.uint8).int() - want.to(torch.uint8).int()).abs().max()) <= 1


# the original's recorded tensors, dropout and remat on the card

@pytest.mark.cuda
def test_reference_precond_fixture_on_the_card(cuda):
    """The original's Precond (tests/reference_parity/fixtures/precond.npz)
    loaded by the port's import_torch_3d, fp32 on the card through the
    kernels, at the CPU test's bounds: train y 3e-4 and input gradient
    1e-3, prefill and cached decode 3e-4; every kernel kind launches."""
    from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_cache
    from autoregressive_diffusion_tpu_torch.utils.import_2d import import_torch_3d

    z = dict(np.load(ROOT / "tests" / "reference_parity" / "fixtures" / "precond.npz"))

    def tl(x):
        return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 1, 3, 4, 2)))).to(cuda)

    def sdiff(a, b):
        return float((a.detach().double() - b.double()).std())

    cfg = UNetConfig(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
                     channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
                     frame_attn_resolutions=(16,), channels_per_head=16, max_frames=8)
    model = Precond(cfg, sigma_data=1.0)
    sd = {k[3:]: v for k, v in z.items() if k.startswith("sd/")}
    model.load_state_dict(import_torch_3d(model.state_dict(), sd, cfg))
    model = model.to(cuda).eval()
    before = (fc.conv_fwd_launches, fc.conv_bwd_launches, fa.dart_fwd_launches, fa.launches,
              fc.launches)
    x = tl(z["x_train"]).requires_grad_(True)
    cond = torch.from_numpy(z["cond_train"]).long().to(cuda)
    y, _ = model(x, torch.from_numpy(z["sigma_train"]).to(cuda), cond, mode="train")
    probe = tl(np.sin(np.arange(z["y_train"].size, dtype=np.float32) * 0.17)
               .reshape(z["y_train"].shape))
    (y * probe).sum().backward()
    assert sdiff(y, tl(z["y_train"])) <= 3e-4
    assert sdiff(x.grad, tl(z["probe_grad_x"])) <= 1e-3
    t = z["y_prefill"].shape[1]
    with torch.no_grad():
        y, cache = model(tl(z["x_train"])[:, :t], torch.full((2, t), 0.05, device=cuda),
                         cond[:, :t], cache=init_cache(model, 2, device=cuda),
                         update_cache=True)
        assert sdiff(y, tl(z["y_prefill"])) <= 3e-4
        y, _ = model(tl(z["x_decode"]), torch.full((2, 1), 1.7, device=cuda), cond[:, :1],
                     cache=cache, update_cache=True)
        assert sdiff(y, tl(z["y_decode"])) <= 3e-4
    torch.cuda.synchronize()
    after = (fc.conv_fwd_launches, fc.conv_bwd_launches, fa.dart_fwd_launches, fa.launches,
             fc.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gradients_equal_plain_on_the_card(cuda, dtype):
    """Dropout 0.1 from one seed, a small model, without and with
    per-Block remat on the card: gradients within 1e-6 of the largest
    (the kernels have no atomics, so equal is expected), and the remat run
    launches every Block's convs and attention forward twice."""
    from autoregressive_diffusion_tpu_torch.train import build_trainer, edm2_loss, synthetic_batch
    from autoregressive_diffusion_tpu_torch.train.cli import GYM_LOSS

    small = dict(img_resolution=16, img_channels=4, model_channels=16, channel_mult=(1, 2),
                 num_blocks=1, max_frames=8, channels_per_head=16, dropout=0.1)
    grads, counts = {}, {}
    for remat in (False, True):
        state, _ = build_trainer(cuda, dtype, seed=2, batch=2, remat=remat, **small)
        images, cond = synthetic_batch(state.model.cfg, 2, 3, 1, cuda)
        before = (fc.conv_fwd_launches, fc.conv_bwd_launches, fa.dart_fwd_launches)
        loss, _ = edm2_loss(state.model, images, 5, GYM_LOSS, cond, state.coefs)
        loss.backward()
        torch.cuda.synchronize()
        counts[remat] = tuple(a - b for a, b in zip(
            (fc.conv_fwd_launches, fc.conv_bwd_launches, fa.dart_fwd_launches), before))
        grads[remat] = {n: p.grad.float() for n, p in state.model.named_parameters()
                        if p.grad is not None}
    n_blocks = sum(sp["kind"] == "block" for _, _, sp in state.model.cfg.block_layout())
    assert counts[True] == (counts[False][0] + 2 * n_blocks, counts[False][1],
                            2 * counts[False][2])
    for n, g in grads[False].items():
        assert float((grads[True][n] - g).abs().max()) <= 1e-6 * float(g.abs().max()), n


GRAPH_MODELS = {  # the served widths at batch 2 (the CS fields as chip_smoke.cs_model_config)
    "gym": {}, "gym_int8": {},
    "cs": dict(img_resolution=32, img_channels=8, label_dim=4, model_channels=128,
               channel_mult=(1, 2, 4, 4), num_blocks=2, video_attn_resolutions=(4,),
               frame_attn_resolutions=(8,), max_frames=64)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(GRAPH_MODELS))
def test_cached_call_graph_replays_the_eager_call_bit_for_bit(cuda, kind):
    """The cached call as a CUDA graph (models/call_graph.py) at the gym and
    CS widths in bf16 and the gym model under int8 decode weights, batch 2,
    over three frame steps from a ring of 63 frames across its wrap: every
    call's output equals the eager call's bit for bit and survives the next
    calls; a call records once a frame step (the first call of a shape
    set runs eagerly) and replays after; the frame counter, a weight
    changed in place, a cache tensor and an input's shapes each record
    again; the decode-Block launch counter counts the Blocks of the calls
    that ran their Python (eager and recorded), and the profiler sees a
    replay's kernels, as the eager call's; a prefill into a new cache drops
    the graph and frees the cache it held."""
    import gc
    import weakref
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from autoregressive_diffusion_tpu_torch.generate import build_model, int8_model
    from autoregressive_diffusion_tpu_torch.models import init_cache
    from autoregressive_diffusion_tpu_torch.utils import profiling

    model = build_model(cuda, torch.bfloat16, 3, **GRAPH_MODELS[kind])
    if kind.endswith("int8"):
        model = int8_model(model)
    cfg, b = model.cfg, 2
    shape = (b, 1, cfg.img_resolution, cfg.img_resolution, cfg.img_channels)
    g = torch.Generator(device=cuda).manual_seed(4)
    cache = init_cache(model, b, device=cuda)
    with torch.no_grad():
        for j in range(0, 63, 8):
            t = min(8, 63 - j)
            ctx = torch.randn((b, t) + shape[2:], generator=g, device=cuda)
            _, cache = model(ctx, torch.full((b, t), 0.05, device=cuda), None, cache=cache,
                             update_cache=True)

    def draw():
        return (torch.randn(shape, generator=g, device=cuda) * 3,
                torch.rand((b, 1), generator=g, device=cuda) * 10 + 0.1,
                torch.randint(0, 4, (b, 1), generator=g, device=cuda))

    def call(cache, x, s, c):
        with torch.no_grad():
            with profiling.tracing() as records:
                before = fc.launches
                y, out_cache = model(x, s, c, cache=cache)
                n = fc.launches - before
            want = model._call(x, s, c, cache, False, "eval", False, None)[0]
        torch.cuda.synchronize()
        graph = records[-1].attrs["graph"]  # model.call closes last
        assert torch.equal(y, want), (kind, graph, float((y - want).abs().max()))
        assert out_cache is cache or graph == "eager"
        return graph, n, y, want

    n_blocks = sum(sp["kind"] == "block" and not sp["attention"]
                   for _, _, sp in cfg.block_layout())
    for step in range(3):
        got = [call(cache, *draw()) for _ in range(4)]
        assert [k for k, *_ in got] == (["eager"] if step == 0 else ["capture"]) + [
            "capture" if step == 0 else "replay"] + ["replay"] * 2
        assert all(n == (0 if k == "replay" else n_blocks) for k, n, _, _ in got)
        assert all(torch.equal(y, w) for _, _, y, w in got)  # no later call wrote them
        with torch.no_grad():
            _, cache = model(*draw(), cache=cache, update_cache=True)
    assert cache["frames"] == 66
    x, s, c = draw()
    with torch.no_grad():
        model.unet.out_gain.mul_(0.5)
    assert [call(cache, x, s, c)[0] for _ in range(2)] == ["capture", "replay"]
    leaf = dict(cache, out_conv={"act": cache["out_conv"]["act"] * 0.5})
    assert [call(leaf, x, s, c)[0] for _ in range(2)] == ["capture", "replay"]
    assert [call(leaf, x, s, None)[0] for _ in range(3)] == ["eager", "capture", "replay"]

    def kernels(fn):
        with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return Counter(e.name() for e in prof.profiler.kineto_results.events()
                       if "decode_block" in e.name() and e.device_type() != DeviceType.CPU)

    replayed = kernels(lambda: model(x, s, None, cache=leaf))
    eager = kernels(lambda: model._call(x, s, None, leaf, False, "eval", False, None))
    assert sum(eager.values()) >= n_blocks and replayed == eager
    held = [weakref.ref(t) for t in model.call_graph.live.held[0]]
    del leaf, cache
    gc.collect()
    assert all(r() is not None for r in held)
    with torch.no_grad():
        model(ctx[:, :2], torch.full((b, 2), 0.05, device=cuda), None,
              cache=init_cache(model, b, device=cuda), update_cache=True)
    gc.collect()
    assert model.call_graph.live is None and all(r() is None for r in held)
