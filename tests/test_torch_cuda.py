"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: without a CUDA device each test skips with the reason (the
kernels have no CPU mode; their plain versions are held against the JAX
package in test_torch_ops.py and test_torch_decode_block.py). On the card
(tests/conftest.py sets up JAX, which these tests do not need):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import pytest
import torch

from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
from autoregressive_diffusion_tpu_torch.ops import fused_conv as fc
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_new,f_total,offset", [(8, 8, 0), (8, 64, 0), (2, 64, 10),
                                                  (8, 64, 60), (3, 5, 0)])
def test_prefill_kernel_matches_plain(cuda, dtype, t_new, f_total, offset):
    g = torch.Generator(device=cuda).manual_seed(0)
    hw, d = 64, 64
    q = (torch.randn((1, 4, t_new * hw, d), generator=g, device=cuda) / 8).to(dtype)
    k = torch.randn((1, 4, f_total * hw, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((1, 4, f_total * hw, d), generator=g, device=cuda).to(dtype)
    before = fa.launches
    got = fa.prefill_attention(q, k, v, t_new, f_total, offset, hw)
    want = fa.prefill_attention_plain(q, k, v, t_new, f_total, offset, hw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        assert rel_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 96, 96, 32, "dec", True), (32, 32, 64, 64, "enc", True),
                                   (8, 256, 256, 256, "dec", False), (16, 16, 16, 16, "enc", False)])
@pytest.mark.parametrize("with_ctx", [True, False])
def test_decode_block_kernel_matches_plain(cuda, dtype, shape, with_ctx):
    h, cin, c0, co, flavor, skip = shape
    g = torch.Generator(device=cuda).manual_seed(1)

    def rn(*s):
        return torch.randn(s, generator=g, device=cuda)

    args = [rn(1, 1, h, h, cin).to(dtype),
            rn(1, 2, h, h, c0).to(dtype) if with_ctx else None,
            rn(1, 2, h, h, co).to(dtype) if with_ctx else None,
            mp_weight(rn(cin, co)).to(dtype) if skip else None,
            mp_weight(rn(3, 3, c0, co)).to(dtype), mp_weight(rn(2, 3, 3, c0, co)).to(dtype),
            mp_weight(rn(3, 3, co, co)).to(dtype), mp_weight(rn(2, 3, 3, co, co)).to(dtype),
            (1 + 0.5 * rn(1, co)).to(dtype), 0.1 + 0.8 * torch.rand((1, 2), device=cuda)]
    got = fc.fused_decode_block(*args, flavor, 0.3, 256.0, with_ctx)
    want = fc.fused_decode_block_plain(*args, flavor, 0.3, 256.0, with_ctx)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if dtype == torch.float32:
            assert float((a - b).abs().max()) <= 1e-3
        else:
            assert rel_err(a, b) <= 1e-2


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
