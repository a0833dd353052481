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
