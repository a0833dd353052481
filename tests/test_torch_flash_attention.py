"""The port's DART and full flash attention against the JAX package.

On CPU tensors `dart_attention` and `full_attention` run the kernels' plain
versions (ops/flash_attention.py) through the same torch.autograd.Function
that launches the kernels on the card, so these tests hold the explicit
backward formula, not only autograd, against the JAX splash kernels (in
interpret mode) and the JAX dense attention. Inputs come from numpy with a
seed; the kernels themselves are held against these plain versions in
tests/test_torch_cuda.py on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.ops import attention as jatt
from autoregressive_diffusion_tpu.ops import flash_attention as jfa
from autoregressive_diffusion_tpu.ops import masks as jmasks
from autoregressive_diffusion_tpu_torch.models import attention as tattn
from autoregressive_diffusion_tpu_torch.ops import flash_attention as tfa
from autoregressive_diffusion_tpu_torch.ops import masks as tmasks


def maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def torch_out_and_grads(fn, q, k, v):
    """o and the gradients of sum(o^2) in q, k, v, through the port."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fn(*leaves)
    (o ** 2).sum().backward()
    return [o.detach()] + [a.grad for a in leaves]


def jax_out_and_grads(fn, q, k, v):
    """o and the gradients of sum(o^2) in q, k, v, through the JAX package
    (one trace of the function for both)."""
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [o] + list(grads)


# The JAX suite's own shape and bounds (tests/test_flash_attention.py:16, :42, :70).
T, HW, D, H, B = 4, 64, 64, 2, 1


def test_dart_attention_matches_splash():
    q, k, v = qkv((B, H, 2 * T * HW, D), 0)
    want = jax_out_and_grads(
        lambda q, k, v: jfa.dart_attention(q, k, v, T, HW, interpret=True), q, k, v)
    got = torch_out_and_grads(lambda q, k, v: tfa.dart_attention(q, k, v, T, HW), q, k, v)
    assert maxdiff(want[0], got[0]) < 1e-5
    for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
        assert maxdiff(w, g) < 1e-4, name


def test_full_attention_matches_splash():
    q, k, v = qkv((2, H, 128, D), 1)
    want = jax_out_and_grads(lambda q, k, v: jfa.full_attention(q, k, v, interpret=True),
                             q, k, v)
    got = torch_out_and_grads(tfa.full_attention, q, k, v)
    assert maxdiff(want[0], got[0]) < 1e-5
    for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
        assert maxdiff(w, g) < 1e-4, name


@pytest.mark.parametrize("n_frames,hw,d", [(3, 40, 32), (2, 16, 16)])
def test_odd_shapes_match_dense(n_frames, hw, d):
    """hw not a multiple of the kernels' 64-token tile, against the JAX
    dense attention under the expanded DART mask."""
    q, k, v = qkv((2, 2, 2 * n_frames * hw, d), 2)
    mask = jnp.asarray(jmasks.expand_to_tokens(jmasks.train_frame_mask(n_frames), hw))
    want = jax_out_and_grads(lambda q, k, v: jatt.dense_attention(q, k, v, mask), q, k, v)
    got = torch_out_and_grads(lambda q, k, v: tfa.dart_attention(q, k, v, n_frames, hw),
                              q, k, v)
    assert maxdiff(want[0], got[0]) < 1e-5
    for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
        assert maxdiff(w, g) < 1e-4, name


@pytest.mark.parametrize("kind,n_frames,hw", [("dart", 3, 40), ("dart", 2, 16),
                                              ("full", 1, 48)])
def test_backward_plain_matches_autograd_of_the_dense_path(kind, n_frames, hw):
    """flash_attention_bwd_plain (dS = P * (dP - delta)) against torch
    autograd of the dense masked softmax, fp32."""
    s = 2 * n_frames * hw if kind == "dart" else hw
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 3, s, 32)).astype(np.float32))
                   for _ in range(4))
    qs = q / 32 ** 0.5
    o, lse = tfa.flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw)
    got = tfa.flash_attention_bwd_plain(qs, k, v, o, lse, do, kind, n_frames, hw)
    f = np.arange(s) // hw
    mask = torch.from_numpy(tmasks.frame_visible(kind, f[:, None], f[None, :], n_frames))
    leaves = [a.clone().requires_grad_(True) for a in (qs, k, v)]
    logits = (leaves[0] @ leaves[1].transpose(-1, -2)).masked_fill(~mask, float("-inf"))
    ref = torch.softmax(logits, dim=-1) @ leaves[2]
    ref.backward(do)
    assert float((o - ref.detach()).abs().max()) < 1e-5
    for name, g, leaf in zip(("dq", "dk", "dv"), got, leaves):
        assert float((g - leaf.grad).abs().max()) < 1e-5, name


@pytest.mark.parametrize("n_frames", [1, 2, 3, 8])
def test_frame_visible_is_the_dart_mask(n_frames):
    f = np.arange(2 * n_frames)
    got = tmasks.frame_visible("dart", f[:, None], f[None, :], n_frames)
    np.testing.assert_array_equal(got, tmasks.train_frame_mask(n_frames))
    np.testing.assert_array_equal(got, jmasks.train_frame_mask(n_frames))
    hw = 5  # the token-level predicate of the JAX DartMask
    tok = np.arange(2 * n_frames * hw)
    np.testing.assert_array_equal(
        tfa._token_mask_np("dart", n_frames, hw, tok.size),
        jfa.DartMask(n_frames, hw).mask_function(tok[:, None], tok[None, :]))
    assert tmasks.frame_visible("full", f[:, None], f[None, :], n_frames).all()


def test_attention_layers_take_the_flash_path(monkeypatch):
    """Train-mode VideoAttention runs DART flash attention, just_2d
    VideoAttention and FrameAttention run full flash attention: on CPU
    tensors, through the kernels' plain versions, forward and backward."""
    calls = []
    fwd, bwd = tfa.flash_attention_fwd_plain, tfa.flash_attention_bwd_plain

    def count_fwd(qs, k, v, kind, n_frames, hw):
        calls.append(("fwd", kind, n_frames, hw, tuple(qs.shape)))
        return fwd(qs, k, v, kind, n_frames, hw)

    def count_bwd(qs, k, v, o, lse, do, kind, n_frames, hw):
        calls.append(("bwd", kind, n_frames, hw, tuple(qs.shape)))
        return bwd(qs, k, v, o, lse, do, kind, n_frames, hw)

    monkeypatch.setattr(tfa, "flash_attention_fwd_plain", count_fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", count_bwd)
    torch.manual_seed(0)
    video = tattn.VideoAttention(32, 2, max_frames=8)
    frame = tattn.FrameAttention(32, 2)
    for p in list(video.parameters()) + list(frame.parameters()):
        torch.nn.init.normal_(p)
    b, t, h, w = 2, 6, 4, 4  # the DART concat of 3 frames
    cases = [(video, dict(mode="train"), ("dart", 3, 16, (b, 2, t * 16, 16))),
             (video, dict(just_2d=True, mode="train"), ("full", 1, 16, (b * t, 2, 16, 16))),
             (frame, dict(mode="train"), ("full", 1, 16, (b * t, 2, 16, 16)))]
    for layer, kw, want in cases:
        calls.clear()
        x = torch.randn((b, t, h, w, 32), requires_grad=True)
        y, _ = layer(x, **kw)
        y.square().sum().backward()
        assert calls == [("fwd",) + want, ("bwd",) + want]
        assert bool(torch.isfinite(x.grad).all())
