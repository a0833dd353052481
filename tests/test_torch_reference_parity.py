"""The port's denoiser against the original PyTorch repo's recorded tensors
(tests/reference_parity/fixtures/*.npz) on the CPU, fp32, with weights
loaded through the port's own import (utils/import_2d.py::import_torch_3d
and its layout helpers), at the bounds tests/test_reference_parity.py
holds the JAX package to: std-of-diff <= 3e-4 for every output (the
original's cross-mode consistency bound), 1e-3 for the train-mode input
gradient and the 8-step sampler trajectory, 2e-3 relative for the loss,
rtol 5e-3 (atol 1e-4) for the sampler's per-step MSEs. The numerics
fixture holds the port's ops/numerics.py at 3e-4.

The recorded Precond state dict is the original's init: out_gain and every
emb_gain are 0, so the UNet body does not reach the Precond's output, and
the precond, loss and sampler fixtures hold the preconditioning, the loss
weighting and the sampler's schedule. The body's layers are held by the
conv and attention fixtures (and against the JAX package by
test_torch_model.py); test_import_torch_3d_sets_every_entry shows that
the import takes every weight, attention included, from the checkpoint."""
import os

import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu_torch.models import (Precond, UNetConfig, VideoAttention,
                                                       init_cache)
from autoregressive_diffusion_tpu_torch.models.layers import MPCausalConv3d
from autoregressive_diffusion_tpu_torch.ops import numerics as nx
from autoregressive_diffusion_tpu_torch.sampling import edm_sampler, karras_schedule
from autoregressive_diffusion_tpu_torch.train import EDM2LossConfig, edm2_loss, init_coefs
from autoregressive_diffusion_tpu_torch.utils.import_2d import (_conv3d_w, _conv_w,
                                                                _import_gating,
                                                                _qkv_mcs_to_smc,
                                                                import_torch_3d)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference_parity", "fixtures")
TOL = 3e-4  # the original's consistency_test.py:32
CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), channels_per_head=16, max_frames=8)


def load(name):
    return dict(np.load(os.path.join(FIX, name)))


def tl(x):
    """The original's video layout (b, t, c, h, w) -> the port's (b, t, h, w, c)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 1, 3, 4, 2))))


def sdiff(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    return float(np.std(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def t_(x):
    return torch.from_numpy(np.asarray(x))


def test_numerics_parity():
    z = load("numerics.npz")
    x = t_(z["norm_x"])
    assert sdiff(nx.normalize(x), z["norm_default"]) <= TOL
    assert sdiff(nx.normalize(x, dim=-1), z["norm_lastdim"]) <= TOL
    assert sdiff(nx.normalize(x, dim=1), z["norm_dim1"]) <= TOL

    # resample: the original's NCHW against the port's channels-last
    xr = t_(np.transpose(z["resample_x"], (0, 2, 3, 1)).copy())[:, None]
    for mode in ("down", "up"):
        y = nx.resample(xr, mode=mode)[:, 0]
        assert sdiff(y, np.transpose(z[f"resample_{mode}"], (0, 2, 3, 1))) <= TOL
    assert sdiff(nx.mp_silu(t_(z["silu_x"])), z["silu_y"]) <= TOL
    a, b = t_(z["mp_sum_a"]), t_(z["mp_sum_b"])
    assert sdiff(nx.mp_sum(a, b, t=0.3), z["mp_sum_t03"]) <= TOL
    assert sdiff(nx.mp_sum(a, b, t=t_(z["mp_sum_tv"])), z["mp_sum_tvec"]) <= TOL
    ca = t_(np.transpose(z["mp_cat_a"], (0, 2, 3, 1)).copy())
    cb = t_(np.transpose(z["mp_cat_b"], (0, 2, 3, 1)).copy())
    y = nx.mp_cat(ca, cb, dim=-1, t=0.4)
    assert sdiff(y, np.transpose(z["mp_cat_y"], (0, 2, 3, 1))) <= TOL
    fy = nx.mp_fourier(t_(z["fourier_x"]), t_(z["fourier_freqs"]), t_(z["fourier_phases"]))
    assert sdiff(fy, z["fourier_y"]) <= TOL
    assert sdiff(nx.bmult(t_(z["bmult_x"]), t_(z["bmult_t1"])), z["bmult_y1"]) <= TOL
    # the original's 2D t scales dim 1 of (b, c, ...); the port's the last axis
    y2 = nx.bmult(t_(np.transpose(z["bmult_x"], (0, 2, 1)).copy()), t_(z["bmult_t2"]))
    assert sdiff(np.transpose(y2.numpy(), (0, 2, 1)), z["bmult_y2"]) <= TOL
    gl = nx.gaussian_loss(t_(z["gauss_mean"]), t_(z["gauss_logvar"]), t_(z["gauss_target"]))
    assert abs(float(gl) - float(z["gauss_y"])) <= TOL


def test_causal_conv_parity():
    z = load("conv.npz")
    mod = MPCausalConv3d(6, 8)
    state = mod.state_dict()
    state["last_frame_conv.w"] = t_(_conv_w(z["sd/last_frame_conv.weight.weight"]))
    state["w"] = t_(_conv3d_w(z["sd/weight.weight"]))
    _import_gating(state, "gating", {f"g.{k}": z[f"sd/gating.{k}"] for k in
                                     ("offset", "mult", "max_gating", "min_gating")}, "g")
    mod.load_state_dict(state)
    x, cn = tl(z["x_train"]), t_(z["c_noise_train"])
    with torch.no_grad():
        y, _ = mod(x, cn, mode="train")
        assert sdiff(y, tl(z["y_train"])) <= TOL
        y2d, _ = mod(x, cn, mode="train", just_2d=True)
        assert sdiff(y2d, tl(z["y_2d"])) <= TOL
        xe = tl(z["x_eval"])
        y_pre, cache = mod(xe, t_(z["cn_eval"]), update_cache=True)
        assert sdiff(y_pre, tl(z["y_prefill"])) <= TOL
        y_dec, _ = mod(tl(z["x_decode"]), t_(z["cn_decode"]), frames=xe.shape[1],
                       cache=cache, update_cache=True)
        assert sdiff(y_dec, tl(z["y_decode"])) <= TOL


def test_video_attention_parity():
    z = load("attention.npz")
    heads = int(z["num_heads"])
    mod = VideoAttention(32, heads, max_frames=8)
    state = mod.state_dict()
    state["attn_qkv.w"] = t_(_conv_w(_qkv_mcs_to_smc(z["sd/attn_qkv.weight.weight"], heads)))
    state["attn_proj.w"] = t_(_conv_w(z["sd/attn_proj.weight.weight"]))
    mod.load_state_dict(state)
    x = tl(z["x_train"])
    with torch.no_grad():
        y, _ = mod(x, mode="train")
        assert sdiff(y, tl(z["y_train"])) <= TOL
        y2d, _ = mod(x, mode="train", just_2d=True)
        assert sdiff(y2d, tl(z["y_2d"])) <= TOL
        xe = tl(z["x_eval"])
        y_pre, cache = mod(xe, update_cache=True)
        assert sdiff(y_pre, tl(z["y_prefill"])) <= TOL
        y_dec, _ = mod(tl(z["x_decode"]), cache, True, xe.shape[1])
        assert sdiff(y_dec, tl(z["y_decode"])) <= TOL


def precond_sd():
    return {k[3:]: v for k, v in load("precond.npz").items() if k.startswith("sd/")}


def test_import_torch_3d_sets_every_entry():
    """Two models that start from different values import to one state: no
    parameter or buffer is left at its init."""
    model = Precond(UNetConfig(**CFG), sigma_data=1.0)
    sd = precond_sd()
    a, b = (import_torch_3d({k: torch.full_like(v, fill) for k, v in
                             model.state_dict().items()}, sd, model.cfg) for fill in (0, 1))
    assert set(a) == set(model.state_dict())
    for name in a:
        assert torch.equal(a[name], b[name]), name
    qkv = "unet.dec_8x8_block1.attn.attn_qkv.w"
    np.testing.assert_array_equal(a[qkv].numpy(), _conv_w(_qkv_mcs_to_smc(
        sd["dec.8x8_block1.attn.attn_qkv.weight.weight"], 2)))
    assert float(sd["out_gain"]) == 0.0  # the original's init (see the module docstring)


@pytest.fixture(scope="module")
def precond():
    z = load("precond.npz")
    model = Precond(UNetConfig(**CFG), sigma_data=1.0)
    model.load_state_dict(import_torch_3d(model.state_dict(), precond_sd(), model.cfg))
    return model.eval(), z


def test_precond_train_parity(precond):
    model, z = precond
    x = tl(z["x_train"]).requires_grad_(True)
    probe = tl(np.sin(np.arange(z["y_train"].size, dtype=np.float32) * 0.17)
               .reshape(z["y_train"].shape))
    y, _ = model(x, t_(z["sigma_train"]), t_(z["cond_train"]).long(), mode="train")
    (y * probe).sum().backward()
    assert sdiff(y, tl(z["y_train"])) <= TOL
    assert sdiff(x.grad, tl(z["probe_grad_x"])) <= 1e-3


@torch.no_grad()
def test_precond_2d_parity(precond):
    model, z = precond
    t = z["y_2d"].shape[1]
    y, _ = model(tl(z["x_train"])[:, :t], t_(z["sigma_train"])[:, :t],
                 t_(z["cond_train"]).long()[:, :t], just_2d=True)
    assert sdiff(y, tl(z["y_2d"])) <= TOL


@torch.no_grad()
def test_precond_prefill_decode_parity(precond):
    model, z = precond
    t = z["y_prefill"].shape[1]
    x = tl(z["x_train"])[:, :t]
    cond = t_(z["cond_train"]).long()[:, :t]
    b = x.shape[0]
    y_pre, cache = model(x, torch.full((b, t), 0.05), cond,
                         cache=init_cache(model, b, device="cpu"), update_cache=True)
    assert sdiff(y_pre, tl(z["y_prefill"])) <= TOL
    y_dec, _ = model(tl(z["x_decode"]), torch.full((b, 1), 1.7), cond[:, :1], cache=cache,
                     update_cache=True)
    assert sdiff(y_dec, tl(z["y_decode"])) <= TOL


@torch.no_grad()
def test_loss_parity(precond):
    model, _ = precond
    z = load("loss.npz")
    cfg = EDM2LossConfig(P_mean=1.2, P_std=1.0, sigma_data=1.0, context_noise_reduction=0.5)
    sigma = t_(z["sigma"])
    # the fixture records the raw eps; the original scales it by sigma (loss.py:31)
    noise = sigma[:, :, None, None, None] * tl(z["noise"])
    loss, aux = edm2_loss(model, tl(z["images"]), 0, cfg, t_(z["cond"]).long(),
                          init_coefs(), sigma=sigma, noise=noise)
    for got, want in ((loss, z["loss"]), (aux["unweighted"], z["unweighted"])):
        assert abs(float(got) - float(want)) <= 2e-3 * max(1, abs(float(want)))


@torch.no_grad()
def test_sampler_parity(precond):
    model, _ = precond
    z = load("sampler.npz")
    ctx, cond = tl(z["ctx"]), t_(z["cond"]).long()
    b, t = ctx.shape[:2]
    t0 = float(karras_schedule(8, 0.02, 20.0, 7.0)[0])
    kw = dict(num_steps=8, sigma_min=0.02, sigma_max=20.0, rho=7.0)

    def prefill():
        _, cache = model(ctx, torch.full((b, t), 0.05), cond,
                         cache=init_cache(model, b, device="cpu"), update_cache=True)
        return cache

    shape = tuple(tl(z["x_init"]).shape)
    x, _, _, _ = edm_sampler(model, prefill(), shape, cond[:, :1],
                             x_init=tl(z["x_init"]) * t0, **kw)
    # 16 sequential UNet calls compound fp32 noise: 1e-3 std-of-diff
    assert sdiff(x, tl(z["x_final"])) <= 1e-3

    _, mses, mses_pred, _ = edm_sampler(model, prefill(), shape, cond[:, :1],
                                        x_init=tl(z["x_init_target"]) * t0,
                                        target=tl(z["target"]), **kw)
    np.testing.assert_allclose(mses.numpy(), z["mse_target"], rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(mses_pred.numpy(), z["mse_pred_target"], rtol=5e-3, atol=1e-4)
