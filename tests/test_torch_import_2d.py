"""The port's checkpoint imports (utils/import_2d.py) against the JAX
package's on the CPU: import_torch_edm2 and export_2d_state on a synthetic
NVIDIA EDM2 2D state dict, import_torch_3d on a synthetic state dict in the
original's 3D naming, leaf for leaf and bit for bit (both are layout
permutations); then the round trip of tests/test_utils.py (export, perturb,
import, export lands exactly; a just_2d forward survives export and import
within 1e-5; a wrong shape raises). Weights are the port's seeded init,
given to the JAX functions as the JAX-named tree of the bridge."""
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.utils import import_2d as jimp
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_weights
from autoregressive_diffusion_tpu_torch.utils import jax_variables, state_from_jax
from autoregressive_diffusion_tpu_torch.utils.import_2d import (export_2d_state,
                                                                import_torch_3d,
                                                                import_torch_edm2)

TINY = dict(img_resolution=8, img_channels=3, label_dim=4, model_channels=8,
            channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(4,),
            frame_attn_resolutions=(8,), channels_per_head=8, max_frames=8)


@pytest.fixture(scope="module")
def tiny():
    model = init_weights(Precond(UNetConfig(**TINY), sigma_data=0.5), seed=0)
    return model, jax_variables(model), JConfig(**TINY)


def perturbed(sd, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in sd.items()}


def assert_states_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name, val in want.items():
        np.testing.assert_array_equal(got[name].numpy(), val.numpy(), err_msg=name)


def test_edm2_import_and_export_equal_jax(tiny):
    model, variables, jcfg = tiny
    sd = perturbed(jimp.export_2d_state(variables, jcfg), 1)
    assert any(k.endswith(".attn_qkv.weight") for k in sd)
    got = import_torch_edm2(model.state_dict(), sd, model.cfg)
    assert_states_equal(got, state_from_jax(jimp.import_torch_edm2(variables, sd, jcfg)))
    want = jimp.export_2d_state(variables, jcfg)
    back = export_2d_state(model.state_dict(), model.cfg)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_3d_import_equals_jax(tiny):
    """A synthetic state dict in the original's 3D naming. The JAX import
    reads a Block's attention under `<block>.attn_qkv`, where the original
    names it `<block>.attn.attn_qkv` (tests/reference_parity/fixtures/
    precond.npz), and so leaves attention at its input; the port imports it,
    in the layout of the JAX package's own helpers."""
    model, variables, jcfg = tiny
    sd = {}
    for side, name, spec in model.cfg.block_layout():
        pre = "out_conv" if side == "out" else f"{side}.{name}"
        convs = [pre] if spec["kind"] == "conv" else [f"{pre}.conv_res0", f"{pre}.conv_res1"]
        at = "out_conv" if side == "out" else f"{side}_{name}"
        for conv, mod in zip(convs, [at] if spec["kind"] == "conv"
                             else [f"{at}.conv_res0", f"{at}.conv_res1"]):
            w2 = variables["params"]["unet"]
            for part in mod.split("."):
                w2 = w2[part]
            sd[f"{conv}.last_frame_conv.weight.weight"] = np.transpose(
                w2["last_frame_conv"]["w"], (3, 2, 0, 1))
            sd[f"{conv}.weight.weight"] = np.transpose(w2["w"], (4, 3, 0, 1, 2))
            for g in ("offset", "mult", "max_gating", "min_gating"):
                sd[f"{conv}.gating.{g}"] = np.asarray(w2["gating"][g])
        if spec["kind"] == "block":
            p = variables["params"]["unet"][at]
            sd[f"{pre}.emb_linear.weight.weight"] = p["emb_linear"]["w"].T
            sd[f"{pre}.emb_gain"] = p["emb_gain"]
            if "conv_skip" in p:
                sd[f"{pre}.conv_skip.weight.weight"] = np.transpose(
                    p["conv_skip"]["w"], (3, 2, 0, 1))
            if "attn" in p:
                for k in ("attn_qkv", "attn_proj"):
                    sd[f"{pre}.attn.{k}.weight.weight"] = np.transpose(
                        p["attn"][k]["w"], (3, 2, 0, 1))
    u = variables["params"]["unet"]
    sd["emb_noise.weight.weight"] = u["emb_noise"]["w"].T
    sd["emb_label.weight.weight"] = u["emb_label"]["w"].T
    sd["out_gain"] = u["out_gain"]
    for g in ("offset", "mult", "max_gating", "min_gating"):
        sd[f"out_res.{g}"] = u["out_res"][g]
    for k in ("freqs", "phases"):
        sd[f"emb_fourier_sigma.{k}"] = variables["buffers"]["unet"]["emb_fourier_sigma"][k]
    sd = perturbed(sd, 2)

    got = import_torch_3d(model.state_dict(), sd, model.cfg)
    want = state_from_jax(jimp.import_torch_3d(variables, sd, jcfg))
    attn = {k for k in want if ".attn." in k}
    assert attn
    before = model.state_dict()
    for name in attn:
        np.testing.assert_array_equal(want[name].numpy(), before[name].numpy())
        block, _, leaf = name[len("unet."):].partition(".attn.")
        side, res = block.split("_", 1)
        w = sd[f"{side}.{res}.attn.{leaf[:-2]}.weight.weight"]
        if leaf.startswith("attn_qkv"):
            w = jimp._qkv_mcs_to_smc(w, w.shape[0] // 3 // TINY["channels_per_head"])
        want[name] = torch.from_numpy(jimp._conv_w(w).copy())
    assert_states_equal(got, want)


def test_round_trip_exact(tiny):
    model, _, _ = tiny
    sd = export_2d_state(model.state_dict(), model.cfg)
    assert any(k.endswith("conv_res0.weight") for k in sd)
    assert "out_gain" in sd and "emb_fourier.freqs" in sd
    sd2 = perturbed(sd, 0)
    back = export_2d_state(import_torch_edm2(model.state_dict(), sd2, model.cfg), model.cfg)
    for k in sd2:
        np.testing.assert_array_equal(back[k], sd2[k], err_msg=k)


@torch.no_grad()
def test_just_2d_forward_preserved(tiny):
    model, _, _ = tiny
    imported = Precond(model.cfg, sigma_data=0.5)
    imported.load_state_dict(import_torch_edm2(
        model.state_dict(), export_2d_state(model.state_dict(), model.cfg), model.cfg))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 2, 8, 8, 3))
                         .astype(np.float32))
    sig = torch.full((1, 2), 0.8)
    cond = torch.zeros((1, 2), dtype=torch.long)
    y0, _ = model.eval()(x, sig, cond, just_2d=True)
    y1, _ = imported.eval()(x, sig, cond, just_2d=True)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), rtol=1e-5, atol=1e-5)


def test_shape_mismatch_raises(tiny):
    model, _, _ = tiny
    sd = export_2d_state(model.state_dict(), model.cfg)
    k = next(k for k in sd if k.endswith("conv_res0.weight"))
    sd[k] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_edm2(model.state_dict(), sd, model.cfg)
