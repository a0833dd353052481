"""Import the original's PyTorch checkpoints into the port's denoiser.

Counterpart of autoregressive_diffusion_tpu/utils/import_2d.py, over the
port's flat state dicts in place of flax variable trees:

  * `import_torch_edm2`: an NVIDIA EDM2 *2D* image denoiser seeds the video
    model. Every 2D conv weight lands in the matching `last_frame_conv`, the
    attention qkv/proj and the embeddings copy over, and the temporal
    context convs keep their own init (the gating starts at sigmoid(-5), so
    the imported model behaves as the 2D model on every frame; just_2d
    reproduces it exactly).
  * `export_2d_state`: its inverse for the 2D-derivable subset.
  * `import_torch_3d`: the original's FULL 3D state dict (temporal context
    convs, gating, out_res), names like
    `enc.16x16_block0.conv_res0.weight.weight` (its MPConv wraps the weight
    in a NormalizedWeight, hence the doubled suffix).

Each import takes the port model's `state_dict()` (of a Precond, names
under `unet.`, or of a UNet) and returns a new {name: tensor} dict with the
checkpoint's weights in the port's layouts, which loads with
`model.load_state_dict`. The checkpoint is a flat {name: array} dict;
`torch_state_dict_to_numpy` converts a loaded torch one.

Layouts (torch -> the port's, which are the JAX package's, channels-last):
  conv2d  (O, I, kh, kw)     -> (kh, kw, I, O)
  conv3d  (O, I, kt, kh, kw) -> (kt, kh, kw, I, O)
  dense   (O, I)             -> (I, O)
  qkv rows: the original's (m c s) interleave -> the port's (s m c)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def torch_state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """Detach a torch state dict to fp32 numpy arrays."""
    return {k: np.asarray(v.detach().cpu().float().numpy()) for k, v in state_dict.items()}


def _conv_w(w: np.ndarray) -> np.ndarray:
    if w.ndim != 4:
        raise ValueError(f"expected an OIHW conv weight, got {w.shape}")
    return np.transpose(w, (2, 3, 1, 0))


def _conv3d_w(w: np.ndarray) -> np.ndarray:
    """torch (O, I, kt, kh, kw) -> the port's (kt, kh, kw, I, O)."""
    if w.ndim != 5:
        raise ValueError(f"expected an OIDHW conv3d weight, got {w.shape}")
    return np.transpose(w, (2, 3, 4, 1, 0))


def _dense_w(w: np.ndarray) -> np.ndarray:
    if w.ndim != 2:
        raise ValueError(f"expected an (out, in) dense weight, got {w.shape}")
    return np.transpose(w)


def _qkv_mcs_to_smc(w_oihw: np.ndarray, num_heads: int) -> np.ndarray:
    """Permute a qkv projection's output channels from the original's
    (m c s) interleave to the port's contiguous (s m c) layout
    (models/attention.py::_split_qkv). A relabeling of rows."""
    o, i, kh, kw = w_oihw.shape
    c = o // (3 * num_heads)
    return (w_oihw.reshape(num_heads, c, 3, i, kh, kw)
            .transpose(2, 0, 1, 3, 4, 5).reshape(o, i, kh, kw))


def _qkv_smc_to_mcs(w_oihw: np.ndarray, num_heads: int) -> np.ndarray:
    """The inverse of _qkv_mcs_to_smc."""
    o, i, kh, kw = w_oihw.shape
    c = o // (3 * num_heads)
    return (w_oihw.reshape(3, num_heads, c, i, kh, kw)
            .transpose(1, 2, 0, 3, 4, 5).reshape(o, i, kh, kw))


def _set(state: dict, name: str, value) -> None:
    """state[name] <- value, which must have the entry's shape; it keeps
    the entry's dtype."""
    old = state[name]
    value = np.asarray(value, dtype=np.float32)
    if value.shape != tuple(old.shape):
        raise ValueError(f"shape mismatch at {name}: checkpoint {value.shape} vs "
                         f"model {tuple(old.shape)}")
    state[name] = torch.from_numpy(value.copy()).to(old.dtype)


def _copy_state(state) -> tuple:
    """(a new {name: tensor} dict of detached CPU copies, the UNet's prefix)."""
    out = {k: v.detach().cpu().clone() for k, v in state.items()}
    root = "unet." if any(k.startswith("unet.") for k in out) else ""
    return out, root


def _as_numpy(sd) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in sd.items()}


def _num_heads(spec, cfg) -> int:
    return spec["cout"] // cfg.channels_per_head


# ---------------------------------------------------------------------------
# NVIDIA EDM2 2D checkpoints
# ---------------------------------------------------------------------------

def _import_causal_conv(state: dict, at: str, sd, prefix: str) -> None:
    """2D conv weight -> last_frame_conv of an MPCausalConv3d."""
    _set(state, f"{at}.last_frame_conv.w", _conv_w(sd[prefix + ".weight"]))


def _import_block(state: dict, at: str, sd, prefix: str, num_heads: int = 0) -> None:
    _import_causal_conv(state, f"{at}.conv_res0", sd, prefix + ".conv_res0")
    _import_causal_conv(state, f"{at}.conv_res1", sd, prefix + ".conv_res1")
    if prefix + ".conv_skip.weight" in sd:
        _set(state, f"{at}.conv_skip.w", _conv_w(sd[prefix + ".conv_skip.weight"]))
    if prefix + ".emb_linear.weight" in sd:
        _set(state, f"{at}.emb_linear.w", _dense_w(sd[prefix + ".emb_linear.weight"]))
    if prefix + ".emb_gain" in sd:
        _set(state, f"{at}.emb_gain", sd[prefix + ".emb_gain"].reshape(()))
    if prefix + ".attn_qkv.weight" in sd:
        qkv = _qkv_mcs_to_smc(sd[prefix + ".attn_qkv.weight"], num_heads)
        _set(state, f"{at}.attn.attn_qkv.w", _conv_w(qkv))
        _set(state, f"{at}.attn.attn_proj.w", _conv_w(sd[prefix + ".attn_proj.weight"]))


def import_torch_edm2(state, sd, cfg) -> dict:
    """A copy of the port's `state` with every 2D-derivable weight replaced
    by the NVIDIA EDM2 2D checkpoint `sd`; `cfg` is the model's UNetConfig."""
    sd = _as_numpy(sd)
    state, root = _copy_state(state)
    for side, name, spec in cfg.block_layout():
        if side == "out":
            _import_causal_conv(state, f"{root}out_conv", sd, "out_conv")
            continue
        at, prefix = f"{root}{side}_{name}", f"{side}.{name}"
        if spec["kind"] == "conv":
            _import_causal_conv(state, at, sd, prefix)
        else:
            _import_block(state, at, sd, prefix, _num_heads(spec, cfg))
    _set(state, f"{root}emb_noise.w", _dense_w(sd["emb_noise.weight"]))
    if cfg.label_dim and "emb_label.weight" in sd:
        _set(state, f"{root}emb_label.w", _dense_w(sd["emb_label.weight"]))
    _set(state, f"{root}out_gain", sd["out_gain"].reshape(()))
    if f"{root}emb_fourier_sigma.freqs" in state:
        _set(state, f"{root}emb_fourier_sigma.freqs", sd["emb_fourier.freqs"])
        _set(state, f"{root}emb_fourier_sigma.phases", sd["emb_fourier.phases"])
    return state


def export_2d_state(state, cfg) -> Dict[str, np.ndarray]:
    """The inverse of `import_torch_edm2` for the 2D-derivable subset: the
    video UNet's per-frame weights in NVIDIA EDM2 2D naming."""
    root = "unet." if any(k.startswith("unet.") for k in state) else ""
    p = {k[len(root):]: v.detach().cpu().float().numpy().copy() for k, v in state.items()
         if k.startswith(root)}

    def conv_back(w):
        return np.transpose(w, (3, 2, 0, 1))

    sd: Dict[str, np.ndarray] = {}
    for side, name, spec in cfg.block_layout():
        if side == "out":
            sd["out_conv.weight"] = conv_back(p["out_conv.last_frame_conv.w"])
            continue
        at, prefix = f"{side}_{name}", f"{side}.{name}"
        if spec["kind"] == "conv":
            sd[prefix + ".weight"] = conv_back(p[f"{at}.last_frame_conv.w"])
            continue
        for conv in ("conv_res0", "conv_res1"):
            sd[f"{prefix}.{conv}.weight"] = conv_back(p[f"{at}.{conv}.last_frame_conv.w"])
        if f"{at}.conv_skip.w" in p:
            sd[prefix + ".conv_skip.weight"] = conv_back(p[f"{at}.conv_skip.w"])
        sd[prefix + ".emb_linear.weight"] = np.transpose(p[f"{at}.emb_linear.w"])
        sd[prefix + ".emb_gain"] = p[f"{at}.emb_gain"].reshape(())
        if f"{at}.attn.attn_qkv.w" in p:
            qkv = conv_back(p[f"{at}.attn.attn_qkv.w"])
            sd[prefix + ".attn_qkv.weight"] = _qkv_smc_to_mcs(qkv, _num_heads(spec, cfg))
            sd[prefix + ".attn_proj.weight"] = conv_back(p[f"{at}.attn.attn_proj.w"])
    sd["emb_noise.weight"] = np.transpose(p["emb_noise.w"])
    if "emb_label.w" in p:
        sd["emb_label.weight"] = np.transpose(p["emb_label.w"])
    sd["out_gain"] = p["out_gain"].reshape(())
    if "emb_fourier_sigma.freqs" in p:
        sd["emb_fourier.freqs"] = p["emb_fourier_sigma.freqs"]
        sd["emb_fourier.phases"] = p["emb_fourier_sigma.phases"]
    return sd


# ---------------------------------------------------------------------------
# The original's full 3D checkpoints
# ---------------------------------------------------------------------------

def _import_gating(state: dict, at: str, sd, prefix: str) -> None:
    """The original's Gating parameters (edm2/conv.py:104-110)."""
    _set(state, f"{at}.offset", sd[prefix + ".offset"])
    _set(state, f"{at}.mult", sd[prefix + ".mult"])
    _set(state, f"{at}.max_gating", np.reshape(sd[prefix + ".max_gating"], ()))
    _set(state, f"{at}.min_gating", np.reshape(sd[prefix + ".min_gating"], ()))


def _import_causal_conv_3d(state: dict, at: str, sd, prefix: str) -> None:
    """The full MPCausal3DGatedConv: 2D last-frame conv, the (kt-1) temporal
    context conv and the gating."""
    _set(state, f"{at}.last_frame_conv.w",
         _conv_w(sd[prefix + ".last_frame_conv.weight.weight"]))
    _set(state, f"{at}.w", _conv3d_w(sd[prefix + ".weight.weight"]))
    _import_gating(state, f"{at}.gating", sd, prefix + ".gating")


def _import_block_3d(state: dict, at: str, sd, prefix: str, num_heads: int = 0) -> None:
    _import_causal_conv_3d(state, f"{at}.conv_res0", sd, prefix + ".conv_res0")
    _import_causal_conv_3d(state, f"{at}.conv_res1", sd, prefix + ".conv_res1")
    if prefix + ".conv_skip.weight.weight" in sd:
        _set(state, f"{at}.conv_skip.w", _conv_w(sd[prefix + ".conv_skip.weight.weight"]))
    _set(state, f"{at}.emb_linear.w", _dense_w(sd[prefix + ".emb_linear.weight.weight"]))
    _set(state, f"{at}.emb_gain", np.reshape(sd[prefix + ".emb_gain"], ()))
    # the original's 3D Block holds its attention as a submodule `attn`
    # (`enc.16x16_block0.attn.attn_qkv.weight.weight`), where the 2D EDM2
    # Block holds attn_qkv itself
    if f"{at}.attn.attn_qkv.w" in state:
        qkv = _qkv_mcs_to_smc(sd[prefix + ".attn.attn_qkv.weight.weight"], num_heads)
        _set(state, f"{at}.attn.attn_qkv.w", _conv_w(qkv))
        _set(state, f"{at}.attn.attn_proj.w",
             _conv_w(sd[prefix + ".attn.attn_proj.weight.weight"]))


def import_torch_3d(state, sd, cfg) -> dict:
    """A copy of the port's `state` with every parameter and buffer taken
    from the original's full 3D UNet state dict `sd` (torch naming,
    `enc.16x16_block0.conv_res0.weight.weight`); `cfg` is the model's
    UNetConfig. Entries of `sd` the port has no counterpart for (the
    original's unused time embedding) are ignored."""
    sd = _as_numpy(sd)
    state, root = _copy_state(state)
    for side, name, spec in cfg.block_layout():
        if side == "out":
            _import_causal_conv_3d(state, f"{root}out_conv", sd, "out_conv")
            continue
        at, prefix = f"{root}{side}_{name}", f"{side}.{name}"
        if spec["kind"] == "conv":
            _import_causal_conv_3d(state, at, sd, prefix)
        else:
            _import_block_3d(state, at, sd, prefix, _num_heads(spec, cfg))
    _set(state, f"{root}emb_noise.w", _dense_w(sd["emb_noise.weight.weight"]))
    if cfg.label_dim and "emb_label.weight.weight" in sd:
        _set(state, f"{root}emb_label.w", _dense_w(sd["emb_label.weight.weight"]))
    _set(state, f"{root}out_gain", np.reshape(sd["out_gain"], ()))
    _import_gating(state, f"{root}out_res", sd, "out_res")
    if f"{root}emb_fourier_sigma.freqs" in state:
        _set(state, f"{root}emb_fourier_sigma.freqs", sd["emb_fourier_sigma.freqs"])
        _set(state, f"{root}emb_fourier_sigma.phases", sd["emb_fourier_sigma.phases"])
    return state
