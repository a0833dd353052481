"""Weight bridge from the JAX package's variables to the port's modules.

The JAX `variables` tree is {"params": {...}, "buffers": {...}} of nested
dicts of numpy arrays (flax names). The port's modules carry the same names
and layouts (HWIO / DHWIO / (in, out) weights, scalar gains and gating
parameters as 0-dim tensors), so the bridge flattens the tree with "." and
drops the collection name: params/unet/enc_64x64_conv/gating/offset becomes
unet.enc_64x64_conv.gating.offset. A JAX TrainState's params, buffers,
EMA trees and loss-weight coefficients go into the port's TrainState the
same way (the optimizer moments are not bridged: the state starts from a
fresh optimizer), and `to_jax_names` is the inverse for parameters and
gradients, so that the two sides can be compared leaf by leaf. This module
takes plain numpy arrays and never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, name)
        else:
            yield name, val


def state_from_jax(variables) -> dict:
    """{state_dict key: fp32 tensor} from a JAX variables tree."""
    state = {}
    for collection in ("params", "buffers"):
        for name, val in _flatten(variables.get(collection, {})):
            state[name] = torch.from_numpy(np.array(val, dtype=np.float32))
    return state


@torch.no_grad()
def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a JAX variables tree into `model`; every parameter and buffer
    must be matched by name and shape, and nothing may be left over."""
    state = state_from_jax(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"weight bridge: missing {missing[:8]}, unexpected {extra[:8]}")
    for name, val in state.items():
        if tuple(own[name].shape) != tuple(val.shape):
            raise ValueError(f"weight bridge: {name} is {tuple(val.shape)}, "
                             f"the port expects {tuple(own[name].shape)}")
    model.load_state_dict(state)
    return model


@torch.no_grad()
def load_jax_train_state(state, params, buffers, ema=None, coefs=None, step: int = 0):
    """Copy a JAX TrainState's leaves (numpy trees) into the port's
    TrainState `state`, in place: params and buffers into the model, each
    EMA tree into the matching EMA copy (default: copies of params), coefs
    (7, 1) and the step count."""
    load_jax_variables(state.model, {"params": params, "buffers": buffers})
    ema = tuple(ema) if ema is not None else (params,) * len(state.ema)
    if len(ema) != len(state.ema):
        raise ValueError(f"train bridge: {len(ema)} EMA trees for {len(state.ema)} stds")
    for own, tree in zip(state.ema, ema):
        flat = dict(_flatten(tree))
        if set(flat) != set(own):
            raise KeyError("train bridge: EMA tree names differ from the model's")
        for name, val in flat.items():
            own[name].copy_(torch.from_numpy(np.array(val, dtype=np.float32)))
    if coefs is not None:
        state.coefs.copy_(torch.from_numpy(np.array(coefs, dtype=np.float32)))
    state.step = int(step)
    return state


def to_jax_names(named) -> dict:
    """{JAX path joined by "/": fp32 numpy array} from the port's
    {dotted name: tensor} (parameters, their .grad, or an EMA copy). None
    entries (a parameter that no gradient reached) are left out. The arrays
    are copies: a later in-place train step does not change them."""
    return {name.replace(".", "/"): t.detach().float().cpu().numpy().copy()
            for name, t in named.items() if t is not None}
