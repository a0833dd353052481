"""Weight bridge from the JAX package's variables to the port's modules.

The JAX `variables` tree is {"params": {...}, "buffers": {...}} of nested
dicts of numpy arrays (flax names). The port's modules carry the same names
and layouts (HWIO / DHWIO / (in, out) weights, scalar gains and gating
parameters as 0-dim tensors), so the bridge flattens the tree with "." and
drops the collection name: params/unet/enc_64x64_conv/gating/offset becomes
unet.enc_64x64_conv.gating.offset. A JAX TrainState's params, buffers,
EMA trees, loss-weight coefficients, step and AdamW moments go into the
port's TrainState the same way (`load_jax_train_state`), and
`train_state_tree` is the inverse: the port's TrainState as the JAX-named
tree of numpy arrays that the train-state checkpoints hold
(utils/checkpoint.save_train_state), read back by `load_train_state_tree`.
The AdamW moments are optax's mu and nu under the parameters' names, and
its count is torch's per-parameter step (equal for every parameter).
`to_jax_names` is the flat inverse for parameters and gradients, so that
the two sides can be compared leaf by leaf. This module
takes plain numpy arrays and never imports JAX.

Leaves keep their meaning: int8 leaves (the `w_q` of int8 decode weights)
stay int8, bfloat16 leaves (utils/checkpoint.BFloat16Leaf, or a bf16
array of another library) widen exactly to fp32, everything else becomes
fp32. `from_bundle` builds the denoiser from a `.ad` bundle, optionally
with int8 decode weights; `vae_from_bundle` does the same for the VAE.
`load_flax_variables` / `flax_variables` carry the modules that keep
torch's layouts under flax's tree names both ways (the VAE with its
buffers, the discriminator with its batch_stats): flax's conv `kernel`
(DHWIO / HWIO) and Dense kernel (in, out) are torch's `weight` (O, I, D, H,
W) / (O, I, H, W) and (out, in), a norm's `scale` is its `weight`; so a VAE
trained by the port is saved in the JAX package's tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .checkpoint import BFloat16Leaf, load_model
from .device import resolve_device


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, name)
        else:
            yield name, val


def leaf_tensor(val) -> torch.Tensor:
    """One tree leaf as a CPU tensor (the leaf's one copy): int8 stays int8,
    a bfloat16 leaf widens exactly, anything else becomes fp32."""
    if isinstance(val, BFloat16Leaf):
        return torch.from_numpy(val.float32())
    arr = np.asarray(val)
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def state_from_jax(variables) -> dict:
    """{state_dict key: tensor} from a JAX variables tree (see leaf_tensor)."""
    state = {}
    for collection in ("params", "buffers"):
        for name, val in _flatten(variables.get(collection, {})):
            state[name] = leaf_tensor(val)
    return state


def _load_state(model: torch.nn.Module, state: dict, what: str) -> torch.nn.Module:
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing[:8]}, unexpected {extra[:8]}")
    for name, val in state.items():
        if tuple(own[name].shape) != tuple(val.shape):
            raise ValueError(f"{what}: {name} is {tuple(val.shape)}, "
                             f"the port expects {tuple(own[name].shape)}")
        if (own[name].dtype == torch.int8) != (val.dtype == torch.int8):
            raise TypeError(f"{what}: {name} is {val.dtype}, the port holds {own[name].dtype}")
    model.load_state_dict(state)
    return model


@torch.no_grad()
def load_jax_variables(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Copy a JAX variables tree into `model`; every parameter and buffer
    must be matched by name, shape and (int8 or not) type, and nothing may
    be left over."""
    return _load_state(model, state_from_jax(variables), "weight bridge")


def _nest(named) -> dict:
    """{dotted name: leaf} -> the nested tree of the JAX package's names."""
    out = {}
    for name, leaf in named:
        node = out
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of t that no later in-place update of t reaches (int8
    stays int8, the rest fp32)."""
    t = t.detach()
    return t.to("cpu", dtype=t.dtype if t.dtype == torch.int8 else torch.float32,
                copy=True).numpy()


def jax_variables(model: torch.nn.Module) -> dict:
    """The inverse of load_jax_variables: {"params": tree, "buffers": tree}
    of numpy copies of `model`'s parameters and buffers (int8 stays int8,
    the rest fp32), under the JAX package's names."""
    return {"params": _nest((n, _host(t)) for n, t in model.named_parameters()),
            "buffers": _nest((n, _host(t)) for n, t in model.named_buffers())}


# flax kernel layouts (DHWIO, HWIO, (in, out)) -> torch's, by rank
_TO_TORCH = {5: (4, 3, 0, 1, 2), 4: (3, 2, 0, 1), 2: (1, 0)}
_TO_FLAX = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _torch_leaf(name: str, t: torch.Tensor):
    """A flax leaf under the torch-layout module's name: a `kernel` becomes
    a `weight` in torch's layout, a norm's `scale` its `weight`."""
    head, _, leaf = name.rpartition(".")
    if leaf == "kernel":
        return f"{head}.weight", t.permute(_TO_TORCH[t.ndim])
    if leaf == "scale":
        return f"{head}.weight", t
    return name, t


def _flax_leaf(name: str, t: torch.Tensor):
    """The inverse of _torch_leaf: a weight of rank >= 2 is a kernel, of rank
    1 a norm's scale."""
    head, _, leaf = name.rpartition(".")
    if leaf == "weight":
        return ((f"{head}.kernel", t.permute(_TO_FLAX[t.ndim])) if t.ndim >= 2
                else (f"{head}.scale", t))
    return name, t


@torch.no_grad()
def load_flax_variables(module: torch.nn.Module, variables,
                        what: str = "flax bridge") -> torch.nn.Module:
    """Copy a flax variables tree ("params" and "buffers" or
    "batch_stats") into a torch-layout module of the same tree names (the
    VAE, the discriminator): `kernel` leaves become `weight`, DHWIO / HWIO
    conv kernels torch's (O, I, D, H, W) / (O, I, H, W) and (in, out) Dense
    kernels (out, in); a norm's `scale` becomes its `weight`; biases,
    scalars, buffers and batch statistics keep their names and layouts."""
    state = {}
    for collection in ("params", "buffers", "batch_stats"):
        for name, val in _flatten(variables.get(collection, {})):
            name, t = _torch_leaf(name, leaf_tensor(val))
            state[name] = t.contiguous()
    return _load_state(module, state, what)


def flax_variables(module: torch.nn.Module, buffers: str = "buffers") -> dict:
    """The inverse of load_flax_variables: {"params": tree, buffers: tree}
    of fp32 numpy copies in flax's names and layouts. buffers names the
    collection of the module's buffers: "buffers" for the VAE's Fourier
    features, "batch_stats" for the discriminator's running statistics."""
    def tree(named):
        return _nest((n, _host(t.contiguous())) for n, t in
                     (_flax_leaf(n, t) for n, t in named))
    return {"params": tree(module.named_parameters()), buffers: tree(module.named_buffers())}


def to_flax_names(named) -> dict:
    """{flax path joined by "/": fp32 numpy array} from {torch name: tensor}
    of a torch-layout module (its parameters, their .grad, optimizer
    moments), in flax's layouts; None entries are left out."""
    out = {}
    for name, t in named.items():
        if t is not None:
            name, t = _flax_leaf(name, t.detach())
            out[name.replace(".", "/")] = _host(t.contiguous())
    return out


def _config_kwargs(kwargs: dict) -> dict:
    """Bundle kwargs (JSON lists) as dataclass arguments (tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}


def build_precond(cfg, variables, device="cuda", body_dtype=torch.bfloat16,
                  int8: bool = False):
    """The denoiser for `cfg` with `variables` (a JAX-layout tree) on
    `device`, in eval mode: a Precond with sigma_data=1 (scripts/generate.py).
    With int8, the weights are renormalized (forced weight norm), quantized
    per output channel and served by the decode_quant model, whose K/V rings
    are int8 too (bench.py's rollout); a tree that is already quantized is
    served as it is."""
    from ..models import Precond
    from ..train.quantize import normalize_weights, quantize_variables, quantized_config

    dev = resolve_device(device)
    if int8 and not cfg.decode_quant:
        variables = dict(variables, params=normalize_weights(variables["params"]))
        variables = quantize_variables(variables)
        cfg = quantized_config(cfg)
    model = Precond(cfg, sigma_data=1.0, body_dtype=body_dtype)
    load_jax_variables(model, variables)
    return model.to(dev).eval()


def from_bundle(path, device="cuda", body_dtype=torch.bfloat16, int8: bool = False):
    """build_precond on the config and weights of a `.ad` bundle."""
    from ..models import UNetConfig

    kwargs, variables = load_model(path)
    return build_precond(UNetConfig(**_config_kwargs(kwargs)), variables, device,
                         body_dtype, int8)


def vae_from_bundle(path, device="cuda"):
    """(VAE on `device` in eval mode, the bundle's extra tree or None) from
    a VAE `.ad` bundle."""
    from ..models.vae import VAE, VAEConfig

    dev = resolve_device(device)
    kwargs, variables, extra = load_model(path, with_extra=True)
    vae = VAE(VAEConfig(**_config_kwargs(kwargs)))
    load_flax_variables(vae, variables, "VAE bridge")
    return vae.to(dev).eval(), extra


@torch.no_grad()
def load_jax_train_state(state, params, buffers, ema=None, coefs=None, step: int = 0,
                         opt_state=None):
    """Copy a JAX TrainState's leaves (numpy trees) into the port's
    TrainState `state`, in place: params and buffers into the model, each
    EMA tree into the matching EMA copy (default: copies of params), coefs
    (7, 1), the step count and, if given, the AdamW state
    {"mu": tree, "nu": tree, "count": n} (optax's ScaleByAdamState; without
    it the optimizer keeps its own state)."""
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
    if opt_state is not None:
        _load_adamw(state, opt_state["mu"], opt_state["nu"], int(np.asarray(opt_state["count"])))
    state.step = int(step)
    return state


def _named_opt_params(state):
    """[(name, parameter)] in the optimizer's order."""
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    return [(name_of[id(p)], p) for g in state.opt_state.param_groups for p in g["params"]]


def _adamw_tree(state, gather=None) -> dict:
    """The AdamW state as optax names it: mu, nu (trees of the parameters'
    names) and count, the number of updates taken. gather(names, tensors),
    if given, maps the moments to their full tensors first
    (parallel/mesh.py)."""
    opt = state.opt_state
    named = _named_opt_params(state)
    names = [n for n, _ in named]
    counts = {int(float(opt.state[p]["step"])) if opt.state.get(p) else 0 for _, p in named}
    if len(counts) != 1:
        raise ValueError(f"train bridge: AdamW step counts differ between parameters: {counts}")
    moments = {}
    for k in ("exp_avg", "exp_avg_sq"):
        ts = [opt.state[p][k] if opt.state.get(p) else torch.zeros_like(p) for _, p in named]
        moments[k] = ts if gather is None else gather(names, ts)
    return {"mu": _nest(zip(names, map(_host, moments["exp_avg"]))),
            "nu": _nest(zip(names, map(_host, moments["exp_avg_sq"]))),
            "count": np.asarray(counts.pop(), np.int32)}


def _load_adamw(state, mu_tree, nu_tree, count: int) -> None:
    """Set the optimizer's moments and step count from optax-named trees;
    the bias correction then goes on from update `count`."""
    opt = state.opt_state
    named = _named_opt_params(state)
    mu, nu = dict(_flatten(mu_tree)), dict(_flatten(nu_tree))
    if set(mu) != {n for n, _ in named} or set(nu) != set(mu):
        raise KeyError("train bridge: AdamW moment names differ from the model's")
    sd = opt.state_dict()
    sd["state"] = {} if count == 0 else {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[n], dtype=np.float32)),
            "exp_avg_sq": torch.from_numpy(np.array(nu[n], dtype=np.float32))}
        for i, (n, _) in enumerate(named)}
    opt.load_state_dict(sd)  # moves the moments to each parameter's device


def train_state_tree(state, gather=None) -> dict:
    """The port's TrainState as host numpy copies under the JAX package's
    names: {"step", "params", "buffers", "ema": {"0": tree, ...},
    "ema_stds", "opt_state": {"mu", "nu", "count"}, "coefs"}.
    gather(names, tensors), if given, maps the parameters, each EMA copy and
    each AdamW moment to their full tensors first
    (parallel/mesh.gather_to_host)."""
    full = (lambda names, ts: ts) if gather is None else gather

    def tree(named):
        names, ts = zip(*named) if named else ((), ())
        return _nest(zip(names, map(_host, full(list(names), list(ts)))))

    return {"step": np.asarray(state.step, np.int64),
            "params": tree(list(state.model.named_parameters())),
            "buffers": _nest((n, _host(t)) for n, t in state.model.named_buffers()),
            "ema": {str(i): tree(list(e.items())) for i, e in enumerate(state.ema)},
            "ema_stds": np.asarray(state.ema_stds, np.float64),
            "opt_state": _adamw_tree(state, gather),
            "coefs": _host(state.coefs)}


def load_train_state_tree(state, tree) -> None:
    """The inverse of train_state_tree, into `state` in place."""
    stds = tuple(float(x) for x in np.asarray(tree["ema_stds"]).reshape(-1))
    if stds != tuple(float(x) for x in state.ema_stds):
        raise ValueError(f"train bridge: EMA stds {stds} != the state's {state.ema_stds}")
    load_jax_train_state(state, tree["params"], tree.get("buffers", {}),
                         [tree["ema"][str(i)] for i in range(len(stds))], tree["coefs"],
                         int(np.asarray(tree["step"])), opt_state=tree["opt_state"])


def to_jax_names(named) -> dict:
    """{JAX path joined by "/": fp32 numpy array} from the port's
    {dotted name: tensor} (parameters, their .grad, or an EMA copy). None
    entries (a parameter that no gradient reached) are left out. The arrays
    are copies: a later in-place train step does not change them."""
    return {name.replace(".", "/"): t.detach().float().cpu().numpy().copy()
            for name, t in named.items() if t is not None}
