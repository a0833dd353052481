"""Power-function EMA (Karras et al., "Analyzing and Improving the Training
Dynamics of Diffusion Models").

Counterpart of autoregressive_diffusion_tpu/train/ema.py: the EMA copies are
{parameter name: tensor} dicts kept in the train state and lerped in place
after every optimizer step. The post-hoc reconstruction helpers are host
numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def exp_to_std(exp):
    """Eq. 123."""
    exp = np.float64(exp)
    return np.sqrt((exp + 1) / (exp + 2) ** 2 / (exp + 3))


def std_to_exp(std):
    """Eq. 126 / Algorithm 2."""
    std = np.float64(std)
    tmp = np.atleast_1d(std).flatten() ** -2
    exp = [np.roots([1, 7, 16 - t, 12 - t]).real.max() for t in tmp]
    return np.float64(exp).reshape(np.shape(std))


def power_function_beta(std, t_next, t_delta):
    """Eq. 127."""
    gamma = float(std_to_exp(std))
    return (1.0 - t_delta / t_next) ** (gamma + 1.0)


def power_function_response(ofs, std, length, axis=0):
    """Eq. 121/108."""
    ofs, std = np.broadcast_arrays(ofs, std)
    ofs = np.stack([np.float64(ofs)], axis=axis)
    exp = np.stack([std_to_exp(std)], axis=axis)
    s = [1] * exp.ndim
    s[axis] = -1
    t = np.arange(length).reshape(s)
    resp = np.where(t <= ofs, (t / ofs) ** exp, 0) / ofs * (exp + 1)
    return resp / np.sum(resp, axis=axis, keepdims=True)


def power_function_correlation(a_ofs, a_std, b_ofs, b_std):
    """Eq. 151 / Algorithm 3."""
    a_exp = std_to_exp(a_std)
    b_exp = std_to_exp(b_std)
    t_ratio = a_ofs / b_ofs
    t_exp = np.where(a_ofs < b_ofs, b_exp, -a_exp)
    t_max = np.maximum(a_ofs, b_ofs)
    num = (a_exp + 1) * (b_exp + 1) * t_ratio**t_exp
    den = (a_exp + b_exp + 1) * t_max
    return num / den


def solve_posthoc_coefficients(in_ofs, in_std, out_ofs, out_std):
    """Algorithm 3: coefficients to reconstruct an arbitrary EMA profile
    from training snapshots."""
    in_ofs, in_std = np.broadcast_arrays(in_ofs, in_std)
    out_ofs, out_std = np.broadcast_arrays(out_ofs, out_std)
    rv = lambda x: np.float64(x).reshape(-1, 1)
    cv = lambda x: np.float64(x).reshape(1, -1)
    a = power_function_correlation(rv(in_ofs), rv(in_std), cv(in_ofs), cv(in_std))
    b = power_function_correlation(rv(in_ofs), rv(in_std), cv(out_ofs), cv(out_std))
    x = np.linalg.solve(a, b)
    return x / np.sum(x, axis=0)


@torch.no_grad()
def ema_update(ema_params: dict, params: dict, beta: float) -> dict:
    """p_ema <- lerp(p_ema, p, 1 - beta) for every entry, in place."""
    names = list(ema_params)
    torch._foreach_lerp_([ema_params[n] for n in names],
                         [params[n].detach() for n in names], 1.0 - beta)
    return ema_params


@torch.no_grad()
def init_ema(params: dict, stds=(0.050, 0.100)) -> tuple:
    """Deep copies of the parameters, one {name: tensor} dict per EMA std."""
    return tuple({n: p.detach().clone() for n, p in params.items()} for _ in stds)


def traditional_ema_beta(cur_nimg, batch_size, halflife_Mimg=float("inf"),
                         rampup_ratio=0.09) -> float:
    """The classic half-life EMA decay with rampup (the original's
    TraditionalEMA.update): beta = 0.5 ** (batch / halflife_imgs), the
    halflife ramped as min(halflife, nimg * rampup_ratio). Use with
    `ema_update`. Host arithmetic in fp32, as the JAX package's jnp."""
    f32 = np.float32
    halflife = f32(halflife_Mimg)
    if rampup_ratio is not None:
        halflife = np.minimum(halflife, f32(cur_nimg) / f32(1e6) * f32(rampup_ratio))
    return float(f32(0.5) ** (f32(batch_size) / np.maximum(halflife * f32(1e6), f32(1e-8))))
