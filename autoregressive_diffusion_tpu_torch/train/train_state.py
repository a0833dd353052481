"""Train state + the DART train step.

Counterpart of autoregressive_diffusion_tpu/train/train_state.py: one call
performs loss, gradients, global-norm clip, AdamW, forced weight renorm and
the power-function EMA update, optionally accumulating gradients over
microbatch slices. Where the JAX step is a pure function of an immutable
state, this one updates the model's parameters, the optimizer state and the
EMA copies in place and returns the same TrainState object.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from .ema import ema_update, init_ema, std_to_exp
from .loss import EDM2LossConfig, edm2_loss
from .loss_weight import init_coefs
from .optim import ClippedAdamW, forced_weight_norm


@dataclasses.dataclass
class TrainState:
    step: int                      # optimizer steps taken
    model: torch.nn.Module         # parameters and buffers (MPFourier freqs/phases)
    opt_state: torch.optim.Optimizer
    ema: Tuple[dict, ...]          # one {name: tensor} copy per EMA std
    coefs: torch.Tensor            # MultiNoiseLoss Fourier coefficients (7, 1)
    ema_stds: Tuple[float, ...] = (0.050, 0.100)

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())


def create_train_state(model, tx: ClippedAdamW, ema_stds=(0.050, 0.100)) -> TrainState:
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(step=0, model=model, opt_state=tx.init(params.values()),
                      ema=init_ema(params, ema_stds), coefs=init_coefs(device),
                      ema_stds=tuple(ema_stds))


def make_train_step(loss_cfg: EDM2LossConfig, tx: ClippedAdamW, batch_size: int,
                    microbatch: Optional[int] = None):
    """Returns train_step(state, images, conditioning, seed, just_2d=False,
    sigma=None, noise=None) -> (state, metrics).

    If `microbatch` is given and smaller than the batch, gradients are
    accumulated over microbatch slices (constant activation memory); slice j
    draws samples [j*m, (j+1)*m) from the generators the full batch would
    use, so accumulation equals the full-batch step. `sigma` and `noise`
    (over the whole batch) bypass the sampling, as in edm2_loss.
    """

    def grads_of(state, images, conditioning, seed, just_2d, sigma, noise):
        model = state.model
        model.zero_grad(set_to_none=True)
        b = images.shape[0]
        m = b if microbatch is None or microbatch >= b else microbatch
        if b % m:
            raise ValueError(f"batch {b} is not a multiple of microbatch {m}")
        n = b // m
        loss_sum, unweighted, sigs, lss = 0.0, 0.0, [], []
        for j in range(n):
            sl = slice(j * m, (j + 1) * m)
            loss, aux = edm2_loss(
                model, images[sl], seed, loss_cfg,
                conditioning[sl] if conditioning is not None else None, state.coefs,
                just_2d, sample_offset=j * m,
                sigma=None if sigma is None else sigma[sl],
                noise=None if noise is None else noise[sl])
            (loss / n).backward()  # gradients add up in .grad
            loss_sum = loss_sum + loss.detach() / n
            unweighted = unweighted + aux["unweighted"] / n
            sigs.append(aux["sigma"])
            lss.append(aux["losses"])
        aux = dict(sigma=torch.cat(sigs), losses=torch.cat(lss), unweighted=unweighted)
        return loss_sum, aux

    def train_step(state: TrainState, images, conditioning, seed: int,
                   just_2d: bool = False, sigma=None, noise=None):
        loss, aux = grads_of(state, images, conditioning, seed, just_2d, sigma, noise)
        grad_norm = tx.update(state.opt_state, state.step)
        params = state.params
        forced_weight_norm(params)

        # power-function EMA
        step1 = state.step + 1
        cur_nimg = float(step1) * batch_size
        for std, e in zip(state.ema_stds, state.ema):
            gamma = float(std_to_exp(std))
            beta = (1.0 - batch_size / cur_nimg) ** (gamma + 1.0)
            ema_update(e, params, beta)
        state.step = step1
        metrics = dict(loss=loss, unweighted=aux["unweighted"], sigma=aux["sigma"],
                       losses=aux["losses"], grad_norm=grad_norm)
        return state, metrics

    return train_step
