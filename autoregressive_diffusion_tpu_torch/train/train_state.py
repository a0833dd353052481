"""Train state + the DART train step.

Counterpart of autoregressive_diffusion_tpu/train/train_state.py: one call
performs loss, gradients, global-norm clip, AdamW, forced weight renorm and
the power-function EMA update, optionally accumulating gradients over
microbatch slices. Where the JAX step is a pure function of an immutable
state, this one updates the model's parameters, the optimizer state and the
EMA copies in place and returns the same TrainState object. Its spans
(utils/profiling.span): train.step around the call; train.forward and
train.backward for each microbatch; train.optimizer (clip + AdamW),
train.weight_norm and train.ema.

With a mesh (parallel.create_mesh) the step is one rank's part of a
replica x data x seq x model parallel step: the rank's samples and frames
run through the model under the sequence-parallel context, and every
gradient is summed exactly once before the clip (so its norm is the global
one): replicated and TP-sharded leaves over replica x data x seq, never
over `model` (each model rank holds the same gradient for a replicated
leaf), FSDP leaves reduce-scattered over `data` in the backward and summed
over replica x seq (parallel/mesh.all_reduce_grads). The optimizer, the
forced weight norm and the EMA then run on each rank's shards
(parallel.shard_train_state; on the whole leaves when nothing is
sharded). The metrics are global and count each term once.

`make_scanned_train_step` and `make_replay_train_step` run G steps a call,
where the JAX package scans them on the device to hide its host link: here
they are plain loops of the step, the replay step gathering each step's
batch from rings on the card (data/replay.py::DeviceReplay).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..ops.flash_attention import set_sp_context, sp_context
from ..parallel.collectives import all_reduce_sum_
from ..parallel.mesh import all_reduce_grads, gather_batch
from ..utils.profiling import span
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
    mesh: Any = None               # set with specs by parallel.shard_train_state
    specs: Optional[dict] = None   # {parameter name: spec}: params, EMA, AdamW are shards

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
                    microbatch: Optional[int] = None, mesh=None):
    """Returns train_step(state, images, conditioning, seed, just_2d=False,
    sigma=None, noise=None) -> (state, metrics).

    `batch_size` is the global batch. With a `mesh`, images and
    conditioning are this rank's slice (parallel.seq_slice) and `microbatch`
    counts this rank's samples; every rank of the mesh must call the step.

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
        first = 0 if mesh is None else mesh.batch_rank * b  # global index of sample 0
        loss_sum, unweighted, sigs, lss = 0.0, 0.0, [], []
        for j in range(n):
            sl = slice(j * m, (j + 1) * m)
            with span("train.forward", microbatch=j):
                loss, aux = edm2_loss(
                    model, images[sl], seed, loss_cfg,
                    conditioning[sl] if conditioning is not None else None, state.coefs,
                    just_2d, sample_offset=first + j * m,
                    sigma=None if sigma is None else sigma[sl],
                    noise=None if noise is None else noise[sl], mesh=mesh)
            with span("train.backward", microbatch=j):
                (loss / n).backward()  # gradients add up in .grad
            loss_sum = loss_sum + loss.detach() / n
            unweighted = unweighted + aux["unweighted"] / n
            sigs.append(aux["sigma"])
            lss.append(aux["losses"])
        aux = dict(sigma=torch.cat(sigs), losses=torch.cat(lss), unweighted=unweighted)
        return loss_sum, aux

    def sharded_grads_of(state, images, conditioning, seed, just_2d, sigma, noise):
        """grads_of under the mesh's SP context, then the sums over the
        ranks that hold each leaf and each loss term."""
        outer = sp_context()
        set_sp_context(mesh)
        try:
            loss, aux = grads_of(state, images, conditioning, seed, just_2d, sigma, noise)
        finally:
            set_sp_context(outer)
        all_reduce_grads(state.params, mesh, state.specs)
        totals = all_reduce_sum_(torch.stack([loss, aux["unweighted"]]).float(),
                                 mesh.grad_group)
        aux = dict(sigma=gather_batch(aux["sigma"], mesh),
                   losses=gather_batch(aux["losses"], mesh), unweighted=totals[1])
        return totals[0], aux

    def train_step(state: TrainState, images, conditioning, seed: int,
                   just_2d: bool = False, sigma=None, noise=None):
        with span("train.step", just_2d=just_2d):
            grads = grads_of if mesh is None else sharded_grads_of
            loss, aux = grads(state, images, conditioning, seed, just_2d, sigma, noise)
            params = state.params
            specs = None
            if state.specs is not None:
                name_of = {id(p): n for n, p in params.items()}
                specs = [state.specs[name_of[id(p)]]
                         for g in state.opt_state.param_groups for p in g["params"]]
            with span("train.optimizer"):
                grad_norm = tx.update(state.opt_state, state.step, specs, state.mesh)
            with span("train.weight_norm"):
                forced_weight_norm(params, state.specs, state.mesh)

            # power-function EMA
            step1 = state.step + 1
            cur_nimg = float(step1) * batch_size
            with span("train.ema"):
                for std, e in zip(state.ema_stds, state.ema):
                    gamma = float(std_to_exp(std))
                    beta = (1.0 - batch_size / cur_nimg) ** (gamma + 1.0)
                    ema_update(e, params, beta)
            state.step = step1
            metrics = dict(loss=loss, unweighted=aux["unweighted"], sigma=aux["sigma"],
                           losses=aux["losses"], grad_norm=grad_norm)
            return state, metrics

    return train_step


def step_seed(seed: int, step: int) -> int:
    """The seed of optimizer step `step` of a run seeded with `seed`."""
    return int(seed) * 1_000_003 + int(step)


def _stacked(rows, mean_unweighted: bool) -> dict:
    """Per-step metrics stacked as the JAX package's scans stack them."""
    loss = torch.stack([torch.as_tensor(m["loss"]) for m in rows])
    unw = torch.stack([torch.as_tensor(m["unweighted"]) for m in rows])
    return dict(loss=loss.mean(), loss_per_step=loss,
                unweighted=unw.mean() if mean_unweighted else unw,
                grad_norm=rows[-1]["grad_norm"],
                sigma=torch.cat([m["sigma"] for m in rows]),
                losses=torch.cat([m["losses"] for m in rows]))


def make_scanned_train_step(loss_cfg: EDM2LossConfig, tx: ClippedAdamW, batch_size: int,
                            microbatch: Optional[int] = None):
    """Returns scanned(state, images, conditioning, seed, just_2d=False,
    sigma=None, noise=None) -> (state, metrics): G = images.shape[0] train
    steps on images[j] (b, t, h, w, c) and conditioning[j], step j seeded
    with step_seed(seed, state.step) (sigma and noise, if given, are
    (G, b, ...)). Metrics: loss (mean), loss_per_step (G,), unweighted
    (mean), grad_norm (the last step's), sigma and losses (G * b, t)."""
    step = make_train_step(loss_cfg, tx, batch_size, microbatch)

    def scanned(state: TrainState, images, conditioning, seed: int, just_2d: bool = False,
                sigma=None, noise=None):
        rows = []
        for j in range(images.shape[0]):
            state, m = step(state, images[j], conditioning[j], step_seed(seed, state.step),
                            just_2d, None if sigma is None else sigma[j],
                            None if noise is None else noise[j])
            rows.append(m)
        return state, _stacked(rows, mean_unweighted=True)

    return scanned


def make_replay_train_step(loss_cfg: EDM2LossConfig, tx: ClippedAdamW, batch_size: int,
                           microbatch: Optional[int] = None):
    """Returns replay_step(state, buf_images, buf_cond, idx, seed,
    just_2d=False, sigma=None, noise=None) -> (state, metrics): idx.shape[0]
    train steps, step j on the batch buf_images[idx[j]], buf_cond[idx[j]],
    gathered on the rings' device (index_select), seeded as in
    make_scanned_train_step. idx (G, b) is the one thing that crosses to the
    device. Metrics as make_scanned_train_step's, but unweighted is (G,)."""
    step = make_train_step(loss_cfg, tx, batch_size, microbatch)

    def replay_step(state: TrainState, buf_images, buf_cond, idx, seed: int,
                    just_2d: bool = False, sigma=None, noise=None):
        idx = torch.as_tensor(idx).to(device=buf_images.device, dtype=torch.long)
        rows = []
        for j in range(idx.shape[0]):
            images = buf_images.index_select(0, idx[j])
            cond = buf_cond.index_select(0, idx[j]).long()
            state, m = step(state, images, cond, step_seed(seed, state.step), just_2d,
                            None if sigma is None else sigma[j],
                            None if noise is None else noise[j])
            rows.append(m)
        return state, _stacked(rows, mean_unweighted=False)

    return replay_step
