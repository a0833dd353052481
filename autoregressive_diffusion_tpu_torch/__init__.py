"""autoregressive_diffusion_tpu_torch: the PyTorch/CUDA port of
autoregressive_diffusion_tpu for NVIDIA Hopper (H100).

The subpackages mirror the JAX package (`ops/`, `models/`, `sampling/`,
`train/`, `utils/`) so that every module's counterpart is easy to find. Public
functions keep the JAX package's channels-last layouts: videos are
(B, T, H, W, C), conv weights HWIO / DHWIO, dense weights (in, out).

The hot spots of the autoregressive rollout and of the DART training step
run hand-written CUDA kernels for sm_90a (`csrc/`, built at first use by
`ops/_build.py`):
  * ops/flash_attention.py -- frame-masked prefill attention over the ring
    KV cache (fresh and warm prefill);
  * ops/fused_conv.py      -- the fused attention-free decode Block, and the
    train-mode fused gated causal conv, forward and backward, under a
    torch.autograd.Function.
Entry points: `python -m autoregressive_diffusion_tpu_torch.generate` (the
rollout) and `python -m autoregressive_diffusion_tpu_torch.train` (training
steps on synthetic latents).
Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. Entry points default to device="cuda" and raise
when no card is present; the CPU is used only when asked for.

This package never imports JAX or the JAX package.
"""
__version__ = "0.1.0"
