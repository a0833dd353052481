"""Sequence-parallel training of the port on the CPU.

(a) The plain versions of the sequence-parallel kernels, one shard at a
    time in one process: each shard's rows and the sum of the shards' dK,
    dV equal the one-rank plain attention.
(b) dart_attention_sp and causal_frame_attention_sp on two gloo ranks
    against the JAX package's splash kernels of the same names, in
    interpret mode on the conftest's virtual CPU devices, at the shapes and
    bounds of tests/test_flash_attention.py:138-186.
(c) The data x seq parallel training step (sp=2; dp=2 x sp=2) against the
    one-process step of the same seeds: the bounds of
    tests/test_sharding.py:216-220, and the ranks' parameters and EMA agree.
The ranks run in processes of parallel.run_local_ranks; their functions
are in tests/test_torch_sp_workers.py, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sp_workers as workers
from autoregressive_diffusion_tpu.ops import flash_attention as jfa
from autoregressive_diffusion_tpu.parallel import create_mesh as jax_mesh
from autoregressive_diffusion_tpu_torch.ops import flash_attention as tfa
from autoregressive_diffusion_tpu_torch.parallel import run_local_ranks
from autoregressive_diffusion_tpu_torch.train import build_trainer

RANK_TIMEOUT = 240.0  # seconds for a group of ranks, their start included


def maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------------------
# (a) one process, plain versions

@pytest.mark.parametrize("kind", ["dart", "causal"])
@pytest.mark.parametrize("sp", [2, 4])
def test_plain_shards_make_up_the_one_rank_attention(kind, sp):
    n_frames, hw, d = 8, 16, 16
    s = (2 if kind == "dart" else 1) * n_frames * hw
    rng = np.random.default_rng(sp)
    qs, k, v, do = (torch.from_numpy(rng.normal(size=(1, 2, s, d)).astype(np.float32))
                    for _ in range(4))
    qs = qs / d ** 0.5
    o, lse = tfa.flash_attention_fwd_plain(qs, k, v, kind, n_frames, hw)
    dq, dk, dv = tfa.flash_attention_bwd_plain(qs, k, v, o, lse, do, kind, n_frames, hw)
    if kind == "causal":  # the mask of the fresh-prefill kernel (row 5)
        want = tfa.prefill_attention_plain(qs, k, v, n_frames, n_frames, 0, hw)
        assert maxdiff(o, want) <= 1e-6
    rows = [torch.from_numpy(workers.clip_tokens(kind, n_frames, hw, sp, r)) for r in range(sp)]
    idx = torch.cat(rows)  # the gathered, rank-major order
    kg, vg = k[:, :, idx], v[:, :, idx]
    dk_sum, dv_sum = 0.0, 0.0
    for r, ri in enumerate(rows):
        q_r, do_r = qs[:, :, ri], do[:, :, ri]
        o_r, lse_r = tfa.flash_attention_sp_fwd_plain(q_r, kg, vg, kind, n_frames, hw, r)
        dq_r, dk_r, dv_r = tfa.flash_attention_sp_bwd_plain(q_r, kg, vg, o_r, lse_r, do_r, kind,
                                                            n_frames, hw, r)
        for got, want in ((o_r, o[:, :, ri]), (lse_r, lse[:, :, ri]), (dq_r, dq[:, :, ri])):
            assert maxdiff(got, want) <= 1e-6 * max(1.0, float(want.abs().max()))
        dk_sum, dv_sum = dk_sum + dk_r, dv_sum + dv_r
    for got, want in ((dk_sum, dk[:, :, idx]), (dv_sum, dv[:, :, idx])):
        assert maxdiff(got, want) <= 1e-6 * max(1.0, float(want.abs().max()))


def test_the_kernels_mask_is_the_sharded_rule():
    """The (Sq, Sk) token mask of rank r equals the rows of the one-rank
    mask, the keys permuted to the gathered order."""
    n_frames, hw, sp = 4, 3, 2
    for kind in ("dart", "causal"):
        s = (2 if kind == "dart" else 1) * n_frames * hw
        whole = tfa._token_mask_np(kind, n_frames, hw, s)
        rows = [workers.clip_tokens(kind, n_frames, hw, sp, r) for r in range(sp)]
        idx = np.concatenate(rows)
        for r in range(sp):
            got = tfa._token_mask_np(kind, n_frames, hw, s // sp, sp, r)
            np.testing.assert_array_equal(got, whole[rows[r]][:, idx])


# ---------------------------------------------------------------------------
# (b) against the JAX package's sequence-parallel splash kernels

def jax_out_and_grads(fn, q, k, v):
    def loss(q, k, v):
        o = fn(q, k, v)
        return jnp.sum(o ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


def test_sp_attention_matches_the_jax_sp_kernels():
    rng = np.random.default_rng(3)
    # tests/test_flash_attention.py:146-186: DART t=4, hw=16 on an sp=2 x
    # tp=2 mesh; frame-causal t=8, hw=16 on sp=2; d=32
    dart = [rng.normal(size=(2, 2, 128, 32)).astype(np.float32) for _ in range(3)]
    causal = [rng.normal(size=(1, 2, 128, 32)).astype(np.float32) for _ in range(3)]
    mesh = jax_mesh(tp=2, sp=2)
    want_dart = jax_out_and_grads(
        lambda q, k, v: jfa.dart_attention_sp(q, k, v, 4, 16, mesh, seq_axis="seq",
                                              head_axis="model", interpret=True), *dart)
    mesh1 = jax_mesh(tp=1, sp=2, devices=jax.devices()[:2])
    want_causal = jax_out_and_grads(
        lambda q, k, v: jfa.causal_frame_attention_sp(q, k, v, 8, 16, mesh1, seq_axis="seq",
                                                      interpret=True), *causal)
    cases = [("dart", 4, 16, *dart), ("causal", 8, 16, *causal)]
    per_rank = run_local_ranks(workers.attention, 2, (cases,), timeout=RANK_TIMEOUT)
    for c, (kind, n_frames, hw, *_), want in zip(range(2), cases, (want_dart, want_causal)):
        got = [np.empty_like(w) for w in want]
        for r, outs in enumerate(per_rank):
            idx = workers.clip_tokens(kind, n_frames, hw, 2, r)
            for g, part in zip(got, outs[c]):
                g[:, :, idx] = part
        assert maxdiff(want[0], got[0]) < 1e-5, kind
        for name, w, g in zip(("dq", "dk", "dv"), want[1:], got[1:]):
            assert maxdiff(w, g) < 1e-4, (kind, name)


# ---------------------------------------------------------------------------
# (c) the parallel training step against the one-process step

@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_parallel_step_matches_the_one_process_step(dp, sp):
    b, t, seed = 2, 4, 5
    state, step = build_trainer("cpu", torch.float32, seed=seed, batch=b, **workers.CONFIG)
    images, cond = workers.batch(b, t, seed + 1)
    want_losses, want_params = [], []
    for i, just_2d in enumerate((False, True)):
        state, m = step(state, images, cond, seed * 1000 + i, just_2d=just_2d)
        want_losses.append(float(m["loss"]))
        want_params.append({n: p.detach().numpy().copy()
                            for n, p in state.model.named_parameters()})
    ranks = run_local_ranks(workers.train_steps, dp * sp, (dp, sp, b, t, seed),
                            timeout=RANK_TIMEOUT)
    for r, got in enumerate(ranks):
        assert got["mismatches"] == [], r
        np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-4)
        for snap, want in zip(got["params"], want_params):
            assert max(maxdiff(snap[n], want[n]) for n in want) < 2e-4
        np.testing.assert_array_equal(got["sigma"], m["sigma"].numpy())


def test_sp_gate_needs_two_frames_a_rank():
    """Without a context, or with sp = 1, train-mode attention stays on the
    one-rank kernel; with sp > 1 a rank must hold at least 2 frames."""
    from types import SimpleNamespace
    assert tfa.sp_context() is None and not tfa.sp_flash_supported(1)
    try:
        tfa.set_sp_context(SimpleNamespace(sp=1))
        assert not tfa.sp_flash_supported(4)
        tfa.set_sp_context(SimpleNamespace(sp=2))
        assert tfa.sp_flash_supported(2)
        with pytest.raises(ValueError, match="2 frames"):
            tfa.sp_flash_supported(1)
    finally:
        tfa.set_sp_context(None)
