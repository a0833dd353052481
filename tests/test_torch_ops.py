"""The PyTorch port's L0 ops and the prefill-attention kernel's plain
version, held against the JAX package on the CPU.

Inputs come from seeded numpy and go through both implementations; fp32
results are compared at the repo's bound, std-of-diff <= 3e-4
(tests/test_reference_parity.py), or tighter where the op is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import attention as jattn
from autoregressive_diffusion_tpu.ops import attention as jatt
from autoregressive_diffusion_tpu.ops import flash_attention as jfa
from autoregressive_diffusion_tpu.ops import masks as jmasks
from autoregressive_diffusion_tpu.ops import numerics as jnx
from autoregressive_diffusion_tpu.ops import rope as jrope
from autoregressive_diffusion_tpu_torch.models import attention as tattn
from autoregressive_diffusion_tpu_torch.ops import flash_attention as tfa
from autoregressive_diffusion_tpu_torch.ops import masks as tmasks
from autoregressive_diffusion_tpu_torch.ops import numerics as tnx
from autoregressive_diffusion_tpu_torch.ops import rope as trope

TOL = 3e-4


def sdiff(a, b):
    return float(np.std(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def maxdiff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# --------------------------------------------------------------------------
# numerics

@pytest.mark.parametrize("axis", [None, -1, (0, 1, 2)])
def test_normalize(rng, axis):
    x = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
    x[0, 0] = 0.0  # an exactly-zero vector is legal
    jx, tx = both(x)
    assert maxdiff(jnx.normalize(jx, axis=axis), tnx.normalize(tx, dim=axis)) < 1e-6


def test_mp_silu_sum_cat(rng):
    a = rng.normal(size=(2, 3, 4, 4, 8)).astype(np.float32)
    b = rng.normal(size=(2, 3, 4, 4, 8)).astype(np.float32)
    g = rng.uniform(size=(2,)).astype(np.float32)
    (ja, ta), (jb, tb), (jg, tg) = both(a), both(b), both(g)
    assert maxdiff(jnx.mp_silu(ja), tnx.mp_silu(ta)) < 1e-6
    assert maxdiff(jnx.mp_sum(ja, jb, 0.3), tnx.mp_sum(ta, tb, 0.3)) < 1e-6
    assert maxdiff(jnx.mp_sum(ja, jb, jg), tnx.mp_sum(ta, tb, tg)) < 1e-6
    c = rng.normal(size=(2, 3, 4, 4, 5)).astype(np.float32)
    jc, tc = both(c)
    assert maxdiff(jnx.mp_cat(ja, jc, t=0.5), tnx.mp_cat(ta, tc, t=0.5)) < 1e-6


def test_mp_fourier_and_weight(rng):
    x = rng.normal(size=(2, 5)).astype(np.float32)
    f = (2 * np.pi * rng.normal(size=(16,))).astype(np.float32)
    p = (2 * np.pi * rng.uniform(size=(16,))).astype(np.float32)
    got = tnx.mp_fourier(*(torch.from_numpy(v) for v in (x, f, p)))
    want = jnx.mp_fourier(*(jnp.asarray(v) for v in (x, f, p)))
    assert maxdiff(want, got) < 1e-4  # cos of arguments up to ~100 rad
    w = rng.normal(size=(2, 3, 3, 6, 7)).astype(np.float32)
    jw, tw = both(w)
    assert maxdiff(jnx.mp_weight(jw, 0.7), tnx.mp_weight(tw, 0.7)) < 1e-6


@pytest.mark.parametrize("mode", ["keep", "down", "up"])
def test_resample(rng, mode):
    x = rng.normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    jx, tx = both(x)
    want = jnx.resample(jx, mode=mode)
    got = tnx.resample(tx, mode=mode)
    assert tuple(got.shape) == want.shape
    assert maxdiff(want, got) < 1e-6


# --------------------------------------------------------------------------
# rope

def test_rope_tables_and_qk(rng):
    d = 16
    pos = np.array([-3, 0, 1, 5, 7], np.int32)
    for center in (0, 3, 100):
        want = jrope.rope_tables(d, jnp.asarray(pos), center)
        got = trope.rope_tables(d, torch.from_numpy(pos), center)
        for w_, g_ in zip(want, got):
            assert maxdiff(w_, g_) < 1e-5 * max(1.0, float(np.abs(w_).max()))
    q = rng.normal(size=(1, 2, 3, 4, d)).astype(np.float32)
    k = rng.normal(size=(1, 2, 5, 4, d)).astype(np.float32)
    qp, kp = np.array([4, 5, 6]), np.array([0, 1, 2, 3, 4])
    jq, jk = jrope.rope_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(qp),
                           jnp.asarray(kp), center=3)
    tq, tk = trope.rope_qk(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(qp), torch.from_numpy(kp), center=3)
    assert maxdiff(jq, tq) < 1e-5 and maxdiff(jk, tk) < 1e-5


# --------------------------------------------------------------------------
# masks and dense attention

@pytest.mark.parametrize("t_new,f_total,offset", [(4, 4, 0), (2, 8, 3), (4, 8, 5), (3, 8, 13)])
def test_prefill_frame_mask_matches_jax_mask(t_new, f_total, offset):
    hw = 4
    m = jfa.PrefillMask(t_new, f_total, offset, hw)
    iq, ik = np.arange(t_new * hw), np.arange(f_total * hw)
    want = m.mask_function(iq[:, None], ik[None, :])
    got = tmasks.expand_to_tokens(tmasks.prefill_frame_mask(t_new, f_total, offset), hw)
    np.testing.assert_array_equal(got, want)
    if offset == 0 and f_total == t_new:  # the fresh causal prefill
        np.testing.assert_array_equal(tmasks.prefill_frame_mask(t_new, t_new, 0),
                                      jmasks.causal_frame_mask(t_new))


def test_dense_attention(rng):
    """The port's unmasked attention (the flash kernels' plain version, over
    any leading batch dims) against the JAX package's dense attention."""
    q, k, v = (rng.normal(size=(2, 3, 12, 16)).astype(np.float32) for _ in range(3))
    want = jatt.dense_attention(*(jnp.asarray(a) for a in (q, k, v)))
    qs = torch.from_numpy(q) / 4.0  # pre-scaled by 1/sqrt(16)
    got, _ = tfa.flash_attention_fwd_plain(qs, *(torch.from_numpy(a) for a in (k, v)),
                                           "full", 1, 12)
    assert maxdiff(want, got) < 1e-5


# --------------------------------------------------------------------------
# the prefill kernel's plain version vs the JAX splash kernels (interpret)

HW, D, H = 64, 64, 2


def _qkv(rng, t_new, f_total):
    q = rng.normal(size=(1, H, t_new * HW, D)).astype(np.float32)
    k = rng.normal(size=(1, H, f_total * HW, D)).astype(np.float32)
    v = rng.normal(size=(1, H, f_total * HW, D)).astype(np.float32)
    return q, k, v


def test_causal_prefill_plain_matches_splash(rng):
    t = 4
    q, k, v = _qkv(rng, t, t)
    want = jfa.causal_frame_attention(*(jnp.asarray(a) for a in (q, k, v)), t, HW,
                                      interpret=True)
    got = tfa.causal_frame_attention(*(torch.from_numpy(a) for a in (q, k, v)), t, HW)
    assert maxdiff(want, got) < 1e-5


@pytest.mark.parametrize("t_new,f_total,offset", [(2, 8, 3), (4, 8, 5)])
def test_ring_prefill_plain_matches_splash(rng, t_new, f_total, offset):
    """Warm prefill at a static offset, (4, 8, 5) after the ring wrapped."""
    q, k, v = _qkv(rng, t_new, f_total)
    want = jfa.prefill_cache_attention(*(jnp.asarray(a) for a in (q, k, v)), t_new,
                                       f_total, offset, HW, interpret=True)
    before = tfa.launches
    got = tfa.prefill_cache_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                      t_new, f_total, offset, HW)
    assert maxdiff(want, got) < 1e-5
    assert tfa.launches == before  # CPU tensors never reach the kernel


# --------------------------------------------------------------------------
# ring cache helpers

@pytest.mark.parametrize("frames", [0, 3, 8, 13])
def test_ring_slot_positions(frames):
    want = jattn.ring_slot_positions(jnp.int32(frames), 8)
    got = tattn.ring_slot_positions(frames, 8)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("t,frames", [(1, 5), (3, 6), (10, 2)])
def test_ring_write_and_decode_tables(rng, t, frames):
    buf = rng.normal(size=(1, 2, 8, 4, 16)).astype(np.float32)
    new = rng.normal(size=(1, 2, t, 4, 16)).astype(np.float32)
    want = jattn.ring_write(jnp.asarray(buf), jnp.asarray(new), frames)
    got = tattn.ring_write(torch.from_numpy(buf), torch.from_numpy(new), frames)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    jt = jattn.decode_tables(want, want, frames + t, jnp.float32)
    tt = tattn.decode_tables(got, got, frames + t, torch.float32)
    for key in ("kr", "vr"):
        assert maxdiff(jt[key], tt[key]) < 1e-5
    np.testing.assert_array_equal(np.asarray(jt["bias"]), tt["bias"].numpy())
