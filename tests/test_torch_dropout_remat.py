"""Train-mode dropout and per-Block remat of the port's UNet on the CPU,
fp32, at the tiny reference config (batch 1, T=2, the DART concat of 4
frames):

  * dropout 0.1 against the JAX package's Precond (flax nn.Dropout, its
    unfused train path): flax's keep masks are captured with
    flax.linen.intercept_methods (each Dropout's output is nonzero where it
    keeps) and injected through UNet.dropout_mask, the port's hook; the
    output is held at std-of-diff <= 3e-4 and the gradients (the input's and
    every parameter's) at ||diff|| <= 3e-4 ||ref||;
  * remat against no remat in the port, dropout 0.1 from one generator
    seed: output and gradients equal exactly, the masks are drawn once a
    Block (not again when the Block is recomputed), and every Block's conv
    runs its forward twice (the recompute), the stem and out convs once;
  * remat against the JAX package's remat=True, at the same bounds as the
    first case.
Weights are the port's seeded init with nonzero gains, bridged to JAX."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_weights, layers
from autoregressive_diffusion_tpu_torch.utils import jax_variables, state_from_jax

CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)
TOL = 3e-4
B, F = 1, 4  # the DART concat of T=2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, and torch's default of one thread a core then oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, F, 16, 16, 4)).astype(np.float32)
    sig = np.exp(rng.normal(size=(B, F))).astype(np.float32)
    cond = rng.integers(0, 4, size=(B, F)).astype(np.int32)
    probe = np.sin(np.arange(x.size, dtype=np.float32) * 0.17).reshape(x.shape)
    return x, sig, cond, probe


def port_model(**kw):
    return init_weights(Precond(UNetConfig(**CFG, **kw), sigma_data=1.0), seed=3)


def jax_run(inputs, key=None, **kw):
    """(y, {input and parameter gradient by port name}, {Block: keep mask})
    of the JAX Precond in train mode on the port's seeded weights, in one
    jitted call; the masks are the Dropout outputs' nonzero pattern,
    captured while tracing and returned as outputs."""
    x, sig, cond, probe = inputs
    jm = JPrecond(JConfig(**CFG, **kw), sigma_data=1.0)
    v = jax_variables(port_model(**kw))
    rngs = {"dropout": key} if key is not None else {}

    def loss(params, xv):
        masks = {}

        def keep(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout):
                masks[context.module.path[-2]] = out != 0
            return out

        with nn.intercept_methods(keep):
            y, _ = jm.apply({"params": params, "buffers": v["buffers"]}, xv, sig, cond,
                            mode="train", rngs=rngs)
        return jnp.sum(y * probe), (y, masks)

    (gp, gx), (y, masks) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(
        v["params"], x)
    grads = state_from_jax({"params": gp})
    grads["x"] = torch.from_numpy(np.array(gx))
    return np.asarray(y), grads, {k: np.array(m) for k, m in masks.items()}


def port_run(model, inputs, generator=None):
    x, sig, cond, probe = (torch.from_numpy(a) for a in inputs)
    x = x.clone().requires_grad_(True)
    y, _ = model(x, sig, cond.long(), mode="train", dropout_generator=generator)
    (y * probe).sum().backward()
    # out_res is kept for parameter parity and reaches no output: no gradient
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}
    grads["x"] = x.grad.clone()
    return y.detach(), grads


def assert_close(y, grads, y_ref, grads_ref):
    assert float(np.std(y.numpy().astype(np.float64) - y_ref)) <= TOL
    assert set(grads) == set(grads_ref)
    for name, ref in grads_ref.items():
        ref = ref.numpy().astype(np.float64)
        d = np.linalg.norm(grads[name].numpy() - ref)
        assert d <= TOL * np.linalg.norm(ref) + 1e-9, (name, d, np.linalg.norm(ref))


def test_dropout_matches_flax_masks(inputs):
    y_ref, g_ref, masks = jax_run(inputs, jax.random.PRNGKey(7), dropout=0.1)
    model = port_model(dropout=0.1)
    blocks = [f"{side}_{name}" for side, name, spec in model.cfg.block_layout()
              if spec["kind"] == "block"]
    assert sorted(masks) == sorted(blocks)
    kept = np.mean([m.mean() for m in masks.values()])
    assert 0.85 < kept < 0.95
    model.unet.dropout_mask = lambda name, shape, device, generator: (
        torch.from_numpy(masks[name]).reshape(shape))
    y, grads = port_run(model, inputs, torch.Generator())
    assert_close(y, grads, y_ref, g_ref)


def counted_convs(monkeypatch):
    calls = []
    plain = layers.fused_gated_conv

    def counting(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(layers, "fused_gated_conv", counting)
    return calls


def test_remat_gradients_equal_plain(inputs, monkeypatch):
    runs = {}
    for remat in (False, True):
        model = port_model(dropout=0.1, remat=remat)
        draws = []
        draw = model.unet.dropout_mask

        def counted_draw(*args, draw=draw, draws=draws):
            draws.append(args[0])
            return draw(*args)

        model.unet.dropout_mask = counted_draw
        convs = counted_convs(monkeypatch)
        y, grads = port_run(model, inputs, torch.Generator().manual_seed(11))
        runs[remat] = (y, grads, list(draws), len(convs))
    (y0, g0, d0, n0), (y1, g1, d1, n1) = runs[False], runs[True]
    assert torch.equal(y0, y1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    n_blocks = sum(spec["kind"] == "block" for _, _, spec in model.cfg.block_layout())
    assert d0 == d1 and len(d1) == n_blocks  # one draw a Block, none in the recompute
    assert n0 == 2 * n_blocks + 2            # two convs a Block, the stem, the out conv
    assert n1 == n0 + 2 * n_blocks           # remat runs each Block's convs again


def test_remat_matches_jax_remat(inputs):
    y_ref, g_ref, _ = jax_run(inputs, remat=True)
    y, grads = port_run(port_model(remat=True), inputs)
    assert_close(y, grads, y_ref, g_ref)
