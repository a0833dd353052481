"""The port's train-state checkpoints and EMA export on the CPU, tiny
configs: save and restore bit for bit, resume equal to the straight run,
rotation and background writes; a JAX TrainState (as numpy) carried in by
the bridge, saved and restored, against JAX's leaves, and the AdamW step
that follows against optax's; the `unet_{n}M.ad` the trainer writes read by
the JAX package, whose model on it equals the port's (std-of-diff <= 3e-4,
the repo's parity bound); and the bf16 EMA bundle byte-identical to the JAX
package's save_model of the same EMA tree."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoregressive_diffusion_tpu import train as j_train
from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.utils.checkpoint import load_model as j_load_model
from autoregressive_diffusion_tpu.utils.checkpoint import save_model as j_save_model
from autoregressive_diffusion_tpu_torch import export_ema, gym_train
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_weights
from autoregressive_diffusion_tpu_torch.train import (EDM2LossConfig, create_train_state,
                                                      make_optimizer, make_train_step,
                                                      step_seed)
from autoregressive_diffusion_tpu_torch.utils import (latest_step, load_jax_train_state,
                                                      load_model, restore_train_state,
                                                      save_train_state, train_state_tree,
                                                      wait_for_pending_saves)

CFG = dict(img_resolution=16, img_channels=4, label_dim=4, model_channels=16,
           channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(8,),
           frame_attn_resolutions=(16,), max_frames=8, channels_per_head=16)
LOSS = EDM2LossConfig(P_mean=1.2, P_std=1.0, context_noise_reduction=0.5)
B, T = 2, 3


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, and torch's default of one thread a core then oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def schedule(s):
    return j_train.learning_rate_schedule(s, 1e-2, 0.5, 0.5)


def fresh_state(seed=3):
    from autoregressive_diffusion_tpu_torch.train import learning_rate_schedule
    model = init_weights(Precond(UNetConfig(**CFG), sigma_data=1.0), seed, gains=0.7).train()
    tx = make_optimizer(lambda s: learning_rate_schedule(s, 1e-2, 0.5, 0.5))
    return create_train_state(model, tx), tx


def run_steps(state, tx, first, last):
    step = make_train_step(LOSS, tx, B)
    for i in range(first, last):
        rng = np.random.default_rng(100 + i)
        images = torch.from_numpy(rng.normal(size=(B, T, 16, 16, 4)).astype(np.float32))
        cond = torch.from_numpy(rng.integers(0, 4, size=(B, T)))
        state, _ = step(state, images, cond, step_seed(7, i), just_2d=i % 4 == 0)
    return state


def assert_trees_equal(a, b, prefix=""):
    assert set(a) == set(b), prefix
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=prefix + k)


def test_save_then_restore_is_bit_for_bit(tmp_path):
    state, tx = fresh_state()
    state = run_steps(state, tx, 0, 2)
    state.coefs.copy_(torch.linspace(-0.3, 0.3, 7).reshape(7, 1))
    want = train_state_tree(state)
    assert int(want["opt_state"]["count"]) == 2 and want["step"] == 2
    save_train_state(tmp_path, 2, state, {"losses": [0.5, 0.25, 0.125]})
    other, _ = fresh_state(seed=9)
    other, extra = restore_train_state(tmp_path, 2, other)
    assert other.step == 2
    assert_trees_equal(train_state_tree(other), want)
    np.testing.assert_array_equal(extra["losses"], [0.5, 0.25, 0.125])
    assert extra["losses"].tolist() == [0.5, 0.25, 0.125]


def test_resume_equals_the_straight_run_bit_for_bit(tmp_path):
    straight, tx = fresh_state()
    straight = run_steps(straight, tx, 0, 5)
    first, tx1 = fresh_state()
    first = run_steps(first, tx1, 0, 3)
    save_train_state(tmp_path, first.step, first)
    resumed, tx2 = fresh_state(seed=11)  # other weights: everything must come from the file
    resumed, _ = restore_train_state(tmp_path, latest_step(tmp_path), resumed)
    resumed = run_steps(resumed, tx2, resumed.step, 5)
    assert_trees_equal(train_state_tree(resumed), train_state_tree(straight))


def test_rotation_background_writes_and_latest_step(tmp_path):
    assert latest_step(tmp_path / "none") is None
    state, tx = fresh_state()
    for s in (1, 2, 3, 4):
        state.step = s
        save_train_state(tmp_path, s, state, keep=2, block=False)
        if s == 3:  # the snapshot is taken before the write: a later in-place step
            want = train_state_tree(state)  # does not reach the file
            state = run_steps(state, tx, 3, 4)
            state.step = 3
    assert latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000003", "step_000000004"]
    other, _ = fresh_state()
    restore_train_state(tmp_path, 3, other)
    assert_trees_equal(train_state_tree(other), want)
    (tmp_path / "file").write_text("not a directory")
    save_train_state(tmp_path / "file", 5, state, block=False)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        wait_for_pending_saves()
    wait_for_pending_saves()  # the error is reported once


def _adam_state(opt_state):
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for n in node:
                walk(n)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


def test_jax_train_state_round_trips_through_the_port(tmp_path):
    """A JAX TrainState with moments, EMA, coefs and count 3, as numpy,
    bridged into the port, saved and restored into a fresh state: every
    leaf equals JAX's. Then the same clipped gradient through optax's
    update and the port's: the bias correction goes on from count 3."""
    jm = JPrecond(JConfig(**CFG), sigma_data=1.0)
    v = jax.jit(jm.init, static_argnames=("mode",))(
        jax.random.PRNGKey(4), jnp.zeros((1, 1, 16, 16, 4)), jnp.ones((1, 1)),
        jnp.zeros((1, 1), jnp.int32), mode="eval")
    tx_j = j_train.make_optimizer(learning_rate=schedule, grad_clip=0.1)
    state_j = j_train.create_train_state(jm, v, tx_j)
    rng = np.random.default_rng(0)
    rand = lambda tree, f=lambda x: x: jax.tree.map(
        lambda a: f(rng.normal(size=a.shape)).astype(np.float32), tree)
    adam = _adam_state(state_j.opt_state)
    new_adam = adam._replace(count=jnp.int32(3), mu=rand(adam.mu), nu=rand(adam.nu, np.abs))

    def swap(node):  # optax chains are plain tuples of states
        if node is adam:
            return new_adam
        if "count" in getattr(node, "_fields", ()):  # the schedule's count moves with Adam's
            return node._replace(count=jnp.int32(3))
        if type(node) is tuple:
            return tuple(swap(n) for n in node)
        return node

    opt_state = swap(state_j.opt_state)
    state_j = state_j.replace(step=jnp.int32(3), ema=(rand(state_j.params),
                                                      rand(state_j.params)),
                              coefs=jnp.asarray(rng.normal(size=(7, 1)), jnp.float32),
                              opt_state=opt_state)
    np_j = jax.tree.map(np.asarray, state_j)
    adam_np = _adam_state(np_j.opt_state)

    state_t, tx_t = fresh_state()
    load_jax_train_state(state_t, np_j.params, np_j.buffers, list(np_j.ema), np_j.coefs,
                         int(np_j.step), opt_state=dict(mu=adam_np.mu, nu=adam_np.nu,
                                                        count=adam_np.count))
    save_train_state(tmp_path, 3, state_t)
    restored, _ = fresh_state(seed=8)
    restore_train_state(tmp_path, 3, restored)
    tree = train_state_tree(restored)
    assert_trees_equal(tree["params"], np_j.params)
    assert_trees_equal(tree["buffers"], np_j.buffers)
    assert_trees_equal(tree["ema"]["0"], np_j.ema[0])
    assert_trees_equal(tree["ema"]["1"], np_j.ema[1])
    assert_trees_equal(tree["opt_state"]["mu"], adam_np.mu)
    assert_trees_equal(tree["opt_state"]["nu"], adam_np.nu)
    assert int(tree["opt_state"]["count"]) == 3 and int(tree["step"]) == 3
    np.testing.assert_array_equal(tree["coefs"], np_j.coefs)

    grads = rand(state_j.params)
    update = jax.jit(lambda g, o, p: optax.apply_updates(p, tx_j.update(g, o, p)[0]))
    want = jax.tree.map(np.asarray, update(grads, state_j.opt_state, state_j.params))
    named = dict(restored.model.named_parameters())
    flat_g = {}

    def walk(t, prefix=""):
        for k, val in t.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{k}.")
            else:
                flat_g[prefix + k] = val

    walk(grads)
    for n, p in named.items():
        p.grad = torch.from_numpy(np.array(flat_g[n]))
    tx_t.update(restored.opt_state, restored.step)
    got = train_state_tree(restored)["params"]
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()), want,
                         jax.tree.map(np.asarray, np_j.params))
    assert max(jax.tree.leaves(moved)) > 1e-4  # the step moved the weights
    # the same fp32 update in another order of operations: a few ulps of the
    # update (lr 4.1e-3 here) apart
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6),
                 got, want)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny gym_train trainer (fp32 body) after two steps, its gains set
    non-zero so that the UNet body shows in the output, checkpointed."""
    d = tmp_path_factory.mktemp("gym")
    args = gym_train.parse_args(["--device", "cpu", "--config", "tiny", "--dtype", "fp32",
                                 "--synthetic", "--batch", "2", "--micro-batch", "1",
                                 "--state-size", "8", "--steps", "4",
                                 "--ckpt-dir", str(d / "ck"), "--out-dir", str(d / "img")])
    tr = gym_train.build_trainer(args)
    gen = gym_train.SyntheticVideoGenerator(8, 64, 4, 4, training_examples=4, seed=1)
    batches = gym_train.stream(tr, gen, num_workers=0)
    for i in range(2):
        lat, act = next(batches)
        tr.step(i, lat, act)
    with torch.no_grad():
        for n, p in tr.state.model.named_parameters():
            if n.endswith(("emb_gain", "out_gain")):
                p.fill_(0.6)
    tr.flush()
    tr.checkpoint(2, block=True)
    return tr


def test_the_trainers_bundle_is_read_by_jax_and_its_model_matches(trained):
    tr = trained
    path = tr.args.ckpt_dir + "/unet_0M.ad"
    kwargs, variables = j_load_model(path)
    assert kwargs == {k: list(v) if isinstance(v, tuple) else v
                      for k, v in tr.unet_cfg.__dict__.items()}
    jm = JPrecond(JConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in kwargs.items()}), sigma_data=1.0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 2, 16, 16, 8)).astype(np.float32)
    sigma = np.array([[0.5, 2.0]], np.float32)
    cond = np.array([[1, 3]], np.int32)
    want = jax.jit(lambda v_, x_, s_, c_: jm.apply(v_, x_, s_, c_, mode="eval")[0])(
        variables, x, sigma, cond)
    model = tr.state.model.eval()
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), torch.from_numpy(sigma),
                       torch.from_numpy(cond).long())
    model.train()
    skip = x / (sigma[:, :, None, None, None] ** 2 + 1)  # c_skip * x alone
    assert float(np.std(np.asarray(want) - skip)) > 1e-2  # the body shows in the output
    assert float(np.std(got.numpy() - np.asarray(want))) <= 3e-4


def test_bf16_ema_export_equals_jax_save_model_byte_for_byte(trained, tmp_path):
    tr = trained
    cfg_bundle = tr.args.ckpt_dir + "/unet_0M.ad"
    got = export_ema.main(["--ckpt-dir", tr.args.ckpt_dir, "--cfg", cfg_bundle, "--ema", "0",
                           "--dtype", "bfloat16", "--out", str(tmp_path), "--device", "cpu"])
    assert got.name == "unet_0M_ema0.050_step2_bfloat16.ad"
    kwargs, variables = j_load_model(cfg_bundle)
    ema = train_state_tree(tr.state)["ema"]["0"]
    want = tmp_path / "jax.ad"
    j_save_model(str(want), dict(kwargs),
                 {"params": jax.tree.map(lambda p: np.asarray(p).astype(jnp.bfloat16), ema),
                  "buffers": variables["buffers"]})
    assert got.read_bytes() == want.read_bytes()
    _, back = load_model(got)  # the port reads its bf16 leaves back as bits
    assert back["params"]["unet"]["out_gain"].bits.dtype == np.uint16

    fp32 = export_ema.main(["--ckpt-dir", tr.args.ckpt_dir, "--cfg", cfg_bundle, "--ema", "1",
                            "--out", str(tmp_path), "--device", "cpu"])
    assert fp32.name == "unet_0M_ema0.100_step2.ad"
    want32 = tmp_path / "jax32.ad"
    j_save_model(str(want32), dict(kwargs),
                 {"params": train_state_tree(tr.state)["ema"]["1"],
                  "buffers": variables["buffers"]})
    assert fp32.read_bytes() == want32.read_bytes()
