"""Tensor parallelism, FSDP and the replica axis of the port on the CPU.

(1) The port's param_sharding against the JAX package's, leaf by leaf, at
    tp 2 on conftest's 8 host devices (data 4), FSDP on and off, under the
    test CFG of tests/test_sharding.py:21-25 and the CS config (its shapes
    from jax.eval_shape and a model on the meta device: no 310M init).
(2) Each rank's local shards of the parameters, both EMA copies and the
    AdamW moments, from shard_train_state, against the addressable shards
    of the JAX shard_train_state arrays, bit for bit, at the same grid.
(3) Two steps on 4 gloo ranks -- dp 2 x tp 2 with FSDP, sp 2 x tp 2, and 2
    replicas x tp 2 -- against the one-process step, sigma and noise
    injected as tests/test_torch_train_step.py does (the JAX step's own
    draws): loss rtol 2e-4 and parameters within 2e-4, the bounds of
    tests/test_sharding.py:63-73; and the losses against the JAX
    single-device step at test_torch_train_step.py's bound, 3e-4 x
    max(1, loss).
(4) On each grid: gather_to_host loaded into a fresh state and sharded
    again equals every rank's leaves bit for bit; check_replica_consistency
    is empty on the sharded state and names the leaf whose shard one rank
    perturbs.
(5) cs_train --tp 2 --fsdp --synthetic at 16 channels on 4 ranks for 2
    steps and a save, resumed in one process: every leaf bit for bit.
(6) Head-sharded attention under SP x TP: in the sp 2 x tp 2 grid every
    SP attention call (row 8) of every rank carries 1 of the model's 2
    heads (and the steps still equal one process, (3)); gather_model_partial
    (the qkv gather whose backward reduce-scatters) against its definition
    on the model group; and, without ranks, the port's gate
    (sp_head_shards) against the JAX package's (sp_flash_supported's
    head_axis) over grids and head counts, tp not dividing the heads among
    them.
The ranks run in processes of parallel.run_local_ranks; their functions are
in tests/test_torch_tp_fsdp_workers.py, which imports no JAX. On one worker
(-p no:xdist) the file takes about 90 s.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_tp_fsdp_workers as workers
from test_torch_train_step import jax_draws
from autoregressive_diffusion_tpu import train as j_train
from autoregressive_diffusion_tpu.models import Precond as JPrecond
from autoregressive_diffusion_tpu.models import UNetConfig as JConfig
from autoregressive_diffusion_tpu.ops import flash_attention as j_fa
from autoregressive_diffusion_tpu.parallel import create_mesh as jax_mesh
from autoregressive_diffusion_tpu.parallel import param_sharding as jax_param_sharding
from autoregressive_diffusion_tpu.parallel import shard_train_state as jax_shard_train_state
from autoregressive_diffusion_tpu_torch import cs_train
from autoregressive_diffusion_tpu_torch.models import Precond, UNetConfig, init_weights
from autoregressive_diffusion_tpu_torch.ops import flash_attention as fa
from autoregressive_diffusion_tpu_torch.parallel import (param_sharding, run_local_ranks,
                                                         shard_train_state)
from autoregressive_diffusion_tpu_torch.utils.bridge import (jax_variables, load_jax_train_state,
                                                             train_state_tree)

RANK_TIMEOUT = 300.0
SHARDING_CFG = dict(img_resolution=8, img_channels=4, label_dim=0, model_channels=16,
                    channel_mult=(1, 2), num_blocks=1, video_attn_resolutions=(4,),
                    frame_attn_resolutions=(8,), channels_per_head=16, max_frames=8)
CS_CFG = dataclasses.asdict(cs_train.cs_config())
GRIDS = {"dp2_tp2_fsdp": dict(dp=2, sp=1, tp=2, slices=1, fsdp=True),
         "sp2_tp2": dict(dp=1, sp=2, tp=2, slices=1, fsdp=False),
         "replica2_tp2": dict(dp=1, sp=1, tp=2, slices=2, fsdp=False)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Hold torch to 2 threads beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def jax_shapes(which: str):
    """The JAX Precond's parameter shapes (jax.eval_shape of its init)."""
    cfg = SHARDING_CFG if which == "test_cfg" else CS_CFG
    jm = JPrecond(JConfig(**cfg), sigma_data=1.0)
    res, ch = cfg["img_resolution"], cfg["img_channels"]
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, res, res, ch)), jnp.ones((1, 1)),
        jnp.zeros((1, 1), jnp.int32), mode="eval"))["params"]


def jax_specs(which: str, **rule) -> dict:
    """{"unet/...": spec tuple} of the JAX param_sharding at tp 2."""
    shapes = jax_shapes(which)
    tree = jax_param_sharding(jax_mesh(tp=2), shapes, **rule)

    def named(t):
        return {"/".join(str(k.key) for k in p): v
                for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}

    ndim = {n: len(s.shape) for n, s in named(shapes).items()}
    return {n: tuple(sh.spec) + (None,) * (ndim[n] - len(tuple(sh.spec)))
            for n, sh in named(tree).items()}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("which", ["test_cfg", "cs"])
def test_param_sharding_matches_jax(which, fsdp):
    cfg, rule = ((SHARDING_CFG, dict(min_shard_size=32, fsdp_min_size=256)) if which == "test_cfg"
                 else (CS_CFG, {}))
    want = jax_specs(which, fsdp=fsdp, **rule)
    with torch.device("meta"):
        model = Precond(UNetConfig(**cfg), sigma_data=1.0)
    got = param_sharding(SimpleNamespace(tp=2, dp=4), dict(model.named_parameters()),
                         fsdp=fsdp, **rule)
    got = {n.replace(".", "/"): s for n, s in got.items()}
    assert set(got) == set(want)
    assert {n for n in got if got[n] != want[n]} == set()
    assert any("model" in s for s in got.values())
    assert any("data" in s for s in got.values()) == fsdp


def adam_state(opt_state):
    """optax's ScaleByAdamState inside chain(clip, adamw)'s state."""
    found = []

    def walk(node):
        if hasattr(node, "mu"):
            found.append(node)
        elif isinstance(node, (tuple, list)):
            for n in node:
                walk(n)

    walk(opt_state)
    assert len(found) == 1
    return found[0]


@pytest.fixture(scope="module")
def reference():
    """The JAX single-device step and the port's one-process step, two
    steps each from the same start (the port's seeded init with emb_gain and
    out_gain 0.7, under the JAX names) with the same draws; the JAX state
    after step 1."""
    mp = pytest.MonkeyPatch()
    mp.setenv("AD_TPU_FUSED_CONV", "0")
    mp.setenv("AD_TPU_FLASH", "0")
    try:
        jm = JPrecond(JConfig(**workers.CFG), sigma_data=1.0)
        variables = jax_variables(init_weights(Precond(UNetConfig(**workers.CFG)), 0, 0.7))
        params = jax.tree.map(jnp.asarray, variables["params"])
        cfg_j = j_train.EDM2LossConfig(**workers.LOSS)
        tx_j = j_train.make_optimizer(learning_rate=workers.LR, eps=workers.EPS)
        state_j = j_train.create_train_state(
            jm, {"params": params, "buffers": jax.tree.map(jnp.asarray, variables["buffers"])},
            tx_j)
        coefs = (0.1 * np.random.default_rng(1).normal(size=(7, 1))).astype(np.float32)
        state_j = state_j.replace(coefs=jnp.asarray(coefs))
        step_j = jax.jit(j_train.make_train_step(jm, cfg_j, tx_j, batch_size=workers.B),
                         static_argnames=("just_2d",))
        start = (jax.tree.map(np.asarray, state_j.params),
                 jax.tree.map(np.asarray, state_j.buffers), coefs)
        state_t, step_t = workers.make_state(start)
        rng = np.random.default_rng(0)
        draws, jax_losses, losses, snaps, after1 = [], [], [], [], None
        for i in range(2):
            images = rng.normal(size=(workers.B, workers.T, 8, 8, 4)).astype(np.float32)
            cond = rng.integers(0, 4, size=(workers.B, workers.T)).astype(np.int32)
            key = jax.random.PRNGKey(100 + i)
            sigma, noise = jax_draws(key, cfg_j, images.shape)
            state_j, m_j = step_j(state_j, jnp.asarray(images), jnp.asarray(cond), key)
            jax_losses.append(float(m_j["loss"]))
            if i == 0:
                after1 = state_j
            d = (torch.from_numpy(images), torch.from_numpy(cond).long(),
                 torch.from_numpy(sigma.copy()), torch.from_numpy(noise.copy()))
            draws.append(d)
            state_t, m_t = step_t(state_t, d[0], d[1], 0, sigma=d[2], noise=d[3])
            losses.append(float(m_t["loss"]))
            snaps.append({n.replace(".", "/"): p.detach().numpy().copy()
                          for n, p in state_t.model.named_parameters()})
    finally:
        mp.undo()
    return dict(start=start, draws=draws, jax_losses=jax_losses, losses=losses, params=snaps,
                jax_after1=after1, coefs=coefs)


def test_local_shards_equal_jax_addressable_shards(reference):
    """dp 4 x tp 2 with FSDP at tests/test_sharding.py's sizes: rank (d, m)
    of the port holds the numbers of the JAX shard on device (d, m)."""
    state_j = reference["jax_after1"]
    mesh = jax_mesh(tp=2)
    sharded, _ = jax_shard_train_state(state_j, mesh, fsdp=True, **workers.SHARD)
    where = {dev: (d, m) for (_, d, _, m), dev in np.ndenumerate(mesh.devices)}
    adam_j = adam_state(sharded.opt_state)
    trees = {"params": sharded.params, "ema0": sharded.ema[0], "ema1": sharded.ema[1],
             "mu": adam_j.mu, "nu": adam_j.nu}
    host = jax.tree.map(np.asarray, state_j)
    adam_h = adam_state(host.opt_state)
    n_split = 0
    for (d, m) in sorted(where.values()):
        state, _ = workers.make_state(reference["start"])
        load_jax_train_state(state, host.params, host.buffers, list(host.ema), host.coefs,
                             int(host.step), dict(mu=adam_h.mu, nu=adam_h.nu,
                                                  count=adam_h.count))
        fake = SimpleNamespace(tp=2, dp=4, model_rank=m, data_rank=d)
        shard_train_state(state, fake, fsdp=True, **workers.SHARD)
        ours = {"params": dict(state.model.named_parameters()), "ema0": state.ema[0],
                "ema1": state.ema[1],
                "mu": {n: state.opt_state.state[p]["exp_avg"] for n, p in state.params.items()},
                "nu": {n: state.opt_state.state[p]["exp_avg_sq"]
                       for n, p in state.params.items()}}
        for kind, tree in trees.items():
            for path, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
                name = ".".join(str(k.key) for k in path)
                shard = next(s for s in arr.addressable_shards if where[s.device] == (d, m))
                got = ours[kind][name].detach().numpy()
                want = np.asarray(shard.data)
                assert got.shape == want.shape and np.array_equal(got, want), (kind, name, d, m)
                n_split += got.size < arr.size
    assert n_split > 0


@pytest.fixture(scope="module")
def grid_runs(reference):
    """{grid name: [each rank's result]}: one spawn of 4 ranks runs the
    three grids in turn."""
    ranks = run_local_ranks(workers.sharded_steps, 4,
                            (list(GRIDS.items()), reference["start"], reference["draws"]),
                            timeout=RANK_TIMEOUT)
    return {name: [r[name] for r in ranks] for name in GRIDS}


@pytest.mark.parametrize("name", list(GRIDS))
def test_sharded_steps_match_the_one_process_step(name, reference, grid_runs):
    ranks = grid_runs[name]
    want = reference["losses"]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], want, rtol=2e-4, err_msg=f"rank {r}")
        for lj, lt in zip(reference["jax_losses"], got["losses"]):
            assert abs(lt - lj) <= 3e-4 * max(1.0, abs(lj)), (r, lt, lj)
    for snap, ref in zip(ranks[0]["params"], reference["params"]):
        assert set(snap) == set(ref)
        assert max(float(np.abs(snap[n] - ref[n]).max()) for n in ref) < 2e-4
    assert ranks[0]["n_sharded"]["model"] > 0
    assert (ranks[0]["n_sharded"]["data"] > 0) == GRIDS[name]["fsdp"]
    # each rank holds less than the whole model when something is sharded
    total = sum(v.size for v in ranks[0]["params"][0].values())
    assert all(got["local_numel"] < total for got in ranks)


def test_sp_attention_runs_this_ranks_heads(grid_runs):
    """Row 8's calls under sp 2 x tp 2 carry num_heads / tp heads (q and the
    gathered k alike); without SP there are none. And in every grid's ranks,
    gather_model_partial against its definition: each rank weighs only its
    own column ranges of the gathered tensor, so its gradient is the sum
    over the model ranks; the plain gather_model's, this rank's part alone,
    is not."""
    for name, grid in GRIDS.items():
        for r, got in enumerate(grid_runs[name]):
            assert got["video_heads"] == [2], got["video_heads"]
            if grid["sp"] > 1:
                heads = 2 // grid["tp"]
                assert got["sp_calls"] == [("flash_attention_sp_bwd", heads, heads),
                                           ("flash_attention_sp_fwd", heads, heads)], (r, got)
                assert got["n_sp_calls"] > 0
            else:
                assert got["n_sp_calls"] == 0, (name, r, got["sp_calls"])
            check = got["partial_gather"]
            assert check["partial"]["forward"] and check["plain"]["forward"], (name, r)
            assert check["partial"]["grad_err"] < 1e-6, (name, r, check)
            assert check["plain"]["grad_err"] > 0.1, (name, r, check)


def test_head_shard_gate_matches_jax():
    """sp_head_shards(num_heads) > 1 exactly where the JAX package's
    sp_flash_supported keeps head_axis 'model' (an interpreted SP context
    on conftest's 8 host devices), and then equals tp; tp not dividing the
    heads keeps every head on every rank."""
    before_j, before_t = j_fa.sp_context(), fa.sp_context()
    try:
        for sp, tp, heads in [(2, 2, 2), (2, 2, 3), (2, 4, 8), (2, 4, 6), (1, 2, 2),
                              (2, 1, 2), (4, 2, 4)]:
            j_fa.set_sp_context(jax_mesh(tp=tp, sp=sp), interpret=True)
            ok, _, _, head_axis, _ = j_fa.sp_flash_supported(sp * 128, heads)
            fa.set_sp_context(SimpleNamespace(sp=sp, tp=tp))
            got = fa.sp_head_shards(heads)
            assert ok == (sp > 1), (sp, tp, heads)
            assert (got > 1) == (head_axis == "model"), (sp, tp, heads, got, head_axis)
            assert got == (tp if sp > 1 and tp > 1 and heads % tp == 0 else 1), (sp, tp, heads)
    finally:
        j_fa._SP_CTX = before_j
        fa.set_sp_context(before_t)


@pytest.mark.parametrize("name", list(GRIDS))
def test_gather_round_trip_and_replica_check(name, grid_runs):
    ranks = grid_runs[name]
    for r, got in enumerate(ranks):
        assert got["roundtrip"], r
        assert got["before"] == [], (r, got["before"][:3])
        assert [b for b in got["after"] if b.startswith(got["victim"] + ":")], (r, got["after"])
        assert all(b.startswith(got["victim"] + ":") for b in got["after"]), got["after"]


def test_cs_train_tp_fsdp_save_resumes_in_one_process(tmp_path):
    common = ["--device", "cpu", "--dtype", "fp32", "--model-channels", "16", "--batch", "2",
              "--micro-batch", "2", "--clip-size", "4", "--synthetic", "--ckpt-dir",
              str(tmp_path)]
    ranks = run_local_ranks(workers.cs_train_ranks, 4,
                            (common + ["--steps", "2", "--tp", "2", "--fsdp", "--backend", "gloo"],),
                            timeout=RANK_TIMEOUT)
    got = ranks[0]
    assert got["n_sharded"]["model"] > 0 and got["n_sharded"]["data"] > 0, got["n_sharded"]
    assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
    tr = cs_train.main(common + ["--steps", "2", "--resume"])
    assert tr.state.step == 2 and tr.losses == got["losses"]
    mine, theirs = workers.flat(train_state_tree(tr.state)), workers.flat(got["tree"])
    assert set(mine) == set(theirs)
    for name, want in theirs.items():
        assert mine[name].dtype == want.dtype and np.array_equal(mine[name], want), name

