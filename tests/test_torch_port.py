"""Boundaries of the PyTorch port: it imports no JAX and nothing of the
JAX package, its entry points default to the card and refuse to fall back
to the CPU silently, and its launch counters only move on the card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "autoregressive_diffusion_tpu_torch"


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import autoregressive_diffusion_tpu_torch as p\n"
            "import autoregressive_diffusion_tpu_torch.generate\n"
            "import autoregressive_diffusion_tpu_torch.decode_video\n"
            "import autoregressive_diffusion_tpu_torch.models.vae\n"
            "import autoregressive_diffusion_tpu_torch.train.quantize\n"
            "import autoregressive_diffusion_tpu_torch.utils.checkpoint\n"
            "import autoregressive_diffusion_tpu_torch.models\n"
            "import autoregressive_diffusion_tpu_torch.sampling\n"
            "import autoregressive_diffusion_tpu_torch.ops.flash_attention\n"
            "import autoregressive_diffusion_tpu_torch.ops.fused_conv\n"
            "import autoregressive_diffusion_tpu_torch.train\n"
            "import autoregressive_diffusion_tpu_torch.train.cli\n"
            "import autoregressive_diffusion_tpu_torch.train.__main__\n"
            "import autoregressive_diffusion_tpu_torch.train.loss\n"
            "import autoregressive_diffusion_tpu_torch.train.loss_weight\n"
            "import autoregressive_diffusion_tpu_torch.train.ema\n"
            "import autoregressive_diffusion_tpu_torch.train.optim\n"
            "import autoregressive_diffusion_tpu_torch.train.train_state\n"
            "import autoregressive_diffusion_tpu_torch.utils.bridge\n"
            "import autoregressive_diffusion_tpu_torch.utils.profiling\n"
            "import autoregressive_diffusion_tpu_torch.parallel\n"
            "import autoregressive_diffusion_tpu_torch.parallel.collectives\n"
            "import autoregressive_diffusion_tpu_torch.parallel.launch\n"
            "import autoregressive_diffusion_tpu_torch.parallel.mesh\n"
            "import autoregressive_diffusion_tpu_torch.data\n"
            "import autoregressive_diffusion_tpu_torch.data.native\n"
            "import autoregressive_diffusion_tpu_torch.data.gym_data\n"
            "import autoregressive_diffusion_tpu_torch.data.replay\n"
            "import autoregressive_diffusion_tpu_torch.gym_train\n"
            "import autoregressive_diffusion_tpu_torch.export_ema\n"
            "import autoregressive_diffusion_tpu_torch.data.mds\n"
            "import autoregressive_diffusion_tpu_torch.data.cs_data\n"
            "import autoregressive_diffusion_tpu_torch.build_cs_dataset\n"
            "import autoregressive_diffusion_tpu_torch.compute_latent_stats\n"
            "import autoregressive_diffusion_tpu_torch.cs_train\n"
            "import autoregressive_diffusion_tpu_torch.cs_rollout\n"
            "import autoregressive_diffusion_tpu_torch.context_probe\n"
            "import autoregressive_diffusion_tpu_torch.cs_eval_suite\n"
            "import autoregressive_diffusion_tpu_torch.models.discriminator\n"
            "import autoregressive_diffusion_tpu_torch.models.stability\n"
            "import autoregressive_diffusion_tpu_torch.train.perceptual\n"
            "import autoregressive_diffusion_tpu_torch.gym_vae_train\n"
            "import autoregressive_diffusion_tpu_torch.cs_vae_train\n"
            "import autoregressive_diffusion_tpu_torch.cs_vae_adversarial\n"
            "import autoregressive_diffusion_tpu_torch.calibrate_lpips\n"
            "import autoregressive_diffusion_tpu_torch.rollout_drift\n"
            "import autoregressive_diffusion_tpu_torch.drift_sweep\n"
            "import autoregressive_diffusion_tpu_torch.utils.import_2d\n"
            "import autoregressive_diffusion_tpu_torch.utils.misc\n"
            "import autoregressive_diffusion_tpu_torch.utils.stats\n"
            "import autoregressive_diffusion_tpu_torch.utils.plotting\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'flax' or m.startswith('flax.') or m == 'optax'\n"
            "       or m == 'orbax' or m.startswith('orbax.')\n"
            "       or m == 'msgpack' or m.startswith('msgpack.')\n"
            "       or m.startswith('autoregressive_diffusion_tpu.')\n"
            "       or m == 'autoregressive_diffusion_tpu']\n"
            "print(','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_module_names_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "flax", "optax", "orbax", "msgpack",
                                    "autoregressive_diffusion_tpu"), (path, n)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    from autoregressive_diffusion_tpu_torch.generate import build_model
    from autoregressive_diffusion_tpu_torch.models import init_cache
    from autoregressive_diffusion_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_model(img_resolution=16, model_channels=8, channel_mult=(1,), num_blocks=1)
    model = build_model("cpu", torch.float32, img_resolution=16, model_channels=8,
                        channel_mult=(1,), num_blocks=1)
    with pytest.raises(RuntimeError):
        init_cache(model, 1)
    assert resolve_device("cpu").type == "cpu"


def test_cpu_tensors_take_the_plain_versions():
    from autoregressive_diffusion_tpu_torch.generate import build_model, rollout
    from autoregressive_diffusion_tpu_torch.ops import fused_conv, flash_attention

    model = build_model("cpu", torch.float32, img_resolution=16, img_channels=4,
                        model_channels=16, channel_mult=(1, 2), num_blocks=1,
                        max_frames=8, channels_per_head=16)
    def counts():
        return (flash_attention.launches, flash_attention.full_fwd_launches,
                fused_conv.launches)

    before = counts()
    out = rollout(model, context_frames=2, gen_frames=1, num_steps=2,
                  reprime_frames=1, bench_iters=1)
    assert bool(torch.isfinite(out["frames"]).all())
    assert out["cache"]["frames"] == 4
    assert counts() == before


def test_every_port_module_is_on_the_isolation_list():
    """The subprocess test above imports the train and parallel packages
    and the entry point by name; the AST test walks every file. A new module
    is covered by the walk at once, and this test keeps the walk honest
    about train/ and parallel/."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("train/__init__.py", "train/__main__.py", "train/cli.py", "train/loss.py",
                 "train/loss_weight.py", "train/ema.py", "train/optim.py",
                 "train/train_state.py", "train/quantize.py", "utils/profiling.py",
                 "utils/checkpoint.py", "utils/bridge.py", "models/vae.py",
                 "decode_video.py", "parallel/__init__.py",
                 "parallel/collectives.py", "parallel/launch.py", "parallel/mesh.py",
                 "data/__init__.py", "data/native.py", "data/gym_data.py", "data/replay.py",
                 "gym_train.py", "export_ema.py", "data/mds.py", "data/cs_data.py",
                 "build_cs_dataset.py", "compute_latent_stats.py", "cs_train.py",
                 "cs_rollout.py", "context_probe.py", "cs_eval_suite.py",
                 "rollout_drift.py", "drift_sweep.py", "utils/import_2d.py", "utils/misc.py",
                 "utils/stats.py", "utils/plotting.py"):
        assert want in names, want


def test_train_entry_point_defaults_to_the_card(monkeypatch, capsys):
    from autoregressive_diffusion_tpu_torch.ops import flash_attention, fused_conv
    from autoregressive_diffusion_tpu_torch.train import cli

    def counts():
        return (fused_conv.conv_fwd_launches, fused_conv.conv_bwd_launches,
                flash_attention.dart_fwd_launches, flash_attention.dart_bwd_launches,
                flash_attention.full_fwd_launches, flash_attention.full_bwd_launches,
                flash_attention.dart_sp_fwd_launches, flash_attention.dart_sp_bwd_launches)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", "tiny", "--steps", "1"])
    before = counts()
    cli.main(["--device", "cpu", "--config", "tiny", "--steps", "4", "--batch", "2",
              "--frames", "3", "--dtype", "fp32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [("just_2d" in ln) for ln in lines[:4]] == [False, False, False, True]
    summary = __import__("json").loads(lines[-1])
    assert summary["device"] == "cpu" and summary["finite"] and summary["steps"] == 4
    # on CPU tensors the wrappers ran their plain versions: no launch was counted
    assert counts() == before


def test_train_mode_refuses_dropout():
    """Dropout draws its masks from an explicit generator: train mode
    refuses dropout without one, runs with one, and eval ignores dropout."""
    from autoregressive_diffusion_tpu_torch.generate import build_model

    model = build_model("cpu", torch.float32, img_resolution=16, img_channels=4,
                        model_channels=16, channel_mult=(1,), num_blocks=1, dropout=0.1)
    x = torch.zeros((1, 2, 16, 16, 4))
    args = (x, torch.ones((1, 2)), torch.zeros((1, 2), dtype=torch.long))
    with pytest.raises(ValueError, match="dropout"):
        model(*args, mode="train")
    y, _ = model(*args, mode="train", dropout_generator=torch.Generator().manual_seed(0))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    with torch.no_grad():
        assert model(*args)[0].shape == x.shape


@pytest.mark.parametrize("knob", ["remat", "decode_quant"])
def test_train_mode_refuses_remat_and_int8(knob):
    """int8 weights are eval-only: train mode raises on decode_quant. remat
    (per-Block rematerialization) is ported: train mode runs it and gives
    the output of the same weights without it. Eval runs either."""
    from autoregressive_diffusion_tpu_torch.generate import build_model

    kw = dict(img_resolution=16, img_channels=4, model_channels=16, channel_mult=(1,),
              num_blocks=1)
    model = build_model("cpu", torch.float32, **kw, **{knob: True})
    x = torch.zeros((1, 2, 16, 16, 4))
    if knob == "remat":
        plain = build_model("cpu", torch.float32, **kw)
        args = (x, torch.ones((1, 2)), torch.zeros((1, 2), dtype=torch.long))
        assert torch.equal(model(*args, mode="train")[0], plain(*args, mode="train")[0])
    else:
        with pytest.raises(ValueError, match=knob):
            model(x, torch.ones((1, 2)), torch.zeros((1, 2), dtype=torch.long), mode="train")
    with torch.no_grad():
        y, _ = model(x, torch.ones((1, 2)), torch.zeros((1, 2), dtype=torch.long))
    assert y.shape == x.shape


def test_parallel_run_needs_a_launcher(monkeypatch):
    """--dp/--sp outside torchrun raises instead of running one rank alone."""
    from autoregressive_diffusion_tpu_torch.train import cli

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.main(["--device", "cpu", "--config", "tiny", "--sp", "2", "--backend", "gloo"])
