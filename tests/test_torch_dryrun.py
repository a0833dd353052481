"""The port's counterpart of __graft_entry__.py::dryrun_multichip
(parallel/dryrun.py) on 4 gloo ranks on the CPU: dp 2 x tp 2 with FSDP,
one sharded step and the fitted loss weight equal on every rank, a served
prefill and 2-frame rollout, and the FSDP save -> restore -> re-shard ->
step. 4 ranks, not the 8 of dp 2 x sp 2 x tp 2, to spare the other test
workers' cores (tests/test_torch_tp_fsdp.py holds sp 2 x tp 2); about 15 s;
each rank holds one torch thread."""
import contextlib
import io

from autoregressive_diffusion_tpu_torch.parallel import dryrun


def test_dryrun_passes_its_three_phases():
    assert dryrun.grid(8) == (2, 2, 2) and dryrun.grid(4) == (2, 1, 2)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert dryrun.main(["--ranks", "4", "--device", "cpu"]) == 0
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 3, lines
    assert "mesh dp=2 x sp=1 x tp=2" in lines[0] and "coefs replicated over 4 ranks OK" in lines[0]
    assert "2-frame rollout" in lines[1] and "cache at 4 frames" in lines[1]
    assert "save->restore->re-shard->step equality OK" in lines[2]
