"""The controls come out not correct: the program's own int8 serving path in
a rollout cell, the reference in float8 in place of the program in the
training cell. At a tiny size on the CPU; `perf_bench/control.py` reads
them on the card at the cells' own sizes (PERF.md gives those readings)."""
import math
import time

import pytest
from conftest import tiny_cell

from perf_bench import harness


def not_correct(checks):
    return any(not math.isfinite(v) or v > lim for _, v, lim in checks)


@pytest.mark.parametrize("cell", ["gym_rollout", "cs_rollout"])
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_rollout_int8_control_is_not_correct(cell, seed):
    c = tiny_cell(cell)
    c["config_spec"]["body_dtype"] = "bfloat16"  # the configuration's type; int8 below it
    drv = harness.load_module("drivers", c["driver"])
    rec = drv.run(c, seed, 1, False, "cpu", time.perf_counter(), control=True)
    assert not_correct(rec["checks"])


@pytest.mark.parametrize("seed", [101, 102, 103])
def test_train_fp8_control_is_not_correct(seed):
    c = tiny_cell("cs_train")
    drv = harness.load_module("drivers", "train")
    cfg, tr = c["config_spec"], c["traffic_spec"]
    ref = drv.reference_readings(cfg, tr, seed, "cpu", None)
    fp8 = drv.reference_readings(cfg, tr, seed, "cpu", "fp8")
    assert not_correct(drv.compare(cfg, fp8, ref))


def test_train_half_batch_fault_trains_on_half_in_one_microbatch():
    """Half of a batch held in one microbatch still trains: the fault reads
    a gradient, not none."""
    c = tiny_cell("cs_train")
    tr = c["traffic_spec"]
    tr["micro_batch"] = tr["batch"]
    drv = harness.load_module("drivers", "train")
    half = drv.reference_readings(c["config_spec"], tr, 101, "cpu", None, 0.5)
    assert sum(half["grad1"].values()) > 0


def test_weight_leaves_are_the_weights():
    """Of the trained leaves, every conv, dense and attention weight is
    compared leaf by leaf; the gains and gating parameters are not."""
    from perf_bench.reference import param_shapes
    cfg = harness.load_cell("cs_train")["config_spec"]
    drv = harness.load_module("drivers", "train")
    names = [n for n in param_shapes(cfg["model"]) if not n.endswith(("freqs", "phases"))]
    kept = drv.weight_leaves(cfg, names)
    assert set(kept) == {n for n in names if n.endswith(".w")}
