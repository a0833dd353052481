"""mfu.train: the training step's share of the card's bf16 peak over the profiled steps.

Operations of each step from the frozen cost model (costs.train_step_cost:
the forward's products over the DART concat, or the frames of a just_2d
step, and twice each for the backward, no recompute), over the
sub-window's wall time and the bf16 peak. Elementwise work is not counted.
"""
from perf_bench import costs
from perf_bench.metrics_common import traced

UNIT = "%"


def read(rec):
    tr = traced(rec, "train")
    if tr is None or not tr["steps"]:
        return None
    t = rec["traffic"]
    flops = sum(costs.train_step_cost(rec["cfg"], t["batch"], t["frames"],
                                      i % t["just_2d_every"] == 0)
                for i in range(tr["first_step"], tr["first_step"] + tr["steps"]))
    return 100.0 * flops / tr["window_s"] / costs.PEAK_FLOPS["bfloat16"]
