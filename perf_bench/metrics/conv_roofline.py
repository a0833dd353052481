"""conv_roofline: the train-mode fused conv kernels' share of their bound.

The summed frozen bounds (costs.train_conv_bound_s: forward and backward
of every fused-conv call of a microbatch, times the microbatches) of the
profiled steps, over the device time of the conv forward and backward
kernels.
"""
from perf_bench import costs
from perf_bench.metrics_common import traced

UNIT = "%"


def read(rec):
    tr = traced(rec, "train")
    if tr is None or not tr["steps"]:
        return None
    device_s = sum(s for n, s in tr["kernel_s"].items()
                   if costs.in_group(n, costs.CONV_FWD_KERNELS + costs.CONV_BWD_KERNELS))
    if device_s <= 0:
        return None
    t = rec["traffic"]
    micro = t["batch"] // t["micro_batch"]
    bound = sum(micro * costs.train_conv_bound_s(rec["cfg"], t["micro_batch"], t["frames"],
                                                 i % t["just_2d_every"] == 0, rec["body_dtype"])
                for i in range(tr["first_step"], tr["first_step"] + tr["steps"]))
    return 100.0 * bound / device_s
