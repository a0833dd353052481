"""decode_block_roofline: the fused decode-Block kernel's share of its bound.

The summed frozen bounds (costs.block_bound_s: each cached call's
attention-free Blocks over all sessions, the weights read once a launch)
of the profiled calls, over the device time of the decode-Block kernels.
"""
from perf_bench import costs
from perf_bench.metrics_common import traced
from perf_bench.spec import decode_blocks

UNIT = "%"


def read(rec):
    tr = traced(rec, "rollout")
    if tr is None or not tr["calls"]:
        return None
    device_s = sum(s for n, s in tr["kernel_s"].items()
                   if costs.in_group(n, costs.DECODE_BLOCK_KERNELS))
    if device_s <= 0:
        return None
    bound = sum(costs.block_bound_s(shape, rec["sessions"], rec["body_dtype"])
                for shape in decode_blocks(rec["cfg"])) * tr["calls"]
    return 100.0 * bound / device_s
