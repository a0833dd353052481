"""mfu.rollout: the model call's share of the card's bf16 peak over the profiled calls.

Operations of each call from the frozen cost model at that call's ring fill
(costs.denoiser_call_cost, batch 1, times the sessions), over the
sub-window's wall time and the bf16 peak. Elementwise work is not counted.
"""
from perf_bench import costs
from perf_bench.metrics_common import traced

UNIT = "%"


def read(rec):
    tr = traced(rec, "rollout")
    if tr is None or not tr["calls"]:
        return None
    rows = costs.denoiser_call_cost(rec["cfg"], rec["body_dtype"], tr["ring_frames"])
    flops = sum(r[2] for r in rows) * rec["sessions"] * tr["calls"]
    return 100.0 * flops / tr["window_s"] / costs.PEAK_FLOPS["bfloat16"]
