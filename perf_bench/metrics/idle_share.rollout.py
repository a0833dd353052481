"""idle_share.rollout: the share of the profiled sub-window in which no kernel ran on the card."""
from perf_bench.metrics_common import traced

UNIT = "%"


def read(rec):
    tr = traced(rec, "rollout")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
