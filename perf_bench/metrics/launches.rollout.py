"""launches.rollout: kernel launch calls a denoiser call, from the runtime's launch events."""
from perf_bench.metrics_common import traced

UNIT = "launches/call"


def read(rec):
    tr = traced(rec, "rollout")
    if tr is None or not tr["calls"]:
        return None
    return tr["launches"] / tr["calls"]
