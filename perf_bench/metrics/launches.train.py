"""launches.train: kernel launch calls a training step, from the runtime's launch events."""
from perf_bench.metrics_common import traced

UNIT = "launches/step"


def read(rec):
    tr = traced(rec, "train")
    if tr is None or not tr["steps"]:
        return None
    return tr["launches"] / tr["steps"]
