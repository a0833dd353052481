"""peak_mem_gib.train: the process's peak of allocated device memory,
from its start to the window's end."""
UNIT = "GiB"


def read(rec):
    if rec.get("kind") != "train" or not rec.get("memory_peak_bytes"):
        return None
    return rec["memory_peak_bytes"] / 2 ** 30
