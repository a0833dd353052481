"""Shared by the benchmark's CPU tests: the repository on the import path,
torch held to a few threads, and cells cut to a size the CPU runs in seconds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(img_resolution=16, model_channels=16, channel_mult=[1, 2], num_blocks=1,
            video_attn_resolutions=[8], frame_attn_resolutions=[16], channels_per_head=16)
TINY_ROLLOUT = dict(sessions=4, context_frames=6, prefill_chunk=4, num_steps=3)
TINY_TRAIN = dict(batch=2, micro_batch=1, frames=4)


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    import torch
    torch.set_num_threads(2)


def tiny_cell(name: str) -> dict:
    """The cell `name` at a tiny width and depth (the sizes of the model's
    plain CPU tests) and in float32, where the program's plain CPU path and
    the reference agree to round-off under every limit; the same files
    otherwise."""
    from perf_bench import harness
    cell = harness.load_cell(name)
    cfg = cell["config_spec"]
    cfg["body_dtype"] = "float32"
    cfg["model"].update(TINY)
    if "serve" in cfg:
        cfg["serve"] = {"max_frames": 8}
    else:
        cfg["model"]["max_frames"] = 8
    cell["traffic_spec"].update(TINY_TRAIN if cell["driver"] == "train" else TINY_ROLLOUT)
    return cell
