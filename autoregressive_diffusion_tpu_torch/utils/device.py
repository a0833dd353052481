"""Device selection: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return the torch.device to run on. The default is the card; without
    one this raises instead of falling back to the CPU silently -- pass
    device="cpu" to run the plain PyTorch versions of the kernels there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them for `device` (its index), or "cpu"."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read (no nvidia-smi)"
