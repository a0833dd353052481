"""The benchmark of the PyTorch and CUDA port, driven by data (see run.py)."""
