"""The benchmark of ``pfpn_torch``, the PyTorch and CUDA port, on one
NVIDIA card. Entry point: ``portbench/run.py``; see ``bench.py``."""
