"""Hand-written CUDA kernels for Hopper (``csrc/``), their launchers, their
plain PyTorch versions (``ref.py``) and the dispatch registry."""
