"""PyTorch/CUDA port of the Non-Neural pipelines (kNN, K-Means, GNB).

Mirrors the layout of the JAX package (``core/ kernels/ serving/ launch/
data/``) so each module has a counterpart there.  The hot ops run in
hand-written CUDA kernels for Hopper (``kernels/csrc/``); every kernel
keeps a plain PyTorch version beside it, which is what runs for tensors on
the CPU.  Entry points run on ``cuda`` unless the caller names a device
(``repro_torch.device.resolve_device``).
"""
