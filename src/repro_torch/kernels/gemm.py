"""Launcher of the CUDA kernel B10 (GEMM, C = A·B) in ``csrc/gemm.cu``.

Counterpart of the JAX package's ``kernels/gemm.py``.  Takes contiguous
CUDA tensors of one dtype (fp32 or bf16) that ``kernels/ops.py`` has
already checked, allocates the output (and, for split-K, the fp32
partials) with ``torch.empty`` and launches on the current stream without
synchronising.  Ragged M, N and K are masked in the kernel, so nothing is
padded.

M <= ``SMALL_M`` takes the matrix-vector configuration, whose K axis is
split across blocks (``plan_small``); larger M takes the tiled one.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_STEM = "gemm"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: Dict[str, ctypes._CFuncPtr] = {}
# zeroed split-K arrival counters per (device, stream); each launch leaves
# them zero again
_counters: Dict[Tuple[int, int], torch.Tensor] = {}

SMALL_M = 16          # rows up to which the matrix-vector configuration runs
ROWS = 4              # rows of A per block there
MIN_SPLIT_ROWS = 64   # K rows a split takes at least
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def strip_width(dtype: torch.dtype) -> int:
    """Columns of one block of the matrix-vector configuration: a warp's
    32 lanes each read 16 bytes of a B row."""
    return 32 * (16 // dtype.itemsize)


def plan_small(M: int, N: int, K: int, dtype: torch.dtype,
               sms: int) -> Tuple[int, int]:
    """(splits, K rows per split) of the matrix-vector configuration:
    enough splits of K that the blocks make about two waves over ``sms``
    multiprocessors, each split at least ``MIN_SPLIT_ROWS`` rows, and no
    split empty."""
    blocks = -(-N // strip_width(dtype)) * -(-M // ROWS)
    splits = max(1, min(-(-2 * sms // blocks), K // MIN_SPLIT_ROWS))
    per = -(-K // splits)
    return -(-K // per), per


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _counter_buffer(device: torch.device, stream: int, n: int
                    ) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B10: a (M, K), b (K, N), both fp32 or both bf16 on the card ->
    (M, N) in their dtype."""
    if not _fns:
        _fns["small"] = _build.bind(_STEM, "gemm_small",
                                    [_I] + [_P] * 5 + [_I] * 5 + [_P])
        _fns["tiled"] = _build.bind(_STEM, "gemm_tiled",
                                    [_I] + [_P] * 3 + [_I] * 3 + [_P])
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = _DTYPES[a.dtype]
    if M <= SMALL_M:
        splits, per = plan_small(M, N, K, a.dtype, _sms(a.device))
        partial = counters = None
        if splits > 1:
            partial = torch.empty((splits, M, N), dtype=torch.float32,
                                  device=a.device)
            counters = _counter_buffer(
                a.device, stream,
                -(-N // strip_width(a.dtype)) * -(-M // ROWS))
        err = _fns["small"](code, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            None if partial is None else partial.data_ptr(),
                            None if counters is None else counters.data_ptr(),
                            M, N, K, splits, per, stream)
        what = f"gemm M={M} N={N} K={K} {a.dtype} splits={splits}"
    else:
        err = _fns["tiled"](code, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            M, N, K, stream)
        what = f"gemm M={M} N={N} K={K} {a.dtype} tiled"
    _build.check(_STEM, err, what)
    return out
