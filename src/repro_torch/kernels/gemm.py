"""Launcher of the CUDA kernel B10 (GEMM, C = A·B) in ``csrc/gemm.cu``.

Counterpart of the JAX package's ``kernels/gemm.py``.  Takes contiguous
CUDA tensors of one dtype (fp32 or bf16) that ``kernels/ops.py`` has
already checked, allocates the output with ``torch.empty`` and launches on
the current stream without synchronising.  Ragged M, N and K are masked
in the kernels, so nothing is padded.

Four routes, by a stated shape rule (``route``):
  * ``small_m``: M <= ``SMALL_M``, either dtype: the matrix-vector kernel,
    K split over the blocks of a thread block cluster (``plan_small``);
  * ``wgmma``: ``uses_wgmma`` (bf16, M > ``SMALL_M``, K and N multiples of
    8, 16-byte-aligned bases): the TMA-fed wgmma kernel;
  * ``mma_sync``: other bf16 shapes with M > ``SMALL_M``;
  * ``fp32``: fp32 with M > ``SMALL_M``, on the CUDA cores.
``ROUTE_LAUNCHES`` counts launches per route, beside ``ops.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_STEM = "gemm"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: Dict[str, ctypes._CFuncPtr] = {}
_sm_counts: Dict[int, int] = {}

SMALL_M = 16          # rows up to which the matrix-vector kernel runs
MIN_SPLIT_ROWS = 64   # K rows of a cluster rank: one stage of the ring
MAX_CLUSTER = 8       # blocks of a cluster, the portable limit
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "mma_sync": 0, "small_m": 0,
                                  "fp32": 0}


def strip_width(dtype: torch.dtype) -> int:
    """Columns of one block of the matrix-vector kernel: a strip row of
    256 bytes, one 4-byte word per consumer thread."""
    return 256 // dtype.itemsize


def plan_small(M: int, N: int, K: int, dtype: torch.dtype,
               sms: int) -> Tuple[int, int]:
    """(cluster size, K rows per cluster rank) of the matrix-vector
    kernel: as many ranks as keep the blocks at most two per SM over
    ``sms`` multiprocessors (two fit at once, so none waits for a second
    round), at most ``MAX_CLUSTER``, each rank a whole number of
    ``MIN_SPLIT_ROWS``-row stages, and no rank empty."""
    strips = -(-N // strip_width(dtype))
    want = 2 * sms // strips
    splits = max(1, min(MAX_CLUSTER, want, -(-K // MIN_SPLIT_ROWS)))
    per = -(-(-(-K // splits)) // MIN_SPLIT_ROWS) * MIN_SPLIT_ROWS
    return -(-K // per), per


def uses_wgmma(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the wgmma kernel takes a (M, K) @ b (K, N): bf16, M past
    ``SMALL_M``, K and N multiples of 8 (TMA needs 16-byte row strides)
    and both bases 16-byte aligned."""
    M, K = a.shape
    N = b.shape[1]
    return (a.dtype == b.dtype == torch.bfloat16 and M > SMALL_M and
            K % 8 == 0 and N % 8 == 0 and
            a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """The route a (M, K) @ b (K, N) takes: ``small_m``, ``wgmma``,
    ``mma_sync`` or ``fp32``."""
    if a.shape[0] <= SMALL_M:
        return "small_m"
    if uses_wgmma(a, b):
        return "wgmma"
    return "mma_sync" if a.dtype == torch.bfloat16 else "fp32"


def sm_count(device: torch.device) -> int:
    """Multiprocessors of ``device``, queried once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _bind() -> None:
    _fns["small"] = _build.bind(_STEM, "gemm_small",
                                [_I] + [_P] * 3 + [_I] * 5 + [_P])
    _fns["wgmma"] = _build.bind(_STEM, "gemm_wgmma",
                                [_P] * 3 + [_I] * 4 + [_P])
    _fns["tiled"] = _build.bind(_STEM, "gemm_tiled",
                                [_I] + [_P] * 3 + [_I] * 3 + [_P])


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B10: a (M, K), b (K, N), both fp32 or both bf16 on the card ->
    (M, N) in their dtype."""
    if not _fns:
        _bind()
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    way = route(a, b)
    if way == "small_m":
        cluster, per = plan_small(M, N, K, a.dtype, sm_count(a.device))
        err = _fns["small"](_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                            out.data_ptr(), M, N, K, cluster, per, stream)
        what = f"cluster={cluster} per={per}"
    elif way == "wgmma":
        err = _fns["wgmma"](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                            K, sm_count(a.device), stream)
        what = "wgmma"
    else:
        err = _fns["tiled"](_DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
                            out.data_ptr(), M, N, K, stream)
        what = way
    _build.check(_STEM, err, f"gemm M={M} N={N} K={K} {a.dtype} {what}")
    ROUTE_LAUNCHES[way] += 1
    return out
