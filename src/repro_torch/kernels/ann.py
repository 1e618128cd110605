"""IVF-PQ asymmetric distances: the sentinel and the launcher of the CUDA
kernel B8 in ``csrc/adc_topk.cu``.

Counterpart of the JAX package's ``kernels/ann.py``.  The LUT is integer
by construction (``core/ann.py::build_query_luts`` puts it on a 0..255
step), so a candidate's ADC distance is a bounded integer and an invalid
candidate (id < 0, ragged-cell padding) takes ``adc_dmax(m)``, one past
the largest reachable distance, in value space.  The launcher takes
contiguous CUDA tensors that ``kernels/ops.py`` has already checked.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_QSTEPS = 255                  # LUT values live on the 0..255 integer step


def adc_dmax(m: int) -> int:
    """Invalid-candidate sentinel: one past the largest reachable ADC
    distance (``m`` subspaces x 255 steps)."""
    return m * _QSTEPS + 1


def packed_cols_limit(m: int) -> int:
    """The reference's largest candidate block ``bl`` whose packed key
    ``dist * bl + lane`` fits int32 (dist <= adc_dmax(m))."""
    return (2 ** 31 - 1) // (adc_dmax(m) + 1)


_STEM = "adc_topk"
_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def lut_in_smem(m: int, n_codes: int) -> bool:
    """Whether B8 stages a LUT of ``m * n_codes`` entries in shared memory
    (else it reads the LUT from device memory)."""
    fn = _build.bind(_STEM, "adc_lut_in_smem", [_I, _I])
    return bool(fn(m, n_codes))


def launch_dist(qlut: torch.Tensor, codes: torch.Tensor,
                cand_ids: torch.Tensor) -> torch.Tensor:
    """B8: qlut (Q, m*n_codes) int32, codes (Q, L, m) int8 (code - 128),
    cand_ids (Q, L) int32 on the card -> (Q, L) int32 ADC distances,
    ``adc_dmax(m)`` where the id is negative."""
    if "dist" not in _fns:
        _fns["dist"] = _build.bind(_STEM, "adc_dist_i32",
                                   [_P] * 4 + [_I] * 4 + [_P])
    Q, L, m = codes.shape
    n_codes = qlut.shape[1] // m
    out = torch.empty((Q, L), dtype=torch.int32, device=codes.device)
    err = _fns["dist"](qlut.data_ptr(), codes.data_ptr(), cand_ids.data_ptr(),
                       out.data_ptr(), Q, L, m, n_codes,
                       torch.cuda.current_stream().cuda_stream)
    _build.check(_STEM, err, f"adc_dist Q={Q} L={L} m={m} "
                             f"n_codes={n_codes}")
    return out
