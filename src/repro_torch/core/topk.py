"""Partial top-k via Selection Sort (paper §4.4.3) and the stable
smallest-k rule every top-k in the port follows.

Ties go to the smallest index, the ``lax.top_k`` rule of the JAX
package's oracles.  ``torch.topk`` promises no order among ties, so the
stable helper sorts with ``stable=True`` and keeps the first k.
"""
from __future__ import annotations

from typing import Tuple

import torch


def selection_topk_smallest(x: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k passes of argmin + mask: the SS partial sort, O(nk).

    x: (n,).  Returns (values (k,), indices (k,) int32), ascending.
    ``torch.argmin`` returns the first minimal index, so ties go to the
    smallest index as in the JAX scan."""
    vals = x.to(torch.float32).clone()
    out_v = torch.empty((k,), dtype=torch.float32, device=x.device)
    out_i = torch.empty((k,), dtype=torch.int64, device=x.device)
    for j in range(k):
        i = torch.argmin(vals)
        out_v[j] = vals[i]
        out_i[j] = i
        vals[i] = float("inf")
    return out_v, out_i.to(torch.int32)


def topk_smallest_stable(x: torch.Tensor, k: int, dim: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along ``dim``, ascending, ties to the smallest
    index.  Returns (values, indices int32)."""
    vals, idx = torch.sort(x, dim=dim, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k).to(torch.int32)
