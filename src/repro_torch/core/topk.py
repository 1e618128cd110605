"""Partial top-k via Selection Sort (paper §4.4.3), the local/global
two-level scheme kNN uses (Fig. 6 OP2/OP3), and the stable smallest-k
rule every top-k in the port follows.

Ties go to the smallest index, the ``lax.top_k`` rule of the JAX
package's oracles.  ``torch.topk`` promises no order among ties, so the
stable helper sorts with ``stable=True`` and keeps the first k.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.distribution import pad_to_multiple, split_chunks

_INF = float("inf")


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


def selection_topk_largest(x: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of x (n,), descending, ties to the smallest index."""
    vs, idx = selection_topk_smallest(-x, k)
    return -vs, idx


def local_global_topk_smallest(x: torch.Tensor, k: int, n_cores: int = 8
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Fig. 6: per-core local Selection Sort over its chunk (OP2),
    then the master merges the c*k candidates (OP3).  The same result as a
    global top-k: padding is +inf, each chunk's candidates are in index
    order among equals, and the merge keeps the first of equal values.

    x: (n,).  Returns (values (k,), indices (k,) int32), ascending."""
    xp, _ = pad_to_multiple(x.to(torch.float32), n_cores, value=_INF)
    chunks = split_chunks(xp, n_cores)                   # (c, n/c)

    # OP2 — local Selection Sort per core
    local = [selection_topk_smallest(ch, k) for ch in chunks]
    lv = torch.stack([v for v, _ in local])
    li = torch.stack([i for _, i in local])
    chunk_len = xp.shape[0] // n_cores
    li_global = li + (torch.arange(n_cores, device=x.device,
                                   dtype=torch.int32) * chunk_len)[:, None]

    # OP3 — global merge of the c*k candidates on the master core
    gv, gi = selection_topk_smallest(lv.reshape(-1), k)
    return gv, li_global.reshape(-1)[gi.long()]


def local_global_topk_largest(x: torch.Tensor, k: int, n_cores: int = 8
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest by the two-level scheme (padding is -inf)."""
    vs, idx = local_global_topk_smallest(-x, k, n_cores)
    return -vs, idx


def sorting_cost_model(n: int, k: int, c: int = 1):
    """Paper Eq. 14 comparison counts: QS vs SS, sequential and
    parallel."""
    nc = max(n // max(c, 1), 1)
    qs = nc * math.log2(max(nc, 2)) + (c * k if c > 1 else 0)
    ss = nc * k + (c * k if c > 1 else 0)
    return {"quick_sort": qs, "selection_sort": ss,
            "ss_favorable": k < math.log2(max(nc, 2))}


def topk_smallest_stable(x: torch.Tensor, k: int, dim: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along ``dim``, ascending, ties to the smallest
    index.  Returns (values, indices int32)."""
    vals, idx = torch.sort(x, dim=dim, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k).to(torch.int32)
