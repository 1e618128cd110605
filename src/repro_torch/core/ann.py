"""Approximate kNN: IVF coarse quantizer + int8 product quantization.

Counterpart of the JAX package's ``core/ann.py`` (its DESIGN.md §10).

  * The IVF coarse quantizer is K-Means (``core/kmeans.py``): the fit
    clusters the reference rows into ``n_cells`` cells, then builds
    per-cell inverted lists padded to one power-of-two capacity, a dense
    (C, cap) int32 array padded with -1.
  * The scorer is product quantization: features split into ``m``
    subspaces, a K-Means codebook per subspace, every reference row stored
    as ``m`` int8 codes (code - 128).  Serving runs asymmetric distance
    computation (ADC): each query builds one integer LUT against the
    codebooks (``build_query_luts``), and every candidate costs ``m`` table
    lookups (B8, ``dispatch.adc_topk``).

``ann_classify_batch`` probes each query's ``nprobe`` nearest cells with
the same ``distance_topk`` op exact kNN serves with (B1), gathers the
probed cells' members, ranks them by ADC, optionally re-ranks the top
``refine`` survivors exactly, and votes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import kmeans as _kmeans
from repro_torch.core.topk import topk_smallest_stable
from repro_torch.kernels import dispatch

# training subsample cap: the cells and codebooks only need the data's
# distribution, so Lloyd runs on at most this many leading rows; the
# assignment and the encoding always cover every row
_TRAIN_CAP = 1 << 16


class ANNParams(NamedTuple):
    centroids: torch.Tensor   # (C, d) IVF cell centroids (policy dtype)
    cell_ids: torch.Tensor    # (C, cap) int32 inverted lists, -1 padded
    codebooks: torch.Tensor   # (m, n_codes, dsub) PQ codebooks
    codes: torch.Tensor       # (N, m) int8 PQ codes, stored code - 128
    refs: torch.Tensor        # (N, d) raw rows (policy dtype), for refine
    labels: torch.Tensor      # (N,) int32
    n_class: int


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def build_query_luts(X: torch.Tensor, codebooks: torch.Tensor
                     ) -> torch.Tensor:
    """Queries (B, d) + codebooks (m, n_codes, dsub) -> per-query integer
    ADC LUTs (B, m * n_codes) int32 on a shared 0..255 step.

    The fp32 table ``lut[b, j, c] = ||x_b_j - codebook[j, c]||^2`` maps onto
    integers by subtracting each subspace's per-query minimum and dividing
    by one per-query step (the largest subspace range / 255): one step for
    every subspace keeps the m-term sum rank-preserving, and one per query
    keeps every row of a batch independent."""
    m, n_codes, dsub = codebooks.shape
    B, d = X.shape
    Xf = X.to(torch.float32)
    if d < m * dsub:                       # zero-pad to the PQ width
        Xf = F.pad(Xf, (0, m * dsub - d))
    q = Xf.reshape(B, m, 1, dsub)
    diff = q - codebooks.to(torch.float32)[None]   # (B, m, n_codes, dsub)
    lut = torch.sum(diff * diff, dim=3)            # (B, m, n_codes)
    lut0 = lut - torch.amin(lut, dim=2, keepdim=True)
    step = torch.amax(lut0, dim=(1, 2), keepdim=True) / 255.0
    step = torch.clamp(step, min=1e-12)
    q8 = torch.clamp(torch.round(lut0 / step), 0, 255).to(torch.int32)
    return q8.reshape(B, m * n_codes)


def _masked_vote(labels: torch.Tensor, nbr: torch.Tensor,
                 n_class: int) -> torch.Tensor:
    """kNN majority vote per row over possibly invalid (-1) neighbour ids:
    invalid slots vote into a discarded overflow bin, ties go to the
    lowest class (the rule of ``core/knn.py::_vote``)."""
    lab = torch.where(nbr >= 0, labels[nbr.clamp(min=0).long()],
                      n_class).long()
    votes = torch.zeros((nbr.shape[0], n_class + 1), dtype=torch.int32,
                        device=nbr.device)
    votes.scatter_add_(1, lab, torch.ones_like(lab, dtype=torch.int32))
    return torch.argmax(votes[:, :n_class], dim=1).to(torch.int32)


def fit_ivf_pq(X: torch.Tensor, y: torch.Tensor, *, n_cells: int, m: int,
               n_codes: int, n_class: int, max_iters: int = 25,
               cast: Optional[Callable] = None) -> ANNParams:
    """Train the IVF cells and the PQ codebooks on the leading
    ``_TRAIN_CAP`` rows and encode every row of X (N, d), fp32 on the
    estimator's device; the assignments go through the registry's
    ``distance_argmin`` (B2)."""
    cast = cast or (lambda t: t)
    Xf = X.to(torch.float32).contiguous()
    N, d = Xf.shape
    train = Xf[:min(N, _TRAIN_CAP)]

    # IVF cells: Lloyd over the leading rows, then assign every row
    state, _ = _kmeans.kmeans_fit(train, n_cells, max_iters=max_iters)
    _, cell_of = dispatch.distance_argmin(Xf, state.centroids)
    cell_np = cell_of.cpu().numpy()

    # inverted lists, built on the host: one power-of-two capacity, -1
    # padded; members in ascending row order (stable sort), so every tie
    # rule downstream sees candidates in global-id order
    counts = np.bincount(cell_np, minlength=n_cells)
    cap = _pow2_at_least(max(int(counts.max()), 1))
    cell_ids = np.full((n_cells, cap), -1, np.int32)
    order = np.argsort(cell_np, kind="stable")
    offsets = np.zeros(n_cells, np.int64)
    offsets[1:] = np.cumsum(counts)[:-1]
    for c in range(n_cells):
        cell_ids[c, :counts[c]] = order[offsets[c]:offsets[c] + counts[c]]

    # PQ: d zero-padded to m * dsub, one codebook per subspace, int8 codes
    dsub = -(-d // m)
    Xp = F.pad(Xf, (0, m * dsub - d))
    books, codes = [], []
    for j in range(m):
        sub = Xp[:, j * dsub:(j + 1) * dsub].contiguous()
        st, _ = _kmeans.kmeans_fit(sub[:min(N, _TRAIN_CAP)], n_codes,
                                   max_iters=max_iters)
        _, code_j = dispatch.distance_argmin(sub, st.centroids)
        books.append(st.centroids)
        codes.append(code_j)
    codebooks = torch.stack(books)                     # (m, n_codes, dsub)
    codes8 = (torch.stack(codes, dim=1) - 128).to(torch.int8)   # (N, m)

    return ANNParams(centroids=cast(state.centroids),
                     cell_ids=torch.from_numpy(cell_ids).to(Xf.device),
                     codebooks=cast(codebooks), codes=codes8.contiguous(),
                     refs=cast(Xf), labels=y.to(torch.int32),
                     n_class=n_class)


def ann_classify_batch(params: ANNParams, X: torch.Tensor, k: int,
                       nprobe: int, *, refine: int = 0, policy=None,
                       path: Optional[str] = None):
    """Batched IVF-PQ classify: probe -> gather inverted lists -> ADC
    score [-> exact refine] -> vote.  Returns (classes (B,) int32,
    neighbour ids (B, k) int32, -1 where a query's probed cells held fewer
    than k members).

    ``refine > 0`` keeps the ADC scan as the candidate filter and re-ranks
    its top ``refine`` survivors by exact fp32 distance, per row (ties to
    the ADC rank order)."""
    B = X.shape[0]
    C = params.centroids.shape[0]
    p = min(nprobe, C)

    # coarse probe: the distance_topk op exact kNN serves with, over the C
    # cell centroids instead of the N reference rows
    _, cells = dispatch.distance_topk(params.centroids, X, p, policy=policy,
                                      path=path)                # (B, p)
    cand = params.cell_ids[cells.long()].reshape(
        B, p * params.cell_ids.shape[1])
    want = max(k, min(refine, cand.shape[1]) if refine > 0 else 0)
    if cand.shape[1] < want:               # degenerate tiny indexes
        cand = F.pad(cand, (0, want - cand.shape[1]), value=-1)

    qlut = build_query_luts(X, params.codebooks)       # (B, m*n_codes)
    cand_codes = params.codes[cand.clamp(min=0).long()]   # (B, L, m) int8
    _, pos = dispatch.adc_topk(qlut, cand_codes, cand, want, policy=policy,
                               path=path)               # (B, want)
    del cand_codes
    nbr = torch.gather(cand, 1, pos.long())            # global ids
    if want > k:
        rows = params.refs[nbr.clamp(min=0).long()].to(torch.float32)
        diff = rows - X.to(torch.float32)[:, None, :]
        dist = torch.sum(diff * diff, dim=2)           # (B, want)
        dist = torch.where(nbr < 0, float("inf"), dist)
        _, sel = topk_smallest_stable(dist, k, dim=1)
        nbr = torch.gather(nbr, 1, sel.long())         # (B, k)
    return _masked_vote(params.labels, nbr, params.n_class), nbr
