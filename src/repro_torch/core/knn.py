"""k-Nearest-Neighbour (paper §4.4, Fig. 6).

OP1: row-wise chunking of the training set, per-core squared distances
into e (N,).  OP2: per-core Selection Sort top-k on its chunk.  OP3: the
master merges the c*k local candidates and votes.

Two paths, as in the JAX package's ``core/knn.py``:
  * ``knn_classify`` — the literal Fig. 6 pipeline, one query per call
    (``knn_predict_batch`` runs it for each query of a batch);
  * ``knn_classify_batch`` — the serving path: Q queries per call through
    the dispatch registry, whose ``fused`` arm is the CUDA kernel B1.
Both break distance ties to the smallest row and vote ties to the lowest
class.  Neighbour indices are int32, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.distribution import pad_to_multiple, split_chunks
from repro_torch.core.topk import local_global_topk_smallest
from repro_torch.kernels import dispatch

_INF = float("inf")


class KNNModel(NamedTuple):
    A: torch.Tensor        # (N, d) training samples
    labels: torch.Tensor   # (N,) int32
    n_class: int


def sq_distances(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances of one query against all rows of A."""
    diff = A - x[None, :]
    return torch.sum(diff * diff, dim=1)


def _vote(labels: torch.Tensor, nbr_idx: torch.Tensor,
          n_class: int) -> torch.Tensor:
    """Majority vote per row of neighbour indices (Q, k) -> classes (Q,)
    int32; ``argmax`` returns the first maximum, so ties go to the lowest
    class id.  Counts are integers, so the scatter is exact on the card."""
    nbr_labels = labels[nbr_idx.long()].long()                # (Q, k)
    votes = torch.zeros((nbr_idx.shape[0], n_class), dtype=torch.int32,
                        device=nbr_idx.device)
    votes.scatter_add_(1, nbr_labels, torch.ones_like(nbr_labels,
                                                      dtype=torch.int32))
    return torch.argmax(votes, dim=1).to(torch.int32)


def knn_classify(model: KNNModel, x: torch.Tensor, k: int,
                 n_cores: int = 8):
    """The Fig. 6 pipeline for one query x (d,).  Returns (class (),
    neighbour indices (k,) int32)."""
    Ap, N = pad_to_multiple(model.A, n_cores, axis=0)
    chunks = split_chunks(Ap, n_cores, axis=0)            # (c, N/c, d)

    # OP1 — per-core distances over its row chunk; padded rows masked
    e = torch.cat([sq_distances(ch, x) for ch in chunks])
    e = torch.where(torch.arange(e.shape[0], device=e.device) < N, e, _INF)

    # OP2 — local Selection Sort per core; OP3 — the master merges the
    # c*k candidates, then votes
    _, nbr_idx = local_global_topk_smallest(e, k, n_cores)
    return _vote(model.labels, nbr_idx[None], model.n_class)[0], nbr_idx


def knn_predict_batch(model: KNNModel, X: torch.Tensor, k: int,
                      n_cores: int = 8) -> torch.Tensor:
    """The Fig. 6 pipeline for each query of X (Q, d) -> classes (Q,)
    int32 (one ``knn_classify`` a query)."""
    return torch.stack([knn_classify(model, x, k, n_cores)[0] for x in X])


def knn_classify_batch(model: KNNModel, X: torch.Tensor, k: int, *,
                       policy=None, path: str | None = None):
    """X (Q, d) queries in one registry call -> (classes (Q,) int32,
    neighbour indices (Q, k) int32)."""
    _, nbr_idx = dispatch.distance_topk(model.A, X, k, policy=policy,
                                        path=path)
    return _vote(model.labels, nbr_idx, model.n_class), nbr_idx
