"""K-Means (paper §4.4.2, Fig. 7).

Per iteration: OP1+OP2 nearest-centroid assignment through the dispatch
registry (its ``fused`` arm is the CUDA kernel B2); OP3 per-core local
centroid sums and counts over 8 row chunks as one-hot matmuls; OP4 the
global combine and divide.  Iterate until the largest centroid shift is
below the threshold; the first k rows are the initial centroids.

Counterpart of the JAX package's ``core/kmeans.py``.  The sums stay
one-hot matmuls, not ``index_add_``: its atomics would change the
summation order from run to run on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.distribution import pad_to_multiple, split_chunks
from repro_torch.kernels import dispatch


class KMeansState(NamedTuple):
    centroids: torch.Tensor   # (k, d)
    shift: torch.Tensor       # () largest centroid movement (L2)
    n_iter: torch.Tensor      # () int32


def kmeans_iteration(A: torch.Tensor, centroids: torch.Tensor,
                     n_cores: int = 8, *, path: str | None = None):
    """One Fig. 7 iteration.  A (N, d), centroids (k, d) -> (new
    centroids (k, d), assignments (N,) int32)."""
    k = centroids.shape[0]
    Ap, N = pad_to_multiple(A, n_cores, axis=0)
    chunks = split_chunks(Ap, n_cores, axis=0)                # (c, L, d)
    chunk_len = Ap.shape[0] // n_cores
    valid = (torch.arange(Ap.shape[0], device=A.device) < N).reshape(
        n_cores, chunk_len)

    # OP1 + OP2 — registry-selected distance -> argmin
    _, ids_flat = dispatch.distance_argmin(A, centroids, path=path)
    ids = torch.nn.functional.pad(ids_flat, (0, Ap.shape[0] - N)).reshape(
        n_cores, chunk_len)

    # OP3 — local centroid sums and counts per core, as one-hot matmuls
    onehot = ((ids[..., None] == torch.arange(k, device=A.device))
              & valid[..., None]).to(A.dtype)                 # (c, L, k)
    sums_local = onehot.transpose(1, 2) @ chunks              # (c, k, d)
    counts_local = onehot.sum(dim=1)                          # (c, k)

    # OP4 — global combine and divide
    sums = sums_local.sum(dim=0)
    counts = counts_local.sum(dim=0)
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / counts.clamp(min=1.0)[:, None],
                                centroids)
    return new_centroids, ids.reshape(-1)[:N]


def kmeans_fit(A: torch.Tensor, k: int, *, threshold: float = 1e-4,
               max_iters: int = 100, n_cores: int = 8,
               path: str | None = None
               ) -> Tuple[KMeansState, torch.Tensor]:
    """Iterate Fig. 7 until the largest shift is <= threshold or
    ``max_iters`` is reached.  Returns (state, assignments (N,))."""
    A = A.to(torch.float32)
    centroids = A[:k].clone()
    shift = torch.tensor(float("inf"), device=A.device)
    n_iter = 0
    while float(shift) > threshold and n_iter < max_iters:
        new_c, _ = kmeans_iteration(A, centroids, n_cores, path=path)
        shift = torch.max(torch.linalg.vector_norm(new_c - centroids, dim=1))
        centroids = new_c
        n_iter += 1
    _, ids = kmeans_iteration(A, centroids, n_cores, path=path)
    state = KMeansState(centroids=centroids, shift=shift,
                        n_iter=torch.tensor(n_iter, dtype=torch.int32,
                                            device=A.device))
    return state, ids


def inertia(A: torch.Tensor, centroids: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    """Sum of squared distances to the assigned centroids."""
    diff = A - centroids[ids.long()]
    return torch.sum(diff * diff)
