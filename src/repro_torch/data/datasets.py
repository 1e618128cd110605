"""Synthetic datasets standing in for the paper's corpora, numpy only.

A copy of the JAX package's ``data/datasets.py`` generators: the same
numpy Generator calls in the same order, so one seed gives the same bytes
in both packages (the parity tests hand the same arrays to both).  The
port keeps its own copy because that module's package imports JAX.

  - class_blobs:  well-separated Gaussian blobs, the serving paths' data
  - mnist_like:   (N, 784) in [0,1], 10 classes: GEMM-based + GNB
  - asd_like:     (N, 21) mixed-scale features, 2-3 classes: kNN / k-Means
  - digits_like:  (N, 64) in [0,16], 10 classes: RF
  - token_stream: a Zipfian pseudo-corpus with bigram structure: LM
    training
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

# Default row-chunk for the streaming generator: 64k rows of d=21 fp64
# noise is ~11 MB of transient, so million-row reference sets never hold
# an (N, d) fp64 intermediate.
_CHUNK = 1 << 16


def _blobs(rng, n: int, d: int, n_class: int, spread: float, scale: float):
    centers = rng.normal(size=(n_class, d)) * spread
    y = rng.integers(0, n_class, size=n)
    X = centers[y] + rng.normal(size=(n, d)) * scale
    return X.astype(np.float32), y.astype(np.int32)


def _separated_centers(rng, n_class: int, d: int, spread: float,
                       scale: float, max_tries: int = 64):
    """Resample blob centers until every pair is >= spread*scale apart."""
    min_sep = spread * scale
    centers = None
    for _ in range(max_tries):
        centers = rng.normal(size=(n_class, d)) * spread
        diff = centers[:, None, :] - centers[None, :, :]
        dist = np.sqrt((diff * diff).sum(-1))
        np.fill_diagonal(dist, np.inf)
        if n_class < 2 or dist.min() >= min_sep:
            return centers
    return centers  # pathological spread/scale combo: keep the last draw


def _blob_stream(rng, n: int, d: int, n_class: int, spread: float,
                 scale: float, chunk: int):
    centers = _separated_centers(rng, n_class, d, spread, scale)
    y = rng.integers(0, n_class, size=n).astype(np.int32)
    # one row per blob up front: kmeans_fit seeds its centroids from the
    # leading k rows (paper §4.4.2), so every blob gets an init centroid
    y[:min(n, n_class)] = np.arange(min(n, n_class), dtype=np.int32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        noise = rng.normal(size=(hi - lo, d)) * scale
        yield (centers[y[lo:hi]] + noise).astype(np.float32), y[lo:hi]


def class_blobs(n: int = 400, d: int = 21, n_class: int = 3, seed: int = 0,
                spread: float = 3.0, chunk: Optional[int] = None,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Well-separated Gaussian blobs: (X (n, d) float32, y (n,) int32).
    Noise is drawn in ``chunk``-row blocks; the Generator stream is
    element-sequential, so any chunk size gives the same bytes."""
    X = np.empty((n, d), np.float32)
    y = np.empty((n,), np.int32)
    lo = 0
    for Xc, yc in class_blobs_stream(n, d=d, n_class=n_class, seed=seed,
                                     spread=spread, chunk=chunk or _CHUNK):
        X[lo:lo + len(yc)] = Xc
        y[lo:lo + len(yc)] = yc
        lo += len(yc)
    return X, y


def class_blobs_stream(n: int, d: int = 21, n_class: int = 3, seed: int = 0,
                       spread: float = 3.0, chunk: int = _CHUNK,
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Chunked generator form of ``class_blobs``: (X_chunk, y_chunk) blocks
    of at most ``chunk`` rows whose concatenation equals the monolithic
    call byte for byte."""
    yield from _blob_stream(np.random.default_rng(seed), n, d, n_class,
                            spread, 1.0, chunk)


def mnist_like(n: int = 2000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST's shape: 784 features squashed into [0, 1], 10 classes."""
    rng = np.random.default_rng(seed)
    X, y = _blobs(rng, n, 784, 10, spread=0.8, scale=0.35)
    X = 1.0 / (1.0 + np.exp(-X))          # squash into [0,1] like pixels
    return X.astype(np.float32), y


def asd_like(n: int = 1000, n_class: int = 2, seed: int = 1):
    """The ASD screening set's shape: 21 features, the first 8 integer."""
    rng = np.random.default_rng(seed)
    X, y = _blobs(rng, n, 21, n_class, spread=2.0, scale=1.0)
    X[:, :8] = np.round(X[:, :8])
    return X.astype(np.float32), y


def digits_like(n: int = 1797, seed: int = 2):
    """scikit-learn digits' shape: 64 features in [0, 16], 10 classes."""
    rng = np.random.default_rng(seed)
    X, y = _blobs(rng, n, 64, 10, spread=2.5, scale=1.2)
    X = np.clip((X - X.min()) / (X.max() - X.min()) * 16.0, 0, 16)
    return X.astype(np.float32), y


def token_stream(n_tokens: int, vocab_size: int, seed: int = 3) -> np.ndarray:
    """Deterministic pseudo-corpus with a Zipfian unigram distribution and a
    short-range bigram structure (so CE actually decreases in training)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=n_tokens, p=probs)
    # bigram structure: with p=0.5, next token = f(prev)
    follow = rng.permutation(vocab_size)
    coin = rng.random(n_tokens) < 0.5
    out = base.copy()
    out[1:][coin[1:]] = follow[out[:-1][coin[1:]]]
    return out.astype(np.int32)
