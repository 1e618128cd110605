"""Random Forest (paper §4.5, Fig. 8).

Trees are the paper's four flat arrays (feature, threshold, left, right);
a leaf has a negative feature, and its class is ``-feature - 1``.

Training is the JAX package's numpy CART (``core/random_forest.py``),
copied line for line with the same per-tree rng streams, so a forest
fitted from the same data and seed is bit-equal to the reference's.
Inference walks all (query, tree) pairs at once on the device: a fixed
number of gather steps equal to the forest's longest root-to-leaf path,
worked out once on the host, then the votes by ``scatter_add``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Forest(NamedTuple):
    feature: torch.Tensor    # (T, M) int32; < 0 marks a leaf (class -f-1)
    threshold: torch.Tensor  # (T, M) float32
    left: torch.Tensor       # (T, M) int32
    right: torch.Tensor      # (T, M) int32
    n_class: int


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


def forest_depth(forest: Forest) -> int:
    """The longest root-to-leaf path of the forest, in internal nodes:
    the number of steps after which every traversal has reached its leaf.
    One host read of the node arrays."""
    feature = forest.feature.cpu().numpy()
    left, right = forest.left.cpu().numpy(), forest.right.cpu().numpy()
    deepest = 0
    for t in range(feature.shape[0]):
        level, frontier = 0, [0]
        while True:
            inner = [i for i in frontier if feature[t, i] >= 0]
            if not inner:
                break
            level += 1
            frontier = [c for i in inner for c in (left[t, i], right[t, i])]
        deepest = max(deepest, level)
    return deepest


def forest_classify_batch(forest: Forest, X: torch.Tensor, *,
                          depth: Optional[int] = None):
    """Fig. 8 over a batch: every tree on every query -> (classes (B,)
    int32, votes (B, n_class) int32), the class being the first index of
    the most votes.

    The reference spreads the trees over its cores and pads a ragged
    forest with one-leaf trees that vote into a sentinel bin it then
    drops; integer votes do not depend on that grouping, so here every
    tree votes at once and no tree is padded.  ``depth``:
    ``forest_depth(forest)`` if the caller has it, else it is worked out
    here."""
    if depth is None:
        depth = forest_depth(forest)
    B = X.shape[0]
    T, M = forest.feature.shape
    dev = X.device
    feature = forest.feature.reshape(-1).long()
    threshold = forest.threshold.reshape(-1)
    left = forest.left.reshape(-1).long()
    right = forest.right.reshape(-1).long()
    base = (torch.arange(T, device=dev) * M)[None, :]       # (1, T)
    node = base.expand(B, T).clone()                         # (B, T)
    for _ in range(depth):
        f = feature[node]
        x = torch.gather(X, 1, f.clamp(min=0))
        step = torch.where(x <= threshold[node], left[node], right[node])
        node = torch.where(f >= 0, base + step, node)
    leaf_class = -feature[node] - 1                          # (B, T)
    votes = torch.zeros((B, forest.n_class), dtype=torch.int32, device=dev)
    votes.scatter_add_(1, leaf_class, torch.ones_like(leaf_class,
                                                      dtype=torch.int32))
    return torch.argmax(votes, dim=1).to(torch.int32), votes


def pad_nodes(forest: Forest, capacity: int) -> Forest:
    """Pad the node axis (M, the last) to ``capacity`` with never-visited
    leaf nodes (feature -1, threshold 0, children 0): node 0 is always a
    real root and no real node links past M, so a traversal never reaches
    the padding.  How independently trained forests with different node
    counts land on one shape, so that a model group stacks
    (``serving/model_store.py``).  Works on a stacked group's (G, T, M)
    arrays too."""
    M = forest.feature.shape[-1]
    pad = capacity - M
    if pad < 0:
        raise ValueError(f"pad_nodes: capacity {capacity} < {M} nodes")
    if pad == 0:
        return forest

    def pf(a, value):
        return torch.nn.functional.pad(a, (0, pad), value=value)

    return forest._replace(feature=pf(forest.feature, -1),
                           threshold=pf(forest.threshold, 0.0),
                           left=pf(forest.left, 0),
                           right=pf(forest.right, 0))


def forest_classify_batch_group(forest: Forest, X: torch.Tensor, *,
                                depth: Optional[int] = None):
    """``forest_classify_batch`` over a model group: stacked forests
    (arrays (G, T, M)) and queries X (G, B, d) -> (classes (G, B) int32,
    votes (G, B, n_class) int32), every tenant's trees on its own queries
    in one pass of gathers.  ``depth``: the deepest tenant's; by default
    worked out from the stacked arrays (one host read).  Steps past a
    tenant's own depth leave its leaves where they are, so the votes are
    each tenant's own."""
    G, T, M = forest.feature.shape
    if depth is None:
        depth = forest_depth(Forest(
            feature=forest.feature.reshape(G * T, M),
            threshold=forest.threshold.reshape(G * T, M),
            left=forest.left.reshape(G * T, M),
            right=forest.right.reshape(G * T, M), n_class=forest.n_class))
    B = X.shape[1]
    dev = X.device
    feature = forest.feature.reshape(-1).long()
    threshold = forest.threshold.reshape(-1)
    left = forest.left.reshape(-1).long()
    right = forest.right.reshape(-1).long()
    base = (torch.arange(G * T, device=dev) * M).reshape(G, 1, T)
    node = base.expand(G, B, T).clone()                      # (G, B, T)
    for _ in range(depth):
        f = feature[node]
        x = torch.gather(X, 2, f.clamp(min=0))
        step = torch.where(x <= threshold[node], left[node], right[node])
        node = torch.where(f >= 0, base + step, node)
    leaf_class = -feature[node] - 1                          # (G, B, T)
    votes = torch.zeros((G, B, forest.n_class), dtype=torch.int32,
                        device=dev)
    votes.scatter_add_(2, leaf_class, torch.ones_like(leaf_class,
                                                      dtype=torch.int32))
    return torch.argmax(votes, dim=2).to(torch.int32), votes


# ---------------------------------------------------------------------------
# Training: from-scratch CART (numpy, offline — like the paper's sklearn)
# ---------------------------------------------------------------------------


def _gini(counts):
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return 1.0 - np.sum(p * p)


def _best_split(X, y, n_class, feat_subset, rng):
    best = (None, None, np.inf)
    parent_n = len(y)
    for f in feat_subset:
        vals = X[:, f]
        order = np.argsort(vals, kind="stable")
        sv, sy = vals[order], y[order]
        left_counts = np.zeros(n_class)
        right_counts = np.bincount(sy, minlength=n_class).astype(float)
        for i in range(parent_n - 1):
            left_counts[sy[i]] += 1
            right_counts[sy[i]] -= 1
            if sv[i] == sv[i + 1]:
                continue
            nl, nr = i + 1, parent_n - i - 1
            g = (nl * _gini(left_counts) + nr * _gini(right_counts)) / parent_n
            if g < best[2]:
                best = (f, 0.5 * (sv[i] + sv[i + 1]), g)
    return best


def _build_tree(X, y, n_class, max_depth, min_samples, rng):
    """Returns list of nodes: (feature, threshold, left, right)."""
    nodes = []

    def rec(idx, depth):
        node_id = len(nodes)
        nodes.append(None)
        ys = y[idx]
        counts = np.bincount(ys, minlength=n_class)
        majority = int(np.argmax(counts))
        if depth >= max_depth or len(idx) < min_samples or \
                counts.max() == len(idx):
            nodes[node_id] = (-(majority + 1), 0.0, 0, 0)
            return node_id
        n_feat = X.shape[1]
        k = max(1, int(np.sqrt(n_feat)))
        feat_subset = rng.choice(n_feat, size=k, replace=False)
        f, thr, g = _best_split(X[idx], ys, n_class, feat_subset, rng)
        if f is None:
            nodes[node_id] = (-(majority + 1), 0.0, 0, 0)
            return node_id
        mask = X[idx, f] <= thr
        li, ri = idx[mask], idx[~mask]
        if len(li) == 0 or len(ri) == 0:
            nodes[node_id] = (-(majority + 1), 0.0, 0, 0)
            return node_id
        l_id = rec(li, depth + 1)
        r_id = rec(ri, depth + 1)
        nodes[node_id] = (f, float(thr), l_id, r_id)
        return node_id

    rec(np.arange(len(y)), 0)
    return nodes


def _train_tree_nodes(X, y, n_class: int, tree_id: int, seed: int,
                      max_depth: int, min_samples: int):
    """Train ONE tree with its own rng stream seeded by (seed, tree_id),
    so tree t depends only on (data, seed, t)."""
    rng = np.random.default_rng((seed, tree_id))
    boot = rng.integers(0, len(y), size=len(y))
    return _build_tree(X[boot], y[boot], n_class, max_depth, min_samples,
                       rng)


def _pack_forest(all_nodes, n_class: int) -> Forest:
    """Node lists -> the paper's four flat (T, M) arrays, as CPU
    tensors."""
    M = max(len(n) for n in all_nodes)
    T = len(all_nodes)
    feature = np.full((T, M), -1, np.int32)
    threshold = np.zeros((T, M), np.float32)
    left = np.zeros((T, M), np.int32)
    right = np.zeros((T, M), np.int32)
    for t, nodes in enumerate(all_nodes):
        for i, (f, thr, l, r) in enumerate(nodes):
            feature[t, i] = f
            threshold[t, i] = thr
            left[t, i] = l
            right[t, i] = r
    return Forest(feature=torch.from_numpy(feature),
                  threshold=torch.from_numpy(threshold),
                  left=torch.from_numpy(left), right=torch.from_numpy(right),
                  n_class=n_class)


def train_forest(X, y, n_class: int, *, n_trees: int = 16, max_depth: int = 8,
                 min_samples: int = 2, seed: int = 0) -> Forest:
    """Train the forest on the host (offline numpy CART, like the paper's
    sklearn).  Returns CPU tensors; the estimator moves them to its
    device."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    all_nodes = [_train_tree_nodes(X, y, n_class, t, seed, max_depth,
                                   min_samples) for t in range(n_trees)]
    return _pack_forest(all_nodes, n_class)


def train_forest_sharded(X, y, n_class: int, n_shards: int, *,
                         n_trees: int = 16, max_depth: int = 8,
                         min_samples: int = 2, seed: int = 0) -> Forest:
    """The tree-parallel fit (Fig. 8's Independent-Tasks applied to
    training): the trees blocked over ``n_shards`` workers (ceil-divided,
    so a ragged count leaves the last workers a tree fewer or none), each
    block trained on its own, the blocks stitched back in tree order.
    Bit-equal to ``train_forest`` by the per-tree rng streams: training
    is host numpy (the paper trains offline), so the shard count only
    fixes the partition."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    per = -(-n_trees // n_shards)
    blocks = []
    for s in range(n_shards):
        blocks.extend(_train_tree_nodes(X, y, n_class, t, seed, max_depth,
                                        min_samples)
                      for t in range(s * per, min((s + 1) * per, n_trees)))
    return _pack_forest(blocks, n_class)
