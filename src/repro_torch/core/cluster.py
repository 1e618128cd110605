"""The paper's parallel schemes over a mesh axis: the sharded fit/serve
layer.

Counterpart of the JAX package's ``core/cluster.py``.  There each
function is a ``shard_map`` body; here it is the same work as phases over
a single-process mesh (``launch/mesh.py``): a local step on every shard,
a collective between the shards' tensors (``core/collectives.py``), then
the merge.  Shard i of a row partition holds contiguous rows in shard
order, and every local step runs the port's dispatch registry on the
shard's own shapes, so selection per shard shape, ``path=``,
``REPRO_BACKEND`` and ``dispatch.measured_arm_ok`` hold per shard as on
one device.  On a card each shard runs the real kernels (B1-B8).

Two layers, as in the JAX package:

  * the single-query Fig. 4-8 ports (``knn_classify_shardmap``,
    ``kmeans_iteration_shardmap``, ``gnb_decision_shardmap``,
    ``matvec_shardmap``, ``forest_predict_shardmap``): the paper's
    pipelines with cores -> shards, for paper-fidelity tests; they
    partition one model axis statically and refuse a mesh that does not
    divide it;
  * the batched fit/serve layer behind ``Estimator.fit_sharded`` and the
    serving engine's ``mesh=``: serve arms by partition strategy
    (``query``: batch rows sharded against a replicated model, no merge;
    ``reference``: the model axis sharded, per-shard partials merged,
    the paper's OP3 master merge) and data-parallel fits (per-shard
    partial statistics summed in shard order into the global update).
    Serve outputs are per-row exact where the per-shard kernel's
    arithmetic does not depend on the batch's shape; the K-Means, GNB and
    GMM fit merges are tolerance-bounded against the one-device fits.

The query arms take their replicated operands either as tensors (copied
to each shard a call) or as lists of one tensor a shard, placed once by
the serving engine (``_params_for``); the kNN reference arm takes its
reference set as a tensor or as its row shards, cut once the same way.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import collectives as col
from repro_torch.core.collectives import on
from repro_torch.core.distribution import pad_to_multiple
from repro_torch.core.gnb import GNBModel, _log_gaussian
from repro_torch.core.kmeans import KMeansState
from repro_torch.core.knn import KNNModel, _vote, sq_distances
from repro_torch.core.topk import selection_topk_smallest, \
    topk_smallest_stable

# padding rows of a sharded kNN reference set (and of sharded centroids):
# far enough that a padded row never enters a top-k (squared distance
# >= ~1e34), near enough that ‖p‖² − 2 p·q + ‖q‖² stays finite in fp32
# up to d ~ 3000 features
_FAR = 1e17

_INT32_MAX = torch.iinfo(torch.int32).max


def _check_divisible(what: str, n: int, mesh, axis: str) -> int:
    """The single-query ports partition one model axis statically: a mesh
    that does not divide it fails naming the shape and the mesh."""
    c = mesh.shape[axis]
    if n % c != 0:
        raise ValueError(
            f"{what}={n} does not divide across the {c}-shard mesh axis "
            f"{axis!r} (mesh shape {dict(mesh.shape)}); use a mesh whose "
            f"{axis!r} size divides {what}, or the batched "
            f"*_batch_shardmap serving layer which pads ragged shapes")
    return c


def _quantized(policy, path: Optional[str]) -> bool:
    """Whether a call runs the int8 lattice arm: ``path="quant"``, or no
    path and the int8 policy or ``REPRO_BACKEND=quant``."""
    from repro_torch.kernels import dispatch
    if path is not None:
        return path == "quant"
    return (policy is not None and policy.quantized) or \
        dispatch.env_override() == "quant"


def _replica(params: NamedTuple, i: int, device: torch.device):
    """Shard i's copy of a params NamedTuple: a field placed as one tensor
    a shard gives its i-th, a tensor moves to ``device``, static fields
    pass through."""
    out = []
    for v in params:
        if isinstance(v, (list, tuple)):
            v = v[i]
        elif isinstance(v, torch.Tensor):
            v = v.to(device)
        out.append(v)
    return type(params)(*out)


# ---------------------------------------------------------------------------
# Single-query Fig. 4-8 ports (paper fidelity)
# ---------------------------------------------------------------------------


def knn_classify_shardmap(model: KNNModel, x: torch.Tensor, k: int, mesh,
                          axis: str = "data") -> torch.Tensor:
    """Fig. 6 over a mesh axis: OP1 local distances, OP2 local Selection
    Sort top-k, OP3 all-gather the c*k candidates with their k winners'
    labels (c*k labels, not the N-row label array) and merge, then vote.
    Returns the class ()."""
    N = model.A.shape[0]
    c = _check_divisible("N", N, mesh, axis)
    devs = mesh.shard_devices(axis)
    L = N // c
    out = x.device
    lvs, lls = [], []
    for i, d in enumerate(devs):
        with on(d):
            e = sq_distances(model.A[i * L:(i + 1) * L].to(d), x.to(d))
            lv, li = selection_topk_smallest(e, k)            # OP2 local
            lvs.append(lv)
            lls.append(model.labels[i * L:(i + 1) * L].to(d)[li.long()])
    all_v = col.all_gather(lvs, out).reshape(-1)              # c*k values
    all_l = col.all_gather(lls, out).reshape(-1)              # c*k labels
    _, gi = selection_topk_smallest(all_v, k)                 # OP3 merge
    votes = torch.bincount(all_l[gi.long()].long(), minlength=model.n_class)
    return torch.argmax(votes).to(torch.int32)


def kmeans_iteration_shardmap(A: torch.Tensor, centroids: torch.Tensor,
                              mesh, axis: str = "data"):
    """Fig. 7 over a mesh axis: OP1/OP2 local distances and argmin, OP3
    local accumulate, OP4 the psum (the global centroid update).  Returns
    (new centroids (k, d), assignments (N,) int32)."""
    from repro_torch.kernels import ref
    N = A.shape[0]
    c = _check_divisible("N", N, mesh, axis)
    devs = mesh.shard_devices(axis)
    L, k = N // c, centroids.shape[0]
    out = A.device
    sums, counts, ids = [], [], []
    for i, d in enumerate(devs):
        with on(d):
            a = A[i * L:(i + 1) * L].to(d)
            e = ref.pairwise_sq_dist(a, centroids.to(d))      # OP1
            idx = torch.argmin(e, dim=1)                      # OP2
            onehot = (idx[:, None] == torch.arange(k, device=d)).to(
                a.dtype)                                      # OP3 local
            sums.append(onehot.T @ a)
            counts.append(onehot.sum(dim=0))
            ids.append(idx.to(torch.int32))
    s, n = col.psum(sums, out), col.psum(counts, out)         # OP4 global
    new_c = torch.where(n[:, None] > 0, s / n.clamp(min=1.0)[:, None],
                        centroids)
    return new_c, col.gather_rows(ids, out)


def gnb_decision_shardmap(model: GNBModel, x: torch.Tensor, mesh,
                          axis: str = "data"):
    """Fig. 5 over a mesh axis, features sharded (the vertical split): OP1
    local partial log-likelihood sums, OP2 psum + prior, OP3 argmax.
    Returns (class (), joint log-likelihood (C,))."""
    d = model.mu.shape[1]
    c = _check_divisible("d", d, mesh, axis)
    devs = mesh.shard_devices(axis)
    L, out = d // c, x.device
    partial = []
    for i, dev in enumerate(devs):
        with on(dev):
            sl = slice(i * L, (i + 1) * L)
            partial.append(torch.sum(_log_gaussian(
                x[sl].to(dev)[None, :], model.mu[:, sl].to(dev),
                model.var[:, sl].to(dev)), dim=1))
    y = col.psum(partial, out) + model.log_prior              # OP2
    return torch.argmax(y).to(torch.int32), y                 # OP3


def matvec_shardmap(W, x, b, mesh, axis: str = "data"):
    """Fig. 4 (GEMM-based OP1/OP2) over a mesh axis: see
    ``distribution.two_phase_matvec_shardmap``."""
    from repro_torch.core.distribution import two_phase_matvec_shardmap
    return two_phase_matvec_shardmap(W, x, b, mesh, axis)


def forest_predict_shardmap(forest, x: torch.Tensor, mesh,
                            axis: str = "data"):
    """Fig. 8 over a mesh axis: trees statically sharded
    (Independent-Tasks), each shard's trees run and vote locally, and the
    vote histograms psum (the paper's critical section as a reduction).
    Returns (class (), votes (n_class,) int32)."""
    from repro_torch.core.random_forest import Forest, forest_classify_batch
    T = forest.feature.shape[0]
    c = _check_divisible("T", T, mesh, axis)
    devs = mesh.shard_devices(axis)
    L, out = T // c, x.device
    votes = []
    for i, d in enumerate(devs):
        with on(d):
            sl = slice(i * L, (i + 1) * L)
            f = Forest(feature=forest.feature[sl].to(d),
                       threshold=forest.threshold[sl].to(d),
                       left=forest.left[sl].to(d),
                       right=forest.right[sl].to(d), n_class=forest.n_class)
            votes.append(forest_classify_batch(f, x.to(d)[None])[1][0])
    v = col.psum(votes, out)                                  # vote combine
    return torch.argmax(v).to(torch.int32), v


# ---------------------------------------------------------------------------
# Batched sharded serve: the mesh arms behind kernels/dispatch.py
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, c: int, value: float = 0.0):
    """Pad axis 0 to a multiple of the shard count; returns (padded, n)."""
    return pad_to_multiple(x, c, axis=0, value=value)


def _lexsort(ci: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """Per row, the order by (cv, ci): ``jnp.lexsort((ci, cv))``."""
    o = torch.argsort(ci, dim=1, stable=True)
    return o.gather(1, torch.argsort(cv.gather(1, o), dim=1, stable=True))


def _butterfly_topk_merge(lv: List[torch.Tensor], li: List[torch.Tensor],
                          k: int, devices: Sequence[torch.device]):
    """Hierarchical OP3: the XOR-partner butterfly all-reduce of the
    per-shard (value, global index) candidates, log2(c) rounds each moving
    k per query, where the gather merge moves all c·kl at once.  Every
    round keeps the k smallest by (value, global index), the tie order the
    flat stable merge over shard-major candidates resolves to (shard
    blocks are contiguous ascending row ranges), so both merges are bit
    for bit equal.  Returns every shard's (values, indices)."""
    c, kl = len(lv), lv[0].shape[1]
    if kl < k:
        # a shard holds at most its chunk's candidates: +inf sentinels
        # fill the merge slots and never displace a real candidate
        lv = [torch.nn.functional.pad(v, (0, k - kl), value=math.inf)
              for v in lv]
        li = [torch.nn.functional.pad(i, (0, k - kl), value=_INT32_MAX)
              for i in li]
    for r in range(c.bit_length() - 1):
        stride = 1 << r
        perm = [(i, i ^ stride) for i in range(c)]
        pv = col.ppermute(lv, perm, devices)
        pi = col.ppermute(li, perm, devices)
        nv, ni = [], []
        for s, d in enumerate(devices):
            with on(d):
                cv = torch.cat([lv[s], pv[s]], dim=1)
                ci = torch.cat([li[s], pi[s]], dim=1)
                order = _lexsort(ci, cv)[:, :k]
                nv.append(cv.gather(1, order))
                ni.append(ci.gather(1, order))
        lv, li = nv, ni
    return lv, li


def distance_topk_shardmap(a, qs: torch.Tensor, k: int, mesh,
                           axis: str = "data", *, policy=None,
                           path: Optional[str] = None,
                           merge: Optional[str] = None):
    """Fig. 6 OP1+OP2 over a sharded reference set, for a query batch.

    ``a`` (N, d) is row-sharded; every shard runs the registry-selected
    distance -> top-k arm over its rows for all Q queries, then the
    per-shard candidates merge (OP3).  ``merge``: ``"gather"`` gathers the
    c·kl candidates and keeps the k smallest (stable); ``"tree"`` is the
    butterfly merge (log2(c) rounds of k a query); None takes ``tree`` on
    power-of-two meshes.  Both equal the one-device
    ``dispatch.distance_topk`` bit for bit where the per-shard arm's
    distances do not depend on the shard's row count.  Returns (values
    (Q, k), indices (Q, k) int32) on the queries' device.

    ``a`` should come padded to a multiple of the shard count with
    ``_FAR`` rows and cut once (``KNNEstimator.fit_sharded`` and the
    engine's placement do that): a tensor is padded and cut per call."""
    if _quantized(policy, path):
        raise NotImplementedError(
            "the reference-sharded kNN arm has no quant tier: the int8 "
            "lattice derives from the reference operand, which this "
            "partition chunks per shard (and any _FAR pad row saturates a "
            "per-shard lattice, zeroing every real feature) -- serve "
            "quantized with the query strategy (DESIGN.md section 9)")
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    c = len(devs)
    parts = col.as_row_shards(a, devs, value=_FAR)
    chunk_len = int(parts[0].shape[0])
    if k > chunk_len * c:
        raise ValueError(f"k={k} exceeds the {chunk_len * c} reference rows")
    # a shard holds at most its chunk, so clamping its candidate count
    # loses nothing: c*kl >= N >= k candidates survive
    kl = min(k, chunk_len)
    if merge is None:
        merge = "tree" if c > 1 and (c & (c - 1)) == 0 else "gather"
    if merge not in ("gather", "tree"):
        raise ValueError(f"merge={merge!r} is not 'gather' or 'tree'")
    if merge == "tree" and c & (c - 1):
        raise ValueError(
            f"merge='tree' needs a power-of-two shard count for the "
            f"butterfly exchange; mesh axis {axis!r} has {c} shards — "
            f"use merge='gather'")
    lv, li = [], []
    for i, (part, d) in enumerate(zip(parts, devs)):
        with on(d):
            v, idx = dispatch.distance_topk(part, qs.to(d), kl, path=path,
                                            policy=policy)
            lv.append(v)
            li.append(idx + i * chunk_len)
    out = qs.device
    if merge == "tree":
        mv, mi = _butterfly_topk_merge(lv, li, k, devs)
        return mv[0].to(out), mi[0].to(out)
    Q = qs.shape[0]
    cand_v = col.all_gather(lv, out).transpose(0, 1).reshape(Q, c * kl)
    cand_i = col.all_gather(li, out).transpose(0, 1).reshape(Q, c * kl)
    gv, gp = topk_smallest_stable(cand_v, k, dim=1)           # OP3 merge
    return gv, cand_i.gather(1, gp.long())


def distance_topk_query_shardmap(a, qs: torch.Tensor, k: int, mesh,
                                 axis: str = "data", *, policy=None,
                                 path: Optional[str] = None):
    """Fig. 6 OP1+OP2 with the query rows sharded and the reference set
    replicated on every shard (PULP-NN's weights-in-local-memory layout):
    no merge collective.  Exact per row for every arm, int8 included (the
    lattice derives from the replicated reference).  Any Q."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    reps = col.as_replicas(a, devs)
    q_parts, Q = col.shard_rows(qs, devs)
    vals, idx = [], []
    for a_r, q, d in zip(reps, q_parts, devs):
        with on(d):
            v, i = dispatch.distance_topk(a_r, q, k, path=path,
                                          policy=policy)
            vals.append(v)
            idx.append(i)
    out = qs.device
    return col.gather_rows(vals, out)[:Q], col.gather_rows(idx, out)[:Q]


def adc_topk_query_shardmap(qlut, codes, cand_ids, k: int, mesh,
                            axis: str = "data", *, policy=None,
                            path: Optional[str] = None):
    """IVF-PQ ADC scoring with the query rows sharded: every operand (the
    per-query LUTs, candidate codes and ids) is indexed by query row, so
    each shard runs the whole op on its rows, no merge.  Exact per row;
    any Q (pad ids are -1, the kernel's invalid candidate)."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    lp, Q = col.shard_rows(qlut, devs, value=0)
    cp, _ = col.shard_rows(codes, devs, value=0)
    ip, _ = col.shard_rows(cand_ids, devs, value=-1)
    vals, pos = [], []
    for lut, cd, ids, d in zip(lp, cp, ip, devs):
        with on(d):
            v, p = dispatch.adc_topk(lut, cd, ids, k, path=path,
                                     policy=policy)
            vals.append(v)
            pos.append(p)
    out = qlut.device
    return col.gather_rows(vals, out)[:Q], col.gather_rows(pos, out)[:Q]


def row_sharded_batch_fn(fn: Callable, mesh, axis: str = "data"
                         ) -> Callable:
    """Lift any per-row-independent ``(params, X) -> (classes, aux)`` batch
    fn into the query strategy: the batch rows sharded, the params
    replicated (a field placed as one tensor a shard takes its shard's),
    the fn run unchanged on each shard.  This is how the int8 tier and
    ANN serve sharded: their lattices and indexes derive from the params,
    never the batch.  Any batch size (pad rows are sliced off)."""
    devs = mesh.shard_devices(axis)

    def sharded_fn(params, X):
        parts, B = col.shard_rows(X, devs)
        cls, aux = [], []
        for i, (x, d) in enumerate(zip(parts, devs)):
            with on(d):
                c_, a_ = fn(_replica(params, i, d), x)
                cls.append(c_)
                aux.append(a_)
        out = X.device
        return col.gather_rows(cls, out)[:B], col.gather_rows(aux, out)[:B]

    return sharded_fn


def distance_argmin_shardmap(a: torch.Tensor, centroids, mesh,
                             axis: str = "data", *, policy=None,
                             path: Optional[str] = None):
    """Fig. 7 OP1+OP2 with the data rows sharded and the centroids
    replicated.  Returns (min squared distance (N,), nearest id (N,)
    int32); any N."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    reps = col.as_replicas(centroids, devs)
    parts, N = col.shard_rows(a, devs)
    dist, ids = [], []
    for x, cent, d in zip(parts, reps, devs):
        with on(d):
            v, i = dispatch.distance_argmin(x, cent, path=path,
                                            policy=policy)
            dist.append(v)
            ids.append(i)
    out = a.device
    return col.gather_rows(dist, out)[:N], col.gather_rows(ids, out)[:N]


def distance_argmin_centroid_shardmap(a: torch.Tensor, centroids, mesh,
                                      axis: str = "data", *, policy=None,
                                      path: Optional[str] = None):
    """Fig. 7 OP1+OP2 with the centroids sharded and every row replicated,
    the model-partition dual of ``distance_argmin_shardmap``.  The merge
    moves the c per-shard minima a row; ties go to the first shard, the
    smallest global centroid id, as the one-device argmin takes them
    (centroid blocks are contiguous ascending ranges).  Assignments are
    exact away from exact distance ties; an arm whose reduction order
    depends on the centroid count may move a distance by an ulp.  Under
    the int8 arm each shard's lattice derives from its centroids only
    (lattice-approximate: the auto strategy never picks it quantized)."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    parts = col.shard_rows(centroids, devs, value=_FAR)[0]
    chunk_len = int(parts[0].shape[0])
    d_loc, i_loc = [], []
    for j, (cent, d) in enumerate(zip(parts, devs)):
        with on(d):
            v, i = dispatch.distance_argmin(a.to(d), cent, path=path,
                                            policy=policy)
            d_loc.append(v)
            i_loc.append(i + j * chunk_len)
    out = a.device
    all_d = col.all_gather(d_loc, out)                        # (c, B) minima
    all_i = col.all_gather(i_loc, out)
    w = torch.argmin(all_d, dim=0, keepdim=True)              # first wins
    return all_d.gather(0, w)[0], all_i.gather(0, w)[0]


def gnb_scores_shardmap(X: torch.Tensor, mu, var, log_prior, mesh,
                        axis: str = "data", *, policy=None,
                        path: Optional[str] = None) -> torch.Tensor:
    """Fig. 5 OP1+OP2 for a query batch with the query rows sharded (the
    single-query ``gnb_decision_shardmap`` shards features, the paper's
    vertical split; serving shards the independent axis).  Returns the
    (B, C) joint log-likelihood."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    mus, vars_, lps = (col.as_replicas(t, devs) for t in (mu, var,
                                                          log_prior))
    parts, B = col.shard_rows(X, devs)
    scores = []
    for x, m, v, lp, d in zip(parts, mus, vars_, lps, devs):
        with on(d):
            scores.append(dispatch.gnb_scores(x, m, v, lp, path=path,
                                              policy=policy))
    return col.gather_rows(scores, X.device)[:B]


def gnb_scores_class_shardmap(X: torch.Tensor, mu, var, log_prior, mesh,
                              axis: str = "data", *, policy=None,
                              path: Optional[str] = None) -> torch.Tensor:
    """Fig. 5 OP1+OP2 with the classes sharded and the query rows
    replicated.  A class's score column does not depend on the others,
    so the gathered (B, C) matrix is the one-device op's up to the arm's
    schedule (an ulp where its reduction depends on the class count;
    classes exact away from exact score ties).  Ragged class counts pad
    with zero-mean unit-variance classes whose columns are sliced off.
    The int8 arm's lattice derives from each shard's classes (auto never
    picks this partition quantized)."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    C = mu.shape[0]
    mus = col.shard_rows(mu, devs)[0]
    vars_ = col.shard_rows(var, devs, value=1.0)[0]   # finite pad scores
    lps = col.shard_rows(log_prior, devs)[0]
    parts = []
    for m, v, lp, d in zip(mus, vars_, lps, devs):
        with on(d):
            parts.append(dispatch.gnb_scores(X.to(d), m, v, lp, path=path,
                                             policy=policy))  # (B, C/c)
    out = X.device
    s = col.all_gather(parts, out)                            # (c, B, C/c)
    return s.transpose(0, 1).reshape(X.shape[0], -1)[:, :C]


def gmm_responsibilities_shardmap(mu, var, log_pi, X: torch.Tensor, mesh,
                                  axis: str = "data", *, policy=None,
                                  path: Optional[str] = None,
                                  n_cores: int = 8):
    """GMM E-step with the query rows sharded.  Returns (log_resp (B, k),
    None): the one-device op's mean log-likelihood is over its rows,
    padding included, so no sharded caller reads it (serving drops it,
    the sharded fit uses ``_gmm_loglik_sharded``)."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    mus, vars_, lps = (col.as_replicas(t, devs) for t in (mu, var, log_pi))
    parts, B = col.shard_rows(X, devs)
    lrs = []
    for x, m, v, lp, d in zip(parts, mus, vars_, lps, devs):
        with on(d):
            lr, _ = dispatch.gmm_responsibilities(m, v, lp, x, path=path,
                                                  policy=policy,
                                                  n_cores=n_cores)
            lrs.append(lr)
    return col.gather_rows(lrs, X.device)[:B], None


def _gmm_log_joint(x, mu, var, log_pi):
    from repro_torch.core.gmm import _log_gauss
    return _log_gauss(x, mu, var) + log_pi[None]


def gmm_responsibilities_comp_shardmap(mu, var, log_pi, X: torch.Tensor,
                                       mesh, axis: str = "data", *,
                                       policy=None,
                                       path: Optional[str] = None,
                                       n_cores: int = 8):
    """GMM E-step with the mixture components sharded: each shard computes
    the joint log-density columns of its components through the arm the
    one-device dispatch takes at these shapes (``blocked``: B3; ``quant``:
    the affine scores; else the GEMM-identity joint), the (B, k) joint is
    gathered, and the per-row logsumexp runs over the real components.
    Not bit-equal to the one-device E-step: the component chunk changes
    the products' shapes (float tolerance; classes agree away from exact
    ties).  The int8 arm's lattice derives from each shard's components
    (auto never picks this partition quantized).  Returns (log_resp
    (B, k), None), the query arm's contract."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ops as _ops
    from repro_torch.kernels import quantized as qk
    devs = mesh.shard_devices(axis)
    K = mu.shape[0]
    mus = col.shard_rows(mu, devs)[0]
    vars_ = col.shard_rows(var, devs, value=1.0)[0]
    lps = col.shard_rows(log_pi, devs, value=-math.inf)[0]
    arm = dispatch.resolve("gmm", "responsibilities", path=path,
                           policy=policy, device=X.device, B=X.shape[0],
                           d=X.shape[1], k=K).name

    def joint_of(x, mu_k, var_k, lp_k):
        if arm == "blocked":
            return _ops.gnb_scores_batch(x, mu_k, var_k, lp_k)
        if arm == "quant":
            xq, quad, lin, const = dispatch._gauss_lattice(x, mu_k, var_k)
            return qk.affine_scores(xq, quad, lin, const + lp_k)
        return _gmm_log_joint(x, mu_k, var_k, lp_k)

    parts = []
    for m, v, lp, d in zip(mus, vars_, lps, devs):
        with on(d):
            parts.append(joint_of(X.to(d), m, v, lp))         # (B, k/c)
    out = X.device
    joint = col.all_gather(parts, out).transpose(0, 1).reshape(
        X.shape[0], -1)[:, :K]
    return joint - torch.logsumexp(joint, dim=1, keepdim=True), None


def _pad_forest(forest, c: int):
    """The forest's trees padded to a multiple of ``c`` with one-leaf
    sentinel trees voting one bin past the real classes; returns (padded
    forest with ``n_class + 1`` bins, or the forest as it is, n_class)."""
    from repro_torch.core.random_forest import Forest
    nc = forest.n_class
    pad = (-forest.feature.shape[0]) % c
    if not pad:
        return forest, nc
    M = forest.feature.shape[1]

    def grow(t, fill):
        return torch.cat([t, torch.full((pad, M), fill, dtype=t.dtype,
                                        device=t.device)])

    return Forest(feature=grow(forest.feature, -nc - 1),
                  threshold=grow(forest.threshold, 0),
                  left=grow(forest.left, 0), right=grow(forest.right, 0),
                  n_class=nc + 1), nc


def forest_votes_shardmap(forest, X: torch.Tensor, mesh, axis: str = "data",
                          *, policy=None, path: Optional[str] = None,
                          depth: Optional[int] = None):
    """Fig. 8 for a query batch with the query rows sharded (the
    single-query ``forest_predict_shardmap`` shards trees; both are
    Independent-Tasks).  ``depth``: the forest's longest root-to-leaf
    path, if known.  Returns (classes (B,) int32, votes (B, n_class)
    int32), exact per row."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    parts, B = col.shard_rows(X, devs)
    cls, votes = [], []
    for i, (x, d) in enumerate(zip(parts, devs)):
        with on(d):
            c_, v_ = dispatch.forest_votes(_replica(forest, i, d), x,
                                           policy=policy, path=path,
                                           depth=depth)
            cls.append(c_)
            votes.append(v_)
    out = X.device
    return col.gather_rows(cls, out)[:B], col.gather_rows(votes, out)[:B]


def forest_votes_tree_shardmap(forest, X: torch.Tensor, mesh,
                               axis: str = "data", *, policy=None,
                               path: Optional[str] = None,
                               depth: Optional[int] = None):
    """Fig. 8 with the trees sharded (the paper's Independent-Tasks axis)
    for a query batch: each shard runs its trees over every row and the
    integer vote histograms psum, exact (integer sums commute).  A ragged
    tree count pads with one-leaf sentinel trees voting one bin past the
    real classes, dropped before the argmax.  The int8 arm's threshold
    lattice derives from each shard's trees (auto never picks this
    partition quantized)."""
    from repro_torch.core.random_forest import Forest
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    padded, nc = _pad_forest(forest, len(devs))
    L = padded.feature.shape[0] // len(devs)
    votes = []
    for i, d in enumerate(devs):
        with on(d):
            # the sentinel bin stays visible until the merge drops it
            f = Forest(*(getattr(padded, name)[i * L:(i + 1) * L].to(d)
                         for name in ("feature", "threshold", "left",
                                      "right")), n_class=nc + 1)
            _, v = dispatch.forest_votes(f, X.to(d), policy=policy,
                                         path=path, depth=depth)
            votes.append(v)
    v = col.psum(votes, X.device)[:, :nc]                    # exact combine
    return torch.argmax(v, dim=1).to(torch.int32), v


def knn_classify_batch_shardmap(model: KNNModel, X: torch.Tensor, k: int,
                                mesh, axis: str = "data", *, policy=None,
                                path: Optional[str] = None,
                                strategy: str = "reference",
                                merge: Optional[str] = None):
    """Batched Fig. 6 over a mesh, by strategy.  ``"reference"``: the
    shard-resident reference set, the per-shard distance -> top-k arm, the
    candidate merge (gather or butterfly, ``distance_topk_shardmap``),
    then the vote.  ``"query"``: the query rows sharded against the
    replicated reference, votes in-shard, no merge.  Returns (classes
    (Q,) int32, neighbour indices (Q, k) int32)."""
    if strategy == "query":
        from repro_torch.kernels import dispatch
        devs = mesh.shard_devices(axis)
        As = col.as_replicas(model.A, devs)
        labels = col.as_replicas(model.labels, devs)
        parts, B = col.shard_rows(X, devs)
        cls, nbs = [], []
        for a_r, lab, q, d in zip(As, labels, parts, devs):
            with on(d):
                _, nb = dispatch.distance_topk(a_r, q, k, path=path,
                                               policy=policy)
                cls.append(_vote(lab, nb, model.n_class))
                nbs.append(nb)
        out = X.device
        return col.gather_rows(cls, out)[:B], col.gather_rows(nbs, out)[:B]
    if strategy != "reference":
        raise ValueError(f"strategy={strategy!r} is not 'query' or "
                         "'reference'")
    _, nbr = distance_topk_shardmap(model.A, X, k, mesh, axis, policy=policy,
                                    path=path, merge=merge)
    return _vote(model.labels.to(X.device), nbr, model.n_class), nbr


# ---------------------------------------------------------------------------
# Sharded fits: per-shard partial statistics, summed into the global update
# ---------------------------------------------------------------------------


def _valid_shards(n: int, devs, dtype=torch.float32):
    """Per-shard 1/0 masks of the real rows of an n-row operand padded to
    a multiple of the shard count."""
    c = len(devs)
    n_pad = n + (-n) % c
    valid = (torch.arange(n_pad) < n).to(dtype)
    return col.shard_rows(valid, devs)[0]


def kmeans_iteration_sharded(A, centroids: torch.Tensor, valid, mesh,
                             axis: str = "data"):
    """One Lloyd iteration with the data rows sharded: OP1/OP2 the
    per-shard distance -> argmin arm, OP3 per-shard partial (sums,
    counts), OP4 their psum (Fig. 7 with cores -> shards).  ``A`` and
    ``valid`` (1 on real rows, 0 on padding) are tensors padded to a
    multiple of the shard count, or their row shards.  Returns (new
    centroids (k, d) on the centroids' device, assignments of the padded
    rows (int32))."""
    from repro_torch.kernels import dispatch
    devs = mesh.shard_devices(axis)
    parts = col.as_row_shards(A, devs)
    vparts = col.as_row_shards(valid, devs)
    k, out = centroids.shape[0], centroids.device
    sums, counts, ids = [], [], []
    for a, v, d in zip(parts, vparts, devs):
        with on(d):
            _, idx = dispatch.distance_argmin(a, centroids.to(d))  # OP1+2
            onehot = (idx[:, None].long() == torch.arange(k, device=d)).to(
                a.dtype) * v[:, None]                          # OP3 local
            sums.append(onehot.T @ a)
            counts.append(onehot.sum(dim=0))
            ids.append(idx)
    s, n = col.psum(sums, out), col.psum(counts, out)          # OP4 global
    new_c = torch.where(n[:, None] > 0, s / n.clamp(min=1.0)[:, None],
                        centroids)
    return new_c, col.gather_rows(ids, out)


def kmeans_fit_shardmap(A: torch.Tensor, k: int, mesh, axis: str = "data",
                        *, threshold: float = 1e-4, max_iters: int = 100):
    """The sharded Lloyd fit: ``kmeans_fit``'s loop with every iteration's
    OP3/OP4 accumulate as per-shard partial sums and a psum.
    Tolerance-bounded against the one-device fit (the psum adds the
    partial sums in another order).  Returns (KMeansState, assignments
    (N,))."""
    A = A.to(torch.float32)
    devs = mesh.shard_devices(axis)
    parts, N = col.shard_rows(A, devs)
    valid = _valid_shards(N, devs, A.dtype)
    cent = A[:k].clone()
    shift, n_iter = torch.tensor(math.inf, device=A.device), 0
    while float(shift) > threshold and n_iter < max_iters:
        new_c, _ = kmeans_iteration_sharded(parts, cent, valid, mesh, axis)
        shift = torch.max(torch.linalg.vector_norm(new_c - cent, dim=1))
        cent, n_iter = new_c, n_iter + 1
    _, ids = kmeans_iteration_sharded(parts, cent, valid, mesh, axis)
    state = KMeansState(centroids=cent, shift=shift,
                        n_iter=torch.tensor(n_iter, dtype=torch.int32,
                                            device=A.device))
    return state, ids[:N]


def gnb_fit_shardmap(X: torch.Tensor, y: torch.Tensor, n_class: int, mesh,
                     axis: str = "data", *,
                     var_smoothing: float = 1e-6) -> GNBModel:
    """The sharded GNB fit: each shard accumulates per-class moment
    partials (counts, Σx, Σx²) and the per-feature moments of the shared
    smoothing scale over its rows (Fig. 7's OP3 accumulate applied to
    sufficient statistics); one psum merges them into the M-step.
    Tolerance-bounded against ``fit_gnb`` (the sums' order, and the
    smoothing term's E[x²] − E[x]² for the population variance)."""
    X = X.to(torch.float32)
    devs = mesh.shard_devices(axis)
    xs, N = col.shard_rows(X, devs)
    ys, _ = col.shard_rows(y, devs)
    valid = _valid_shards(N, devs, X.dtype)
    out = X.device
    parts = {key: [] for key in ("counts", "s1", "s2", "f1", "f2")}
    for x, yy, v, d in zip(xs, ys, valid, devs):
        with on(d):
            onehot = (yy.long()[:, None] == torch.arange(
                n_class, device=d)).to(x.dtype) * v[:, None]
            parts["counts"].append(onehot.sum(dim=0))
            parts["s1"].append(onehot.T @ x)
            parts["s2"].append(onehot.T @ (x * x))
            parts["f1"].append(torch.sum(x * v[:, None], dim=0))
            parts["f2"].append(torch.sum(x * x * v[:, None], dim=0))
    counts, s1, s2, f1, f2 = (col.psum(parts[key], out) for key in
                              ("counts", "s1", "s2", "f1", "f2"))
    mu = s1 / counts[:, None]
    var = s2 / counts[:, None] - mu ** 2
    gvar = f2 / N - (f1 / N) ** 2
    var = var + var_smoothing * torch.max(gvar)
    return GNBModel(mu=mu, var=var, log_prior=torch.log(counts / N))


def _gmm_em_iteration_sharded(A, valid, mu, var, log_pi, N: int, mesh,
                              axis: str = "data", *,
                              var_floor: float = 1e-6):
    """One sharded EM iteration: the per-shard E-step (rows independent),
    then the M-step's soft-moment accumulate as per-shard partials and a
    psum (Fig. 7 OP3/OP4 with responsibilities).  ``A``/``valid`` as in
    ``kmeans_iteration_sharded``.  Returns the new (mu, var, log_pi)."""
    devs = mesh.shard_devices(axis)
    parts = col.as_row_shards(A, devs)
    vparts = col.as_row_shards(valid, devs)
    out = mu.device
    nks, s1s, s2s = [], [], []
    for a, v, d in zip(parts, vparts, devs):
        with on(d):
            joint = _gmm_log_joint(a, mu.to(d), var.to(d), log_pi.to(d))
            lr = joint - torch.logsumexp(joint, dim=1, keepdim=True)
            r = torch.exp(lr) * v[:, None]
            nks.append(r.sum(dim=0))
            s1s.append(r.T @ a)
            s2s.append(r.T @ (a * a))
    nk, s1, s2 = col.psum(nks, out), col.psum(s1s, out), col.psum(s2s, out)
    safe = torch.clamp(nk[:, None], min=1e-9)
    mu2 = s1 / safe
    var2 = torch.clamp(s2 / safe - mu2 * mu2, min=var_floor)
    log_pi2 = torch.log(torch.clamp(nk / N, min=1e-12))
    return mu2, var2, log_pi2


def _gmm_loglik_sharded(A, valid, mu, var, log_pi, N: int, mesh,
                        axis: str = "data") -> torch.Tensor:
    """Mean data log-likelihood over the real rows, psum'd."""
    devs = mesh.shard_devices(axis)
    parts = col.as_row_shards(A, devs)
    vparts = col.as_row_shards(valid, devs)
    sums = []
    for a, v, d in zip(parts, vparts, devs):
        with on(d):
            ll = torch.logsumexp(_gmm_log_joint(a, mu.to(d), var.to(d),
                                                log_pi.to(d)), dim=1)
            sums.append(torch.sum(ll * v))
    return col.psum(sums, mu.device) / N


def gmm_fit_shardmap(A: torch.Tensor, k: int, mesh, axis: str = "data", *,
                     max_iters: int = 100, tol: float = 1e-4):
    """The sharded EM fit, ``gmm_fit``'s loop: a warm-up iteration, then
    iterate while the mean log-likelihood improves by more than ``tol``.
    E-step rows are exact; the M-step's moment psum is tolerance-bounded.
    Returns (GMMState, responsibilities (N, k))."""
    from repro_torch.core.gmm import GMMState
    A = A.to(torch.float32)
    devs = mesh.shard_devices(axis)
    parts, N = col.shard_rows(A, devs)
    valid = _valid_shards(N, devs, A.dtype)
    d, dev = A.shape[1], A.device
    mu, var = A[:k].clone(), torch.ones((k, d), device=dev)
    log_pi = torch.full((k,), -math.log(k), device=dev)
    prev_ll = ll = torch.tensor(-math.inf, device=dev)
    n_iter = 0
    while n_iter < max_iters:
        mu, var, log_pi = _gmm_em_iteration_sharded(parts, valid, mu, var,
                                                    log_pi, N, mesh, axis)
        prev_ll, ll = ll, _gmm_loglik_sharded(parts, valid, mu, var, log_pi,
                                              N, mesh, axis)
        n_iter += 1
        # gmm_fit's condition: stop once the improvement is <= tol (the
        # warm-up iteration always runs; a NaN improvement stops too)
        if n_iter > 1 and not (float(ll - prev_ll) > tol):
            break
    lr, _ = gmm_responsibilities_shardmap(mu, var, log_pi, A, mesh, axis)
    state = GMMState(mu=mu, var=var, log_pi=log_pi, log_lik=ll,
                     n_iter=torch.tensor(n_iter, dtype=torch.int32,
                                         device=dev))
    return state, torch.exp(lr)
