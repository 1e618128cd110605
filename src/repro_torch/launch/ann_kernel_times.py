"""Device times of B2 (``ops.distance_argmin``) and B8 (``ops.adc_topk``)
at the shapes of the K-Means and IVF-PQ ANN paths, where one ANN
``classify`` bucket spends its time, and the host-clock fit and served
rates of those paths, for one checkout of the port.

    python3 src/repro_torch/launch/ann_kernel_times.py [--src DIR]

Imports ``repro_torch`` from DIR (default: the ``src`` directory this
file lies in), builds its kernels, and times through the public wrappers
only, so the same script times an older checkout: run it on two
checkouts in one command on one card (parent, change, change, parent) to
compare them.  The shapes:

  B2 fit      the first 262,144 of 266,240 seeded 256-class
              ``class_blobs`` rows (d = 21, seed 1; the last 4096 are the
              served queries) against their first 256 rows: every Lloyd step of
              the K-Means path's fit;
  B2 d=1      the first feature of those rows at 65,536 and 262,144
              rows against 256 centroids: the ANN fit's PQ codebook fits
              (65,536 training rows) and encodings (every row);
  B2 coarse   the first 65,536 rows at d = 21: the ANN fit's cell fit;
  B2 serve    1024 query rows of the same blobs: one K-Means bucket;
  B8          the ANN path's first 1024-query bucket (``kernel_cuts.
              ann_fit``: L = 32,768 candidates, m = 21, 256 codes,
              k = max(k, refine) = 128).

A B2 time at d = 1 or at the serving bucket is ``lm_kernel_times.
device_ms``: the replay of 20 calls captured as a CUDA graph, timed by
CUDA events, per call (device time, without the host's time to issue
each call; run this file as a script, so that its directory is on the
path).  B2 at the fit shapes and B8 are the mean of 20 (B8: 10) calls by
CUDA events after a warm call.  The ANN bucket is also split by CUDA
events into the steps of ``core/ann.ann_classify_batch``: probe (B1),
cell-id gather, LUT build, code gather, B8 (with B5 where the checkout
selects in a second kernel), refine, vote; five passes, the mean of
each.  Host clock: the ANN fit (K-Means cells and 21 codebooks, B2
throughout) and the K-Means fit in seconds, and ``classify`` of 4096
queries in 1024-query buckets after ``warmup_buckets`` for ANN and
K-Means, five calls a reading, three readings, queries from host memory
and from the card.  Where the checkout counts B2's or B8's routes
(``ROUTE_LAUNCHES`` of ``kernels/distance_argmin.py`` and
``kernels/ann.py``), the counts of the timed calls and of one ANN fit
are printed too.  Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

KM_ROWS, D, KM_K = 1 << 18, 21, 256
D1_ROWS = (1 << 16, 1 << 18)
COARSE_ROWS = 1 << 16
N_QUERIES, BUCKET = 4096, 1024
STEPS = ("probe", "cell_ids", "lut", "codes", "adc", "refine", "vote")


def served_qps(torch, engine, queries, calls: int = 5, readings: int = 3):
    """Queries a second of ``classify``, host clock, one per reading."""
    out = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            engine.classify(queries)
        torch.cuda.synchronize()
        out.append(calls * len(queries) / (time.perf_counter() - t0))
    return out


def ann_steps(torch, est, X, passes: int = 5):
    """Mean device ms of each step of ``ann_classify_batch`` on the
    bucket X, CUDA events between the steps; also checks that the steps
    give that function's answer."""
    from repro_torch.core.ann import (_masked_vote, ann_classify_batch,
                                      build_query_luts)
    from repro_torch.core.topk import topk_smallest_stable
    from repro_torch.kernels import dispatch
    p, k = est.params, est.k
    B = X.shape[0]
    want = max(k, est.refine)
    sums = dict.fromkeys(STEPS, 0.0)
    for i in range(passes + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in STEPS]
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        _, cells = dispatch.distance_topk(p.centroids, X, est.nprobe)
        ev[0].record()
        cand = p.cell_ids[cells.long()].reshape(B, -1)
        ev[1].record()
        qlut = build_query_luts(X, p.codebooks)
        ev[2].record()
        cand_codes = p.codes[cand.clamp(min=0).long()]
        ev[3].record()
        _, pos = dispatch.adc_topk(qlut, cand_codes, cand, want)
        ev[4].record()
        del cand_codes
        nbr = torch.gather(cand, 1, pos.long())
        rows = p.refs[nbr.clamp(min=0).long()].to(torch.float32)
        diff = rows - X.to(torch.float32)[:, None, :]
        dist = torch.where(nbr < 0, float("inf"),
                           torch.sum(diff * diff, dim=2))
        _, sel = topk_smallest_stable(dist, k, dim=1)
        nbr = torch.gather(nbr, 1, sel.long())
        ev[5].record()
        cls = _masked_vote(p.labels, nbr, p.n_class)
        ev[6].record()
        torch.cuda.synchronize()
        if i:   # the first pass is a warm one
            prev = ev0
            for name, e in zip(STEPS, ev):
                sums[name] += prev.elapsed_time(e)
                prev = e
    want_cls, want_nbr = ann_classify_batch(p, X, k, est.nprobe,
                                            refine=est.refine)
    if not (torch.equal(cls, want_cls) and torch.equal(nbr, want_nbr)):
        raise RuntimeError("the timed steps do not give ann_classify_batch's "
                           "answer")
    return {name: s / passes for name, s in sums.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory of the checkout to time")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import estimator as est_mod
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import NonNeuralServeEngine
    from kernel_cuts import ann_bucket, ann_fit, card, events_ms
    from lm_kernel_times import REPS, device_ms

    _build.build_all()
    dev = torch.device("cuda:0")
    routes = {}
    for name in ("distance_argmin", "ann"):
        try:
            mod = __import__(f"repro_torch.kernels.{name}",
                             fromlist=["ROUTE_LAUNCHES"])
            routes[name] = mod.ROUTE_LAUNCHES
        except (ImportError, AttributeError):
            pass

    def counts():
        return {name: dict(r) for name, r in routes.items()}

    X, y = class_blobs(n=KM_ROWS + N_QUERIES, d=D, n_class=KM_K, seed=1)
    A = torch.from_numpy(np.ascontiguousarray(X[:KM_ROWS])).to(dev)
    Xq = X[KM_ROWS:]
    C = A[:KM_K].clone()
    A1 = A[:, :1].contiguous()
    C1 = A1[:KM_K].clone()
    b2 = {"b2_fit": (A, C, False),
          "b2_coarse": (A[:COARSE_ROWS].contiguous(), C, False),
          "b2_serve": (torch.from_numpy(np.ascontiguousarray(
              Xq[:BUCKET])).to(dev), C, True)}
    for n in D1_ROWS:
        b2[f"b2_d1_{n}"] = (A1[:n].contiguous(), C1, True)
    ops.reset_launches()
    times = {}
    for key, (a, c, graph) in b2.items():
        v, i = ops.distance_argmin(a, c)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(v).all()) or \
                not bool(((i >= 0) & (i < c.shape[0])).all()):
            raise RuntimeError(f"{key}: output out of range")
        fn = (lambda a=a, c=c: ops.distance_argmin(a, c))
        times[key] = device_ms(fn) if graph else events_ms(fn, 20)
    b2_routes = counts()

    ops.reset_launches()
    est, queries, ann_fit_s = ann_fit(dev, N_QUERIES)
    fit_routes = dict(counts(), b2_launches=ops.LAUNCHES["distance_argmin"])
    qlut, codes, cand, want = ann_bucket(est, queries[:BUCKET])
    ops.reset_launches()
    out = ops.adc_topk(qlut, codes, cand, want)
    torch.cuda.synchronize()
    b8_launches = dict(ops.LAUNCHES)
    b8_routes = counts()
    if not bool((out[0] >= 0).all()):
        raise RuntimeError("B8: a negative ADC distance")
    times["b8_bucket"] = events_ms(
        lambda: ops.adc_topk(qlut, codes, cand, want), 10)
    del qlut, codes, cand, out
    steps = ann_steps(torch, est, queries[:BUCKET])

    qps = {}
    engine = NonNeuralServeEngine(est, max_batch=BUCKET, device=dev)
    engine.warmup_buckets(D)
    engine.classify(queries)
    qps["ann"] = dict(host=served_qps(torch, engine, queries.cpu().numpy()),
                      card=served_qps(torch, engine, queries))
    del engine, est
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = est_mod.make_fitted("kmeans", X[:KM_ROWS], None, n_groups=KM_K,
                             device=dev)
    torch.cuda.synchronize()
    km_fit_s = time.perf_counter() - t0
    engine = NonNeuralServeEngine(km, max_batch=BUCKET, device=dev)
    engine.warmup_buckets(D)
    engine.classify(Xq)
    qps["kmeans"] = dict(host=served_qps(torch, engine, Xq),
                         card=served_qps(torch, engine, torch.from_numpy(
                             np.ascontiguousarray(Xq)).to(dev)))
    print(json.dumps(dict(
        src=str(Path(args.src).resolve()), card=card(),
        torch=torch.__version__, reps=REPS, device_ms=times,
        ann_bucket_steps_ms=steps, fit_s=dict(ann=ann_fit_s,
                                              kmeans=km_fit_s),
        kmeans_n_iter=int(km.params.n_iter), routes=dict(
            b2_timed=b2_routes, ann_fit=fit_routes, b8_bucket=b8_routes),
        b8_launches=b8_launches, qps=qps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
