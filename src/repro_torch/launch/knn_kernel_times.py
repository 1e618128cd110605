"""Device times of B1 (``ops.distance_topk``), B6
(``ops.distance_topk_q8``), B4 (``ops.pairwise_sq_dist``) and B5
(``ops.topk_smallest``) at the shapes of the kNN serving paths, and the
host-clock served rate of those paths, for one checkout of the port.

    python3 src/repro_torch/launch/knn_kernel_times.py [--src DIR]

Imports ``repro_torch`` from DIR (default: the ``src`` directory this
file lies in), builds its kernels, and times through the public wrappers
only, so the same script times an older checkout: run it on two
checkouts in one command on one card (parent, change, change, parent) to
compare them.  The shapes:

  B1 kNN      2^20 seeded ``class_blobs`` rows (d = 21, 3 classes)
              against one 1024-query bucket, k = 4;
  B1 ANN      the IVF probe: 256 cell centres against 1024 queries,
              k = 16 (centres and queries are seeded 256-class blob rows
              in place of a K-Means fit; the probe's shape is what is
              timed);
  B6 kNN      the kNN rows and bucket on the int8 lattice (per-feature
              scales from the rows), k = 4;
  B4 kNN      the kNN rows against the bucket, column-major: the blocked
              arm's (1024, 2^20) matrix at k = 64;
  B5 kNN      that matrix's rows (B4's transpose, in place), k = 64;
  B5 ANN i32  the int32 ADC distance matrix of the IVF-PQ ANN path's
              first bucket, k = max(k, refine) = 128: the ANN of
              ``chip_smoke.py`` (``kernel_cuts.ann_fit``: 2^18 seeded
              256-class ``class_blobs`` rows, 256 cells, m = 21, 256
              codes, k = 10, refine = 128, nprobe = 16), the bucket's 1024
              queries probed by B1 and their candidates' ADC distances
              computed by B8's matrix kernel (``kernels/ann.launch_dist``),
              so the rows hold the path's ties and list padding;
  B4 K-Means  the first 262,144 kNN rows against 256 of them, row-major
              (the K-Means fit's blocked shape).

A B1 or B6 time is ``lm_kernel_times.device_ms``: the replay of 20 calls
captured as a CUDA graph, timed by CUDA events, per call (device time,
without the host's time to issue the call); run this file as a script,
so that its directory, which holds ``lm_kernel_times.py``, is on the
path.  A B4 or B5 time is the mean of 10 calls by CUDA events after a
warm call (their outputs at the kNN shape are 4.29 GB, too large to keep
20 of in a graph's pool; each call takes far longer than the host's time
to issue it; ``kernel_cuts.events_ms``).  The served rate is
``NonNeuralServeEngine.classify`` of 4096 queries in 1024-query buckets
after ``warmup_buckets``, host clock to a synchronize, five calls a
reading and three readings, queries from host memory and from the card,
for the fp32 engine (B1), the int8 engine (B6) over the same fitted kNN,
and the fp32 engine of a kNN fitted with k = 64 (the blocked arm: B4
then B5).  Where the checkout counts its kernels' routes
(``ROUTE_LAUNCHES`` in ``kernels/distance_topk.py``,
``kernels/quantized.py``, ``kernels/pairwise_sq_dist.py`` and
``kernels/topk_select.py``), the counts of the timed calls are printed
too.
Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

N_ROWS, D, CLASSES, K = 1 << 20, 21, 3, 4
N_QUERIES, BUCKET = 4096, 1024
ANN_CELLS, ANN_CLASSES, ANN_K = 256, 256, 16
BLOCKED_K = 64
KMEANS_ROWS, KMEANS_K = 1 << 18, 256


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
    from repro_torch.kernels import distance_topk as dt
    from repro_torch.kernels import pairwise_sq_dist as pd
    from repro_torch.kernels import ann as kann
    from repro_torch.kernels import quantized as qk
    from repro_torch.kernels import topk_select as ts
    from repro_torch.serving import NonNeuralServeEngine
    from kernel_cuts import ann_bucket, ann_fit, card, events_ms
    from lm_kernel_times import REPS, device_ms

    _build.build_all()
    dev = torch.device("cuda:0")

    def on_card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    X, y = class_blobs(n=N_ROWS + N_QUERIES, d=D, n_class=CLASSES, seed=0)
    Xtr, ytr, Xq = X[:N_ROWS], y[:N_ROWS], X[N_ROWS:]
    A, Cq = on_card(Xtr), on_card(Xq[:BUCKET])
    Xa, _ = class_blobs(n=ANN_CELLS + BUCKET, d=D, n_class=ANN_CLASSES,
                        seed=3)
    cells, Qa = on_card(Xa[:ANN_CELLS]), on_card(Xa[ANN_CELLS:])
    scale = qk.feature_scales(A.abs().amax(0))
    A8, C8 = qk.quantize_rows(A, scale), qk.quantize_rows(Cq, scale)
    # the ANN path's first bucket: its ADC distance matrix for B5 int32
    ann, ann_q, _ = ann_fit(dev, N_QUERIES)
    qlut, codes, cand, ann_select_k = ann_bucket(ann, ann_q[:BUCKET])
    Xi = kann.launch_dist(qlut, codes, cand)
    del ann, ann_q, qlut, codes, cand
    routes = {name: getattr(mod, "ROUTE_LAUNCHES", None)
              for name, mod in (("b1", dt), ("b6", qk), ("b4", pd),
                                ("b5", ts))}
    ops.reset_launches()
    cases = {"b1_knn": lambda: ops.distance_topk(A, Cq, K),
             "b1_ann_probe": lambda: ops.distance_topk(cells, Qa, ANN_K),
             "b6_knn": lambda: ops.distance_topk_q8(A8, C8, K)}
    times = {}
    for key, fn in cases.items():
        out = fn()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out[0].float()).all()):
            raise RuntimeError(f"{key}: output not finite")
        times[key] = device_ms(fn)
    E = ops.pairwise_sq_dist(A, Cq, col_major=True)
    A2 = A[:KMEANS_ROWS].contiguous()
    C2 = A2[:KMEANS_K].clone()
    blocked = {"b4_knn": lambda: ops.pairwise_sq_dist(A, Cq,
                                                      col_major=True),
               "b5_knn": lambda: ops.topk_smallest(E.T, BLOCKED_K),
               "b5_ann_i32": lambda: ops.topk_smallest(Xi, ann_select_k),
               "b4_kmeans_fit": lambda: ops.pairwise_sq_dist(A2, C2)}
    for key, fn in blocked.items():
        out = fn()
        torch.cuda.synchronize()
        vals = out[0] if isinstance(out, tuple) else out
        if not bool(torch.isfinite(vals.float()).all()):
            raise RuntimeError(f"{key}: output not finite")
        del out, vals
        times[key] = events_ms(fn, 10)
    ann_shape = list(Xi.shape)
    del E, Xi, A2, C2
    timed_routes = {name: dict(r) for name, r in routes.items()
                    if r is not None}
    est = est_mod.make_fitted("knn", Xtr, ytr, n_groups=CLASSES, device=dev)
    est64 = est_mod.make_fitted("knn", Xtr, ytr, n_groups=CLASSES,
                                device=dev, k=BLOCKED_K)
    qps = {}
    for label, fitted, policy in (("knn", est, None),
                                  ("knn_int8", est, "int8"),
                                  (f"knn_k{BLOCKED_K}", est64, None)):
        engine = NonNeuralServeEngine(fitted, max_batch=BUCKET, device=dev,
                                      policy=policy)
        engine.warmup_buckets(D)
        engine.classify(Xq)
        qps[label] = dict(host=served_qps(torch, engine, Xq),
                          card=served_qps(torch, engine, on_card(Xq)))
        del engine
    print(json.dumps(dict(src=str(Path(args.src).resolve()), card=card(),
                          torch=torch.__version__, reps=REPS,
                          ann_matrix=dict(shape=ann_shape, k=ann_select_k),
                          device_ms=times, routes=timed_routes,
                          launches=dict(ops.LAUNCHES), qps=qps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
