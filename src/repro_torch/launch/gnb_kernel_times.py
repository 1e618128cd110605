"""Device times of B3 (``ops.gnb_scores_batch``), B9 (``ops.gnb_scores``)
and B7 (``ops.distance_argmin_q8``) at the shapes of the GNB, GMM-wide
and K-Means int8 paths, and the served rates of those paths, for one
checkout of the port.

    python3 src/repro_torch/launch/gnb_kernel_times.py [--src DIR]

Imports ``repro_torch`` from DIR (default: the ``src`` directory this
file lies in), builds its kernels, and times through the public wrappers
only, so the same script times an older checkout: run it on two
checkouts in one command on one card (parent, change, change, parent) to
compare them.  The shapes, from the data of ``chip_smoke.py``:

  B3 bucket  one 1024-query GNB bucket (C = 10, d = 784): the last 4096
             of 64,000 seeded 10-class ``class_blobs`` rows (seed 2) are
             the queries, the first 60,000 fit the moments (``fit_gnb``);
  B9         the first of those queries alone (B3 at B = 1);
  B7 fit     the first 262,144 of 266,240 seeded 256-class rows (d = 21,
             seed 1) against their first 256 rows, quantized on the
             centroids' lattice as the int8 K-Means arm does;
  B7 serve   1024 of the last 4096 rows: one K-Means int8 bucket;
  host       B3 and B7 at one query (one class, one centroid, one
             feature): the device does next to nothing, so a loop of
             calls times the wrapper's host cost a call.

Each kernel is timed twice: by CUDA events over a loop of calls
(``events_ms``, the mean of 200 calls; B7 at the fit: 20; the host
shapes 1000), which
includes the host's time to issue each call where that is longer than
the device's, and by ``lm_kernel_times.device_ms`` (the replay of 20
calls captured as a CUDA graph, timed by CUDA events, per call: device
time alone; run this file as a script so that its directory is on the
path).  Host clock: ``classify`` of 4096 queries in 1024-query buckets
after ``warmup_buckets``, 20 calls a reading, five readings, queries
from host memory and from the card, for GNB, GMM at d = 784 (B3 and a
``logsumexp``) and K-Means served through the int8 tier (B7); then, under
``torch.profiler``, the device time of a ``classify`` from the card (its
kernels and copies, summed over 10 calls) and the time a launch of its
three costliest kernels.  Where the
checkout counts B3's or B7's routes (``ROUTE_LAUNCHES`` of
``kernels/gnb_score.py``, ``ARGMIN_ROUTE_LAUNCHES`` of
``kernels/quantized.py``), the counts of the timed calls are printed
too.  Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

GNB_ROWS, GNB_D, GNB_C = 60_000, 784, 10
KM_ROWS, KM_D, KM_K = 1 << 18, 21, 256
N_QUERIES, BUCKET = 4096, 1024
QPS_RUNS = (20, 5)   # classify calls a reading, readings
PROFILED = 10        # classify calls under the profiler


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
    from repro_torch.core.gnb import fit_gnb
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import quantized as qk
    from repro_torch.serving import NonNeuralServeEngine
    from ann_kernel_times import served_qps
    from kernel_cuts import card, events_ms
    from lm_kernel_times import REPS, device_ms

    _build.build_all()
    dev = torch.device("cuda:0")

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    routes = {}
    for name, attr in (("gnb_score", "ROUTE_LAUNCHES"),
                       ("quantized", "ARGMIN_ROUTE_LAUNCHES")):
        mod = __import__(f"repro_torch.kernels.{name}", fromlist=[attr])
        if hasattr(mod, attr):
            routes[name] = getattr(mod, attr)

    Xg, yg = class_blobs(n=GNB_ROWS + N_QUERIES, d=GNB_D, n_class=GNB_C,
                         seed=2)
    mu, var, lp = fit_gnb(on_card(Xg[:GNB_ROWS]), on_card(yg[:GNB_ROWS]),
                          GNB_C)
    Xb = on_card(Xg[GNB_ROWS:GNB_ROWS + BUCKET])
    x1 = Xb[0].contiguous()
    Xk, _ = class_blobs(n=KM_ROWS + N_QUERIES, d=KM_D, n_class=KM_K, seed=1)
    A = on_card(Xk[:KM_ROWS])
    scale = qk.feature_scales(A[:KM_K].abs().amax(0))
    A8, C8 = qk.quantize_rows(A, scale), qk.quantize_rows(A[:KM_K], scale)
    Aq8 = qk.quantize_rows(on_card(Xk[KM_ROWS:KM_ROWS + BUCKET]), scale)
    one = [t[:1, :1].contiguous() for t in (Xb, mu, var)] + [lp[:1]]
    one8 = [t[:1, :1].contiguous() for t in (Aq8, C8)]
    calls = {"b3_bucket": (lambda: ops.gnb_scores_batch(Xb, mu, var, lp),
                           200),
             "b9": (lambda: ops.gnb_scores(x1, mu, var, lp), 200),
             "b7_fit": (lambda: ops.distance_argmin_q8(A8, C8), 20),
             "b7_serve": (lambda: ops.distance_argmin_q8(Aq8, C8), 200),
             "b3_host": (lambda: ops.gnb_scores_batch(*one), 1000),
             "b7_host": (lambda: ops.distance_argmin_q8(*one8), 1000)}
    s3 = ops.gnb_scores_batch(Xb, mu, var, lp)
    s9 = ops.gnb_scores(x1, mu, var, lp)
    v7, i7 = ops.distance_argmin_q8(Aq8, C8)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(s3).all()) and
            bool(torch.isclose(s9, s3[0], rtol=1e-5, atol=1e-5).all()) and
            bool((v7 >= 0).all()) and bool(((i7 >= 0) & (i7 < KM_K)).all())):
        raise RuntimeError("a kernel's output is out of range")
    for counts in routes.values():
        for key in counts:
            counts[key] = 0
    times = {}
    for key, (fn, reps) in calls.items():
        times[key] = dict(events=events_ms(fn, reps), device=device_ms(fn))
    timed_routes = {name: dict(r) for name, r in routes.items()}
    del A, A8

    engines = {}
    Xq = Xg[GNB_ROWS:]
    for algo in ("gnb", "gmm"):
        est = est_mod.make_fitted(algo, Xg[:GNB_ROWS], yg[:GNB_ROWS],
                                  n_groups=GNB_C, device=dev)
        engines[algo] = (NonNeuralServeEngine(est, max_batch=BUCKET,
                                              device=dev), Xq, GNB_D)
    km = est_mod.make_fitted("kmeans", Xk[:KM_ROWS], None, n_groups=KM_K,
                             device=dev)
    engines["kmeans_int8"] = (NonNeuralServeEngine(
        km, max_batch=BUCKET, device=dev, policy="int8"), Xk[KM_ROWS:], KM_D)
    qps = {}
    for algo, (engine, queries, d) in engines.items():
        engine.warmup_buckets(d)
        engine.classify(queries)
        qps[algo] = dict(host=served_qps(torch, engine, queries, *QPS_RUNS),
                         card=served_qps(torch, engine, on_card(queries),
                                         *QPS_RUNS))
    ops.reset_launches()
    engines["kmeans_int8"][0].classify(Xk[KM_ROWS:])
    torch.cuda.synchronize()
    b7_launches = ops.LAUNCHES["distance_argmin_q8"]
    # last, as a process that has run the profiler launches more slowly:
    # the device time of a classify from the card, from the profiler's
    # kernels and copies, and each kernel's time a launch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device_per_classify = {}
    for algo, (engine, queries, _) in engines.items():
        queries = on_card(queries)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                engine.classify(queries)
            torch.cuda.synchronize()
        rows = [(e.key, e.count,
                 getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_per_classify[algo] = dict(
            ms=sum(us for _, _, us in rows) / PROFILED / 1e3,
            top={key[:80]: dict(launches=n / PROFILED, us=us / n)
                 for key, n, us in sorted(rows, key=lambda r: -r[2])[:3]})
    print(json.dumps(dict(
        src=str(Path(args.src).resolve()), card=card(),
        torch=torch.__version__, reps=REPS, ms=times, routes=timed_routes,
        kmeans_int8_b7_launches_per_classify=b7_launches, qps=qps,
        device_per_classify=device_per_classify)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
