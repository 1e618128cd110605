"""Device times of B1 (``ops.distance_topk``) and B6
(``ops.distance_topk_q8``) at the shapes of the kNN serving paths, and the
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
              scales from the rows), k = 4.

A kernel time is ``lm_kernel_times.device_ms``: the replay of 20 calls
captured as a CUDA graph, timed by CUDA events, per call (device time,
without the host's time to issue the call); run this file as a script,
so that its directory, which holds ``lm_kernel_times.py``, is on the
path.  The served rate is ``NonNeuralServeEngine.classify`` of 4096
queries in 1024-query buckets after ``warmup_buckets``, host clock to a
synchronize, five calls a reading and three readings, queries from host
memory and from the card, for the fp32 engine (B1) and the int8 engine
(B6) over the same fitted kNN.  Where the checkout counts its kernels'
routes (``ROUTE_LAUNCHES`` in ``kernels/distance_topk.py`` and
``kernels/quantized.py``), the counts of the timed calls are printed too.
Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

N_ROWS, D, CLASSES, K = 1 << 20, 21, 3, 4
N_QUERIES, BUCKET = 4096, 1024
ANN_CELLS, ANN_CLASSES, ANN_K = 256, 256, 16


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
    from repro_torch.kernels import quantized as qk
    from repro_torch.serving import NonNeuralServeEngine
    from lm_kernel_times import REPS, device_ms

    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
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
    routes = {name: getattr(mod, "ROUTE_LAUNCHES", None)
              for name, mod in (("b1", dt), ("b6", qk))}
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
    timed_routes = {name: dict(r) for name, r in routes.items()
                    if r is not None}
    est = est_mod.make_fitted("knn", Xtr, ytr, n_groups=CLASSES, device=dev)
    qps = {}
    for label, policy in (("knn", None), ("knn_int8", "int8")):
        engine = NonNeuralServeEngine(est, max_batch=BUCKET, device=dev,
                                      policy=policy)
        engine.warmup_buckets(D)
        engine.classify(Xq)
        qps[label] = dict(host=served_qps(torch, engine, Xq),
                          card=served_qps(torch, engine, on_card(Xq)))
        del engine
    print(json.dumps(dict(src=str(Path(args.src).resolve()), card=card,
                          torch=torch.__version__, reps=REPS,
                          device_ms=times, routes=timed_routes,
                          launches=dict(ops.LAUNCHES), qps=qps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
