"""Where a request-stream replay spends its host time, on the card.

    python3 src/repro_torch/launch/stream_times.py

The ``[stream]`` phase of ``chip_smoke.py`` replays
``poisson_trace(256, 64, seed 0)`` (16,550 requests) through
``RequestScheduler`` over 1024-query buckets.  This script replays the
same trace over GNB engines at d = 784 (``chip_smoke.py``'s GNB path: the
first 60,000 of 64,000 seeded 10-class ``class_blobs`` rows fit it, the
last 4096 are the queries) and at d = 64 (the narrowest width that takes
B3), and over a kNN engine at d = 21 on 65,536 rows (B1), so that the
host time a request can be read against the row width.  Each engine
serves ``RUNS`` replays, each with a fresh scheduler; then the d = 784
GNB engine serves ``RUNS`` more with Python's cyclic garbage collector
off, and one under ``cProfile`` (its costliest functions by own time).
A replay's wall time is split into its launches (the scheduler's
``batch_time``: copy in, classify, synchronize) and the rest, the host
outside the launches.  Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import cProfile
import gc
import json
import pstats
import sys
import time
from pathlib import Path

RUNS = 5
RATE, TICKS, MAX_WAIT, DEADLINE, BUCKET = 256, 64, 4, 8, 1024
N_QUERIES = 4096


def replay(engine, queries, counts):
    """One replay through a fresh scheduler: (wall s, launches s,
    requests)."""
    from repro_torch.serving import RequestScheduler, replay_trace
    sched = RequestScheduler(engine, max_wait=MAX_WAIT)
    t0 = time.perf_counter()
    ids = replay_trace(sched, queries, counts, deadline=DEADLINE)
    wall = time.perf_counter() - t0
    return wall, float(sum(sched.stats.batch_times)), len(ids)


def summary(runs):
    walls = sorted(r[0] for r in runs)
    hosts = sorted((r[0] - r[1]) / r[2] * 1e6 for r in runs)
    n = runs[0][2]
    return dict(requests=n, wall_s=walls, req_per_s_median=n / walls[
        len(walls) // 2], host_us_per_request=hosts,
        launches_s=[r[1] for r in runs])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible: this script times the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from repro_torch.core.estimator import make_fitted
    from repro_torch.data.datasets import class_blobs
    from repro_torch.serving import NonNeuralServeEngine, poisson_trace

    dev = torch.device("cuda", 0)
    counts = poisson_trace(RATE, TICKS, seed=0)
    out = dict(card=torch.cuda.get_device_name(0))
    engines = {}
    for name, algo, n, d, classes, seed in (
            ("gnb d=784", "gnb", 60_000, 784, 10, 2),
            ("gnb d=64", "gnb", 60_000, 64, 10, 2),
            ("knn d=21", "knn", 1 << 16, 21, 3, 0)):
        X, y = class_blobs(n=n + N_QUERIES, d=d, n_class=classes, seed=seed)
        est = make_fitted(algo, X[:n], y[:n], n_groups=classes, device=dev)
        engine = NonNeuralServeEngine(est, max_batch=BUCKET, device=dev)
        engine.warmup_buckets(d)
        engines[name] = (engine, X[n:])
        out[name] = summary([replay(engine, X[n:], counts)
                             for _ in range(RUNS)])
    engine, queries = engines["gnb d=784"]
    gc.disable()
    try:
        out["gnb d=784, collector off"] = summary(
            [replay(engine, queries, counts) for _ in range(RUNS)])
    finally:
        gc.enable()
    prof = cProfile.Profile()
    prof.enable()
    replay(engine, queries, counts)
    prof.disable()
    stats = pstats.Stats(prof)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    out["gnb d=784 profile, own s"] = [
        (f"{Path(f).name}:{line}({fn})", round(tt, 6), calls)
        for (f, line, fn), (_, calls, tt, _, _) in top]
    for key, val in out.items():
        if isinstance(val, dict):
            print(f"[stream-times] {key}: {val['req_per_s_median']:.1f} "
                  f"req/s (median of {RUNS}), host outside the launches "
                  f"{[round(h, 2) for h in val['host_us_per_request']]} "
                  f"us a request")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
