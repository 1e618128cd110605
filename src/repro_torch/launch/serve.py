"""Non-Neural serving from the command line: fit one estimator on seeded blobs
and serve held-out queries through the bucketed engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --algo knn \
      --batch 64 --requests 256 --policy fp32

Runs on the card; ``--device cpu`` runs the kernels' plain versions on the
CPU instead.  The counterpart of the JAX package's ``launch/serve.py``
``serve_nonneural`` (non-LM flags only).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.serving.engine import ClassifyResult


def serve_nonneural(args) -> ClassifyResult:
    import torch

    from repro_torch.core.estimator import make_fitted
    from repro_torch.data.datasets import class_blobs
    from repro_torch.device import device_name, resolve_device
    from repro_torch.kernels.dispatch import get_policy
    from repro_torch.serving import NonNeuralServeEngine

    device = resolve_device(args.device)
    n_class = args.classes
    X, y = class_blobs(n=args.train_size + args.requests, d=args.dim,
                       n_class=n_class, seed=args.seed)
    X, Q = X[: args.train_size], X[args.train_size:]
    y, yq = y[: args.train_size], y[args.train_size:]

    extra = {}
    if args.algo == "ann":
        extra.update(nprobe=args.nprobe, refine=args.refine)
        if args.cells is not None:
            extra["n_cells"] = args.cells
        if args.pq_m is not None:
            extra["pq_m"] = args.pq_m
    est = make_fitted(args.algo, X, y, n_groups=n_class,
                      policy=get_policy(args.policy), device=device, **extra)
    engine = NonNeuralServeEngine(est, max_batch=args.batch, device=device,
                                  policy=args.policy)
    if engine.quant_report:
        r = engine.quant_report
        print(f"[quant] params {r['bytes_fp32']}B fp32 -> "
              f"{r['bytes_int8']}B int8")
    engine.warmup(Q)
    t0 = time.perf_counter()
    result = engine.classify(Q)
    engine._sync()
    dt = time.perf_counter() - t0
    # K-Means and GMM return cluster ids, not class labels
    acc = float((result.classes.cpu() == torch.from_numpy(yq)).float()
                .mean()) if args.algo in ("knn", "ann", "gnb", "rf") \
        else float("nan")
    print(f"[serve] algo={args.algo} policy={args.policy} "
          f"device={device_name(device)} "
          f"served {args.requests} queries in {dt:.3f}s "
          f"({args.requests / dt:.0f} q/s, {result.launches} launches, "
          f"buckets={engine.bucket_launches}) acc={acc:.3f}")
    return result


def main(argv=None) -> ClassifyResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algo", default="knn",
                    choices=["knn", "ann", "kmeans", "gnb", "gmm", "rf"])
    ap.add_argument("--batch", type=int, default=64,
                    help="engine max_batch (largest bucket)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--train-size", type=int, default=400)
    ap.add_argument("--dim", type=int, default=21)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--policy", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="int8 serves the estimator's int8 lattice form")
    ap.add_argument("--nprobe", type=int, default=4,
                    help="--algo ann: IVF cells probed per query (more = "
                         "higher recall, more ADC work)")
    ap.add_argument("--cells", type=int, default=None,
                    help="--algo ann: IVF cell count (default ~sqrt(N), "
                         "capped at 64)")
    ap.add_argument("--pq-m", type=int, default=None,
                    help="--algo ann: PQ subspace count")
    ap.add_argument("--refine", type=int, default=0,
                    help="--algo ann: exact re-rank of the ADC top-R "
                         "survivors (0 = pure ADC ranking)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the training and query blobs")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card the run "
                         "fails unless cpu is named")
    return serve_nonneural(ap.parse_args(argv))


if __name__ == "__main__":
    main()
