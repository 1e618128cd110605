"""Serving from the command line.

The defaults are the JAX package's (``launch/serve.py``): ``--algo lm``
and ``--batch 4``, so the same bare command serves the same path.

LM (dense family): seeded random weights and prompts, greedy or sampled
generation through ``ServeEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --algo lm \
      --arch stablelm-3b --batch 4 --prompt-len 512 --new-tokens 32

Non-Neural: fit one estimator on seeded blobs and serve held-out queries
through the bucketed engine (``--batch`` is the largest bucket).

  PYTHONPATH=src python -m repro_torch.launch.serve --algo knn \
      --batch 64 --requests 256 --policy fp32

Request streaming: ``--stream`` replays a seeded Poisson trace through
the micro-batching ``RequestScheduler`` after warming every bucket, and
prints the SLO line (p50/p95/p99 in drain ticks, occupancy, hit-rate).

  PYTHONPATH=src python -m repro_torch.launch.serve --algo gnb --batch 16 \
      --stream --rate 4 --ticks 40 --cache-size 64 --deadline 8

Runs on the card; ``--device cpu`` runs the kernels' plain versions on the
CPU instead (with ``--smoke`` for the LM: the full width does not fit a
CPU run).  The counterpart of the JAX package's ``launch/serve.py``
(``serve_nonneural``, ``serve_stream`` and ``serve_lm``); its tenant
(ROADMAP A12), degrade and chaos (A13), autotune (A14) and mesh (A15)
flags wait for their items.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.serving.engine import ClassifyResult, GenerationResult


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
    if args.stream:
        return serve_stream(args, engine, Q)
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


def serve_stream(args, engine, Q):
    """--stream: replay a seeded Poisson arrival trace through the
    micro-batching ``RequestScheduler`` and report the SLO accounting
    (time is drain ticks, so the replay is deterministic for a given
    --seed).  Asserts that no bucket was first run mid-stream."""
    from collections import Counter

    from repro_torch.serving import (RequestScheduler, poisson_trace,
                                     replay_trace)

    engine.warmup_buckets(Q.shape[1])
    sched = RequestScheduler(engine, max_wait=args.max_wait,
                             cache_size=args.cache_size,
                             max_queue=args.max_queue)
    counts = poisson_trace(args.rate, args.ticks, seed=args.seed)
    t0 = time.perf_counter()
    ids = replay_trace(sched, Q, counts, deadline=args.deadline)
    dt = time.perf_counter() - t0
    s = sched.stats.summary()
    print(f"[stream] algo={args.algo} policy={args.policy} "
          f"rate={args.rate} ticks={args.ticks} max_wait={args.max_wait} "
          f"cache={args.cache_size}")
    n_strag = sum(e.kind.startswith("straggler_") for e in sched.events)
    print(f"[stream] served {len(ids)} requests in {dt:.3f}s wall "
          f"({s['launches']} launches, buckets={engine.bucket_launches}, "
          f"straggler events={n_strag})")
    print(f"[stream] latency ticks p50={s['p50']:.0f} p95={s['p95']:.0f} "
          f"p99={s['p99']:.0f}  throughput={s['throughput']:.2f} req/tick  "
          f"occupancy={s['occupancy']:.2f}  hit_rate={s['hit_rate']:.2f}  "
          f"deadline_miss={s['deadline_miss_rate']:.2f}")
    if sched.stats.shed:
        print(f"[robust] shed={s['shed']} ({dict(sched.stats.shed_reasons)})"
              f"  shed_rate={s['shed_rate']:.3f}  "
              f"miss+shed={s['miss_plus_shed_rate']:.3f}")
    kinds = Counter(e.kind for e in sched.events)
    if kinds:
        print("[robust] events: "
              + ", ".join(f"{k}={n}" for k, n in sorted(kinds.items())))
    assert set(engine.bucket_launches) <= sched.warmed, \
        "stream ran a bucket that was not warmed before it"
    return sched.stats


def serve_lm(args) -> GenerationResult:
    import torch

    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.device import device_name, resolve_device
    from repro_torch.models import transformer
    from repro_torch.serving import ServeEngine

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    batch = args.batch
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, device=device)
    engine = ServeEngine(cfg, params, ServeConfig(
        max_seq=args.prompt_len + args.new_tokens))
    prompts = torch.randint(0, cfg.vocab_size, (batch, args.prompt_len),
                            generator=gen, device=device)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    result = engine.generate(prompts, args.new_tokens,
                             temperature=args.temperature, generator=sampler)
    sync()
    dt = time.perf_counter() - t0
    toks = batch * args.new_tokens
    print(f"[serve] arch={cfg.arch_id} device={device_name(device)} "
          f"params={cfg.param_count()} batch={batch} "
          f"prompt={args.prompt_len} generated {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s) first row: "
          f"{result.tokens[0][:8].tolist()}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algo", default="lm",
                    choices=["knn", "ann", "kmeans", "gnb", "gmm", "rf",
                             "lm"],
                    help="lm = decoder LM generation through ServeEngine; "
                         "otherwise a Non-Neural estimator")
    ap.add_argument("--batch", type=int, default=4,
                    help="--algo lm: prompts per batch; otherwise the "
                         "engine's max_batch, its largest bucket (default "
                         "4, as in the JAX package's CLI)")
    ap.add_argument("--arch", default="stablelm-3b",
                    help="--algo lm: architecture id")
    ap.add_argument("--smoke", action="store_true",
                    help="--algo lm: the reduced config (2 layers, d_model "
                         "64, fp32) of --arch")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="--algo lm: tokens per prompt")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="--algo lm: tokens generated per prompt")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="--algo lm: 0 is greedy; > 0 samples")
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
    ap.add_argument("--stream", action="store_true",
                    help="replay a Poisson request stream through the "
                         "micro-batching RequestScheduler instead of one "
                         "pre-formed batch (Non-Neural algos only)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="--stream mean arrivals per drain tick")
    ap.add_argument("--ticks", type=int, default=64,
                    help="--stream trace length in drain ticks")
    ap.add_argument("--max-wait", type=int, default=4,
                    help="--stream coalescing window in drain ticks")
    ap.add_argument("--cache-size", type=int, default=0,
                    help="--stream LRU result cache entries (0 = off)")
    ap.add_argument("--deadline", type=int, default=None,
                    help="--stream per-request SLO in drain ticks")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="--stream admission-control bound: submits "
                         "beyond this many queued requests shed with "
                         "reason=queue_full (default unbounded)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the training and query blobs and of "
                         "the --stream arrival trace (--algo lm: of the "
                         "weights and prompts)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card the run "
                         "fails unless cpu is named")
    args = ap.parse_args(argv)
    if args.algo == "lm":
        return serve_lm(args)
    return serve_nonneural(args)


if __name__ == "__main__":
    main()
