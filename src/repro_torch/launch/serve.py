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

Multi-tenant: ``--tenants G`` fits G same-shape per-tenant estimators,
parks them in a ``ModelStore`` (``--resident-frac`` of their fp32 bytes
resident, the rest int8 at rest) and serves them through one grouped
launch a (group, bucket) cell (B1, B2, B3 with a tenant axis); with
``--stream`` a seeded cross-tenant Poisson trace goes through the
store-mode scheduler, and ``--degrade`` splits the group launch and arms
per-tenant circuit breakers.  ``--chaos PLAN`` (a preset of
``runtime.chaos.PRESETS`` or a plan's JSON file) injects faults into a
stream on the plan's virtual clock.

  PYTHONPATH=src python -m repro_torch.launch.serve --algo knn \
      --tenants 8 --batch 16 --resident-frac 0.5 --stream --chaos storm

A single-model ``--stream --degrade`` builds the brownout ladder of the
engine (``build_ladder``: int8 and, for kNN, ANN siblings whose measured
capacity gain is above 1) and sheds expired requests.  ``--autotune``
times every registered arm a bucket at warmup and routes each bucket
through the fastest; ``--calibration PATH`` installs a calibrated cost
model (a file holding ``{"entries": [...]}`` of ``core.calibrate`` fits)
for the path selector.  ``--policy`` takes ``<dtype>@<cost backend>``
(``fp32@rvfplib``) too.

  PYTHONPATH=src python -m repro_torch.launch.serve --algo knn \
      --batch 64 --stream --rate 96 --ticks 64 --deadline 4 --degrade

Runs on the card; ``--device cpu`` runs the kernels' plain versions on the
CPU instead (with ``--smoke`` for the LM: the full width does not fit a
CPU run).  The counterpart of the JAX package's ``launch/serve.py``
(``serve_nonneural``, ``serve_stream``, ``serve_tenants``,
``serve_tenant_stream`` and ``serve_lm``); ``--mesh`` and ``--strategy``
wait for the sharded layer (ROADMAP A15).
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
    engine.warmup(Q, autotune=args.autotune)
    if args.autotune and engine.tuned:
        arms = ", ".join(
            f"{b}->{a.strategy}/{a.path or a.static_path}"
            f" ({a.us:.0f}us vs static {a.static_us:.0f}us)"
            + ("*" if a.differs else "")
            for b, a in sorted(engine.tuned.items()))
        print(f"[autotune] tuned arms (* = differs from static): {arms}")
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


def serve_tenants(args):
    """--tenants G: fit G same-shape per-tenant estimators on seeded blobs
    (tenant t from seed t), park them in a ``ModelStore`` (capped to
    --resident-frac of their fp32 bytes, the rest int8 at rest) and serve
    one (G, --batch) request through ONE grouped launch instead of G;
    checks each lane against the per-tenant loop on the same stacked
    lanes."""
    import numpy as np
    import torch

    from repro_torch.core.estimator import make_fitted, unstack_params
    from repro_torch.data.datasets import class_blobs
    from repro_torch.device import device_name, resolve_device
    from repro_torch.serving import ModelStore

    if args.algo == "ann":
        raise SystemExit("--tenants: ann has no grouped serving arm "
                         "(ragged IVF/PQ shapes, DESIGN.md §11)")
    device = resolve_device(args.device)
    G, d, n_class = args.tenants, args.dim, args.classes
    store = ModelStore(device=device)
    for t in range(G):
        X, y = class_blobs(n=args.train_size, d=d, n_class=n_class, seed=t)
        store.register(t, make_fitted(args.algo, X, y, n_groups=n_class,
                                      device=device))
    full = store.stats()["resident_bytes"]
    if args.resident_frac < 1.0:
        store.set_budget(int(full * args.resident_frac))
    st = store.stats()
    budget = f"{st['budget_bytes']}B" if st["budget_bytes"] is not None \
        else "unbounded"
    print(f"[tenants] algo={args.algo} G={G} device={device_name(device)} "
          f"resident {st['n_resident']}/{st['n_models']} "
          f"({st['resident_frac']:.2f} of models, budget={budget} of "
          f"{full}B fp32, {st['at_rest_bytes']}B int8 at rest)")

    engine = store.make_engine(max_batch=args.batch, max_group=G)
    Q = np.stack([class_blobs(n=args.batch, d=d, n_class=n_class,
                              seed=1000 + t)[0] for t in range(G)])
    if args.stream:
        return serve_tenant_stream(args, store, engine, Q)

    ids = list(range(G))
    stacked, _gens = store.group(ids)
    engine.warmup_groups(stacked, d, g_sizes=[engine._group_bucket(G)],
                         b_sizes=[engine._bucket(args.batch)])
    t0 = time.perf_counter()
    res = engine.classify_group(stacked, Q)
    engine._sync()
    dt_group = time.perf_counter() - t0

    fn = store.template.predict_batch_fn()
    Qt = [torch.from_numpy(Q[t]).to(device) for t in ids]
    lanes = [unstack_params(stacked, t) for t in ids]
    outs = [fn(lanes[t], Qt[t]) for t in ids]
    engine._sync()
    t0 = time.perf_counter()
    outs = [fn(lanes[t], Qt[t]) for t in ids]
    engine._sync()
    dt_loop = time.perf_counter() - t0
    # against the same stacked lanes: under a budget, params_of() would
    # churn tenants through the lossy int8 round trip
    for t in ids:
        assert torch.equal(res.classes[t], outs[t][0]), t
    nq = G * args.batch
    print(f"[tenants] grouped {nq} queries ({G}x{args.batch}) in "
          f"{dt_group * 1e3:.2f}ms ({dt_group / nq * 1e6:.1f} us/q) vs "
          f"per-model loop {dt_loop * 1e3:.2f}ms "
          f"({dt_loop / nq * 1e6:.1f} us/q); "
          f"launches={dict(engine.group_launches)}; grouped classes "
          f"equal to the loop's")
    return res


def _chaos_injector(args, store=None, n_tenants: int = 0):
    """--chaos PLAN: a named preset (``runtime.chaos.PRESETS``) seeded
    with --seed, or the path of a ``ChaosPlan`` JSON file."""
    if not args.chaos:
        return None
    from repro_torch.runtime.chaos import PRESETS, ChaosInjector, ChaosPlan
    if args.chaos in PRESETS:
        plan = ChaosPlan.preset(args.chaos, seed=args.seed,
                                ticks=args.ticks, n_tenants=n_tenants)
    else:
        with open(args.chaos) as f:
            plan = ChaosPlan.from_json(f.read())
    print(f"[chaos] plan={args.chaos} seed={plan.seed} "
          f"stragglers={len(plan.straggler_ticks)} "
          f"nan={len(plan.nan_events)} storms={len(plan.storm_ticks)} "
          f"bursts={len(plan.burst)}")
    return ChaosInjector(plan, store=store)


def _print_robustness(sched) -> None:
    from collections import Counter
    s = sched.stats.summary()
    if sched.stats.shed or sched.stats.downshifts or sched.stats.upshifts:
        print(f"[robust] shed={s['shed']} ({dict(sched.stats.shed_reasons)})"
              f"  shed_rate={s['shed_rate']:.3f}  "
              f"miss+shed={s['miss_plus_shed_rate']:.3f}  "
              f"downshifts={s['downshifts']} "
              f"upshifts={sched.stats.upshifts}  "
              f"tiers={dict(sched.stats.tier_launches)}")
    kinds = Counter(e.kind for e in sched.events)
    if kinds:
        print("[robust] events: "
              + ", ".join(f"{k}={n}" for k, n in sorted(kinds.items())))


def serve_tenant_stream(args, store, engine, Q):
    """--tenants --stream: cross-tenant Poisson arrivals coalesced by the
    store-mode ``RequestScheduler`` into grouped (model group x bucket)
    launches; per-tenant SLO rows.  Asserts that no cell was first run
    mid-stream."""
    import numpy as np

    from repro_torch.serving import (BreakerConfig, DegradePolicy,
                                     RequestScheduler, poisson_trace,
                                     replay_trace)

    G, d = Q.shape[0], Q.shape[2]
    ids = list(range(G))
    stacked, _gens = store.group(ids)
    engine.warmup_groups(stacked, d)
    degrade = breaker = None
    if args.degrade:
        degrade = DegradePolicy(None, deadline=args.deadline)
        breaker = BreakerConfig()
    sched = RequestScheduler(engine, max_wait=args.max_wait,
                             cache_size=args.cache_size, store=store,
                             max_queue=args.max_queue,
                             shed_expired=args.degrade, degrade=degrade,
                             breaker=breaker)
    chaos = _chaos_injector(args, store=store, n_tenants=G)
    counts = poisson_trace(args.rate, args.ticks, seed=args.seed)
    flat = np.asarray(Q).reshape(-1, d)
    t0 = time.perf_counter()
    rids = replay_trace(sched, flat, counts, deadline=args.deadline,
                        model_ids=ids, chaos=chaos)
    dt = time.perf_counter() - t0
    s = sched.stats.summary()
    print(f"[tenants/stream] algo={args.algo} G={G} rate={args.rate} "
          f"ticks={args.ticks} max_wait={args.max_wait} "
          f"cache={args.cache_size}")
    print(f"[tenants/stream] served {len(rids)} requests in {dt:.3f}s wall "
          f"({s['launches']} grouped launches, cells="
          f"{dict(engine.group_launches)})")
    print(f"[tenants/stream] latency ticks p50={s['p50']:.0f} "
          f"p95={s['p95']:.0f} p99={s['p99']:.0f}  "
          f"throughput={s['throughput']:.2f} req/tick  "
          f"occupancy={s['occupancy']:.2f}  hit_rate={s['hit_rate']:.2f}  "
          f"deadline_miss={s['deadline_miss_rate']:.2f}")
    hdr = (f"{'tenant':>6} {'served':>6} {'p50':>5} {'p95':>5} "
           f"{'occupancy':>9} {'hit_rate':>8}")
    print(hdr)
    print("-" * len(hdr))
    for mid in sorted(sched.tenant_stats):
        ts = sched.tenant_stats[mid].summary()
        print(f"{mid:>6} {ts['served']:>6} {ts['p50']:>5.0f} "
              f"{ts['p95']:>5.0f} {ts['occupancy']:>9.2f} "
              f"{ts['hit_rate']:>8.2f}")
    _print_robustness(sched)
    assert set(engine.group_launches) <= sched.warmed_groups, \
        "stream ran a (group, bucket) cell that was not warmed before it"
    return sched.stats


def serve_stream(args, engine, Q):
    """--stream: replay a seeded Poisson arrival trace through the
    micro-batching ``RequestScheduler`` and report the SLO accounting
    (time is drain ticks, so the replay is deterministic for a given
    --seed).  Asserts that no bucket was first run mid-stream."""
    from repro_torch.serving import (DegradePolicy, RequestScheduler,
                                     build_ladder, poisson_trace,
                                     replay_trace)

    engine.warmup_buckets(Q.shape[1], autotune=args.autotune)
    if args.autotune and engine.tuned:
        arms = ", ".join(
            f"{b}->{a.strategy}/{a.path or a.static_path}"
            + ("*" if a.differs else "")
            for b, a in sorted(engine.tuned.items()))
        print(f"[autotune] tuned arms (* = differs from static): {arms}")
    degrade = None
    if args.degrade:
        tiers = build_ladder(engine, Q.shape[1])
        degrade = DegradePolicy(tiers, deadline=args.deadline)
        print("[degrade] ladder: "
              + " -> ".join(f"{t.name} (x{t.capacity_factor})"
                            for t in tiers))
    sched = RequestScheduler(engine, max_wait=args.max_wait,
                             cache_size=args.cache_size,
                             max_queue=args.max_queue,
                             shed_expired=args.degrade, degrade=degrade)
    chaos = _chaos_injector(args)
    counts = poisson_trace(args.rate, args.ticks, seed=args.seed)
    t0 = time.perf_counter()
    ids = replay_trace(sched, Q, counts, deadline=args.deadline,
                       chaos=chaos)
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
    _print_robustness(sched)
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
                    help="fp32, bf16, int8 (serves the estimator's int8 "
                         "lattice form), or <dtype>@<cost backend> (e.g. "
                         "fp32@libgcc; backends: libgcc, rvfplib, fpu, "
                         "int8, cortex-m4: an analytic costing only, the "
                         "card computes as under <dtype>)")
    ap.add_argument("--autotune", action="store_true",
                    help="time every registered arm of the hot op a "
                         "warmed bucket and route its launches through "
                         "the fastest instead of the static selector "
                         "(paper §5.2 profile-then-optimize)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="a calibration file ({\"entries\": [...]} of "
                         "core.calibrate fits) to load into the cost "
                         "model, so that the path selector takes the "
                         "measured-fastest arm (also REPRO_CALIBRATION)")
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
    ap.add_argument("--degrade", action="store_true",
                    help="--stream graceful degradation: deadline-"
                         "enforced shedding plus the brownout ladder (int8 "
                         "and, for knn, ANN siblings of the same model "
                         "whose measured capacity gain is above 1); "
                         "--tenants streams split the group launch under "
                         "pressure (DegradePolicy(None)) and arm "
                         "per-tenant circuit breakers instead")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="--stream deterministic fault injection: a "
                         "preset name (burst, straggler, storm, mixed) "
                         "seeded with --seed, or the path of a ChaosPlan "
                         "JSON (runtime/chaos.py)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve G same-shape per-tenant fits from a "
                         "ModelStore through grouped launches (Non-Neural "
                         "algos except ann)")
    ap.add_argument("--resident-frac", type=float, default=1.0,
                    help="--tenants: fraction of the total fp32 param "
                         "bytes kept resident; the least recently used "
                         "rest is held int8 at rest and dequantized on "
                         "admission")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a card the run "
                         "fails unless cpu is named")
    args = ap.parse_args(argv)
    from repro_torch.kernels import dispatch
    dispatch.get_policy(args.policy)      # an unknown name fails here
    if args.calibration:
        from repro_torch.core.precision import CostModel
        dispatch.set_cost_model(CostModel.from_calibration(args.calibration))
        print(f"[calibrate] cost model loaded from {args.calibration}")
    if args.algo == "lm":
        return serve_lm(args)
    if args.tenants > 1:
        return serve_tenants(args)
    return serve_nonneural(args)


if __name__ == "__main__":
    main()
