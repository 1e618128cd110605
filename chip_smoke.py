#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit.  In order it

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc, timing the build;
2. holds each kernel (B1 distance_topk, B2 distance_argmin,
   B3 gnb_scores_batch) against its plain PyTorch version on the card at
   the main-path shapes, at ragged edge shapes and on data with exact
   ties, and times kernel, plain version and one library call;
3. drives the main path for kNN, K-Means and GNB:
   ``make_fitted`` -> ``NonNeuralServeEngine.warmup_buckets`` ->
   ``classify``, with every launch count set to 0 just before and read
   just after, and checks what it serves against the same estimator run
   with ``path="ref"`` on the card.

The comparison rule: values match to rtol = atol = 1e-5, where for a
squared distance rtol applies to ‖a‖² + ‖c‖², the size of the terms of
the expansion that both versions evaluate (see ``near``); GNB scores use
rtol on the score itself.  Indices match exactly except at a rank where
the two rows' distances agree within that tolerance (a near-tie between
different rows), which is counted and printed.  On integer-valued data
every distance is exact, so there the indices must match exactly.  Any failure exits non-zero; so does a machine
without a card, or a directory without the package.  The last lines are a
JSON object with each kernel's numbers, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 0
DEVICE = "cuda:0"
MAX_BATCH = 1024
N_QUERIES = 4096
# main-path sizes: kNN over a million rows at the asd_like width, K-Means
# with the coarse-quantizer K, GNB at the mnist_like width
KNN = dict(n=1 << 20, d=21, classes=3, k=4)
KMEANS = dict(n=1 << 18, d=21, K=256)
GNB = dict(n=60_000, d=784, classes=10)

# NVIDIA data-sheet peaks by H100 variant: fp32 outside the tensor cores
# (FLOP/s) and device-memory rate (bytes/s), at the full power limit
PEAKS = {"PCIe": (51.2e12, 2.0e12), "NVL": (60.0e12, 3.9e12),
         "SXM": (67.0e12, 3.35e12)}


def check(cond, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of one call over ``reps`` calls, after one
    warm call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_ops: float, n_bytes: float, peaks):
    t_ops = n_ops / peaks[0] * 1e3
    t_bytes = n_bytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible: this script measures the card",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"{ROOT} does not hold src/repro_torch: run this script from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.core import estimator as est_mod
    from repro_torch.core.gnb import fit_gnb
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.distance_topk import TOPK_K_MAX
    from repro_torch.serving import NonNeuralServeEngine

    dev = torch.device(DEVICE)
    card = smi()
    name = torch.cuda.get_device_name(0)
    variant, peaks = card_peaks(name)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} sms "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} "
          f"(bounds from the H100 {variant} peaks: fp32 "
          f"{peaks[0] / 1e12:g} TFLOP/s, {peaks[1] / 1e12:g} TB/s)")

    # ------------------------------------------------ 1. build the kernels
    t0 = time.perf_counter()
    libs = _build.build_all()
    for stem in libs:
        _build.library(stem)
    print(f"[build] {len(libs)} libraries from "
          f"{[p.name for p in _build.sources()]} in "
          f"{time.perf_counter() - t0:.2f}s (nvcc {_build.build_seconds:.2f}s)")
    for stem, log in _build.logs().items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {stem}: {line.strip()}")

    # ------------------------------------------------ data of the main path
    def blobs(n, d, classes, seed):
        X, y = class_blobs(n=n + N_QUERIES, d=d, n_class=classes, seed=seed)
        return X[:n], y[:n], X[n:], y[n:]

    t0 = time.perf_counter()
    knn_data = blobs(KNN["n"], KNN["d"], KNN["classes"], SEED)
    km_data = blobs(KMEANS["n"], KMEANS["d"], KMEANS["K"], SEED + 1)
    gnb_data = blobs(GNB["n"], GNB["d"], GNB["classes"], SEED + 2)
    print(f"[data] seeded blobs in {time.perf_counter() - t0:.2f}s")
    gen = torch.Generator().manual_seed(SEED)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand(shape, ints: bool):
        """Normal data, or small integers drawn with repetition (exact
        distances, exact ties between equal rows)."""
        if ints:
            return torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        return torch.randn(shape, generator=gen).to(dev)

    def pair_dist(rows, q):
        """Distances of gathered rows (Q, m, d) to queries (Q, d) by the
        kernels' expansion, elementwise, and the scale ‖a‖² + ‖c‖² of the
        expansion's terms."""
        an = (rows * rows).sum(-1)
        cn = (q * q).sum(-1)[:, None]
        return an - 2.0 * (rows * q[:, None]).sum(-1) + cn, an + cn

    def near(got, want, scale):
        """|got - want| <= atol + rtol * scale.  A distance computed as
        ‖a‖² − 2a·c + ‖c‖² carries the rounding of its terms, so its error
        grows with ‖a‖² + ‖c‖², not with the distance: on the blob data
        (centres spread 3, d = 21) the terms are about 500 while nearest
        distances are about 8, and two correct fp32 evaluations of the
        same expansion differ by ~1e-4."""
        return (got - want).abs() <= TOL["atol"] + TOL["rtol"] * scale

    def compare_ranked(what, got_idx, want_idx, agree, exact):
        """Indices equal, except at a rank where the two rows' distances
        agree (``agree``, a near-tie); returns that count."""
        differ = got_idx != want_idx
        check(bool((~differ | agree).all()),
              f"{what}: {int((differ & ~agree).sum())} ranks pick a row "
              f"whose distance differs from the plain version's")
        n_near = int(differ.sum())
        check(not (exact and n_near), f"{what}: {n_near} index mismatches "
              f"on integer data, where every distance is exact")
        return n_near

    # ------------------------------------- 2. kernels against plain versions
    def topk_case(A, C, k, exact, what, chunk=128, dtype=torch.float32):
        A, C = A.to(dtype), C.to(dtype)
        kv, ki = ops.distance_topk(A, C, k)
        torch.cuda.synchronize()
        parts = [ref.distance_topk(A, C[i:i + chunk], k)
                 for i in range(0, C.shape[0], chunk)]
        A, C = A.float(), C.float()   # bf16 inputs meet the kernel upcast
        pv = torch.cat([p[0] for p in parts])
        pi = torch.cat([p[1] for p in parts])
        check(kv.shape == pv.shape and ki.dtype == torch.int32,
              f"{what}: shapes {tuple(kv.shape)} {ki.dtype}")
        dk, scale = pair_dist(A[ki.long()], C)
        check(bool(near(kv, pv, scale).all()),
              f"{what}: values differ by {float((kv - pv).abs().max())}")
        srt = ki.sort(dim=1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"{what}: a row appears twice in one query's list")
        check(bool(near(dk, kv, scale).all()),
              f"{what}: a value does not belong to its row")
        tied = kv[:, 1:] == kv[:, :-1]
        check(bool((ki[:, 1:] > ki[:, :-1])[tied].all()),
              f"{what}: an exact tie is not broken to the smallest row")
        dp, _ = pair_dist(A[pi.long()], C)
        n_near = compare_ranked(what, ki, pi, near(dk, dp, scale), exact)
        return float((kv - pv).abs().max()), n_near

    def argmin_case(A, C, exact, what):
        kv, ki = ops.distance_argmin(A, C)
        pv, pi = ref.distance_argmin(A, C)
        torch.cuda.synchronize()
        dk, scale = (t[:, 0] for t in pair_dist(C[ki.long()][:, None], A))
        dp, _ = pair_dist(C[pi.long()][:, None], A)
        check(bool(near(kv, pv, scale).all()),
              f"{what}: values differ by {float((kv - pv).abs().max())}")
        check(bool(near(dk, kv, scale).all()),
              f"{what}: a value does not belong to its centroid")
        n_near = compare_ranked(what, ki, pi, near(dk, dp[:, 0], scale),
                                exact)
        return float((kv - pv).abs().max()), n_near

    def nonfinite_case(N, d, k, what):
        """Queries holding a NaN or an Inf: every distance of the first is
        NaN, the second's are +Inf or NaN.  Both versions rank NaN after
        every number and break equal values to the smaller row, so indices
        match exactly and every one is a real row."""
        A, C = rand((N, d), True), rand((3, d), True)
        C[0, d // 2] = float("nan")
        C[1, 0] = float("inf")
        kv, ki = ops.distance_topk(A, C, k)
        pv, pi = ref.distance_topk(A, C, k)
        torch.cuda.synchronize()
        check(bool(((ki >= 0) & (ki < N)).all()),
              f"{what}: an index is not a row of A")
        check(torch.equal(ki, pi), f"{what}: indices differ from the "
              f"plain version's at {int((ki != pi).sum())} ranks")
        check(bool(torch.isclose(kv, pv, equal_nan=True, **TOL).all()),
              f"{what}: values differ from the plain version's")
        return int(kv.isnan().sum()), int(kv.isinf().sum())

    def gnb_case(X, mu, var, lp, what):
        ks = ops.gnb_scores_batch(X, mu, var, lp)
        ps = ref.gnb_scores_batch(X, mu, var, lp)
        torch.cuda.synchronize()
        check(bool(torch.isclose(ks, ps, **TOL).all()),
              f"{what}: scores differ by {float((ks - ps).abs().max())}")
        return float((ks - ps).abs().max())

    def gnb_inputs(B, d, C):
        X = torch.randn((B, d), generator=gen)
        mu = torch.randn((C, d), generator=gen)
        var = torch.rand((C, d), generator=gen) + 0.25
        lp = torch.log_softmax(torch.randn(C, generator=gen), 0)
        return [t.to(dev).contiguous() for t in (X, mu, var, lp)]

    edges = 0
    for N, d, Q, k, ints in [(4099, 1, 1, 1, True), (4099, 5, 3, TOPK_K_MAX,
                             True), (70001, 21, 3, TOPK_K_MAX, False),
                             (3001, 784, 1, TOPK_K_MAX, False),
                             (33, 21, 40, TOPK_K_MAX, True),
                             (TOPK_K_MAX, 5, 3, TOPK_K_MAX, False),
                             (100_003, 21, 37, 4, False),
                             (20_011, 784, 3, 1, True)]:
        err, n_near = topk_case(rand((N, d), ints), rand((Q, d), ints), k,
                              ints, f"B1 N={N} d={d} Q={Q} k={k}")
        print(f"[edge] B1 N={N} d={d} Q={Q} k={k} ints={ints}: "
              f"max_abs_err={err:.3g} near_ties={n_near}")
        edges += 1
    for N, d, Q, k, ints in [(500, 21, 5, 4, False), (4099, 5, 3, 8, True)]:
        err, n_near = topk_case(rand((N, d), ints), rand((Q, d), ints), k,
                                ints, f"B1 bf16 N={N} d={d} Q={Q} k={k}",
                                dtype=torch.bfloat16)
        print(f"[edge] B1 bf16 N={N} d={d} Q={Q} k={k} ints={ints}: "
              f"max_abs_err={err:.3g} near_ties={n_near}")
        edges += 1
    for N, d, k in [(4099, 21, TOPK_K_MAX), (70, 5, 4)]:
        n_nan, n_inf = nonfinite_case(N, d, k, f"B1 NaN/Inf N={N} d={d}")
        print(f"[edge] B1 NaN and Inf queries N={N} d={d} k={k}: "
              f"{n_nan} NaN and {n_inf} Inf values, indices equal")
        edges += 1
    for N, d, K, ints in [(4099, 1, 1, True), (4099, 5, 257, True),
                          (1001, 784, 257, False), (129, 21, 33, True),
                          (1, 21, 257, False), (70_001, 21, 257, False),
                          (129, 784, 1, False)]:
        err, n_near = argmin_case(rand((N, d), ints), rand((K, d), ints),
                                ints, f"B2 N={N} d={d} K={K}")
        print(f"[edge] B2 N={N} d={d} K={K} ints={ints}: "
              f"max_abs_err={err:.3g} near_ties={n_near}")
        edges += 1
    for B, d, C in [(1, 784, 10), (3, 1, 1), (33, 5, 9), (1023, 65, 257)]:
        err = gnb_case(*gnb_inputs(B, d, C), f"B3 B={B} d={d} C={C}")
        print(f"[edge] B3 B={B} d={d} C={C}: max_abs_err={err:.3g}")
        edges += 1
    print(f"[edge] {edges} ragged and tied cases agree with the plain "
          "versions")

    kernels = {}

    # B1 at the kNN serving shape: the whole reference set, one full bucket
    A = on_card(knn_data[0])
    Cq = on_card(knn_data[2][:MAX_BATCH])
    k = KNN["k"]
    err, n_near = topk_case(A, Cq, k, False, "B1 main")
    N, d, Q = A.shape[0], A.shape[1], Cq.shape[0]
    # per pair: d multiply-adds for a·c and one add of the two norms
    # (the -2 folds into C); the norms themselves, once per row and query
    b, by = bound_ms(N * Q * (2 * d + 1) + 2 * d * (N + Q),
                     4 * d * (N + Q) + 8 * Q * k, peaks)
    kernels["B1"] = dict(
        name="distance_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/distance_topk.cu",
        replaces="src/repro/kernels/distance_topk.py:48",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.distance_topk(A, Cq, k), 10),
        plain_ms=cuda_ms(torch, lambda: [ref.distance_topk(
            A, Cq[i:i + 128], k) for i in range(0, Q, 128)], 3),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.topk(
            torch.cdist(Cq, A) ** 2, k, dim=1, largest=False), 3))
    kernels["B1"]["serve_ms"] = kernels["B1"]["ms"]
    print(f"[kernel] B1 distance_topk N={N} Q={Q} d={d} k={k}: "
          f"max_abs_err={err:.3g} near_ties={n_near}")

    # B2 at the K-Means fit shape: every training row against K centroids
    A2 = on_card(km_data[0])
    C2 = A2[: KMEANS["K"]].clone()
    err, n_near = argmin_case(A2, C2, False, "B2 main")
    N, d, K = A2.shape[0], A2.shape[1], C2.shape[0]
    b, by = bound_ms(N * K * (2 * d + 1) + 2 * d * (N + K),
                     4 * d * (N + K) + 8 * N, peaks)
    kernels["B2"] = dict(
        name="distance_argmin", route="cuda",
        source="src/repro_torch/kernels/csrc/distance_topk.cu",
        replaces="src/repro/kernels/distance_topk.py:116",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.distance_argmin(A2, C2), 20),
        plain_ms=cuda_ms(torch, lambda: ref.distance_argmin(A2, C2), 10),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(A2, C2).argmin(1),
                           10))
    # and at the serving shape: one full bucket of queries
    Aq2 = on_card(km_data[2][:MAX_BATCH])
    kernels["B2"]["serve_ms"] = cuda_ms(
        torch, lambda: ops.distance_argmin(Aq2, C2), 200)
    print(f"[kernel] B2 distance_argmin N={N} K={K} d={d}: "
          f"max_abs_err={err:.3g} near_ties={n_near}; at the serving "
          f"shape N={MAX_BATCH}: {kernels['B2']['serve_ms']:.4f} ms")

    # B3 at the GNB serving shape: one full bucket against fitted moments
    Xg = on_card(gnb_data[2][:MAX_BATCH])
    mu, var, lp = fit_gnb(on_card(gnb_data[0]), on_card(gnb_data[1]),
                          GNB["classes"])
    err = gnb_case(Xg, mu, var, lp, "B3 main")
    B, d, C = Xg.shape[0], Xg.shape[1], mu.shape[0]
    b, by = bound_ms(7 * B * C * d + C * d + B * C,
                     4 * (B * d + 2 * C * d + C + B * C), peaks)
    kernels["B3"] = dict(
        name="gnb_scores_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/gnb_score.cu",
        replaces="src/repro/kernels/gnb_score.py:38",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.gnb_scores_batch(Xg, mu, var, lp),
                   200),
        plain_ms=cuda_ms(torch, lambda: ref.gnb_scores_batch(Xg, mu, var,
                                                             lp), 50),
        bound_ms=b, bound_by=by, library_ms=None)
    kernels["B3"]["serve_ms"] = kernels["B3"]["ms"]
    print(f"[kernel] B3 gnb_scores_batch B={B} C={C} d={d}: "
          f"max_abs_err={err:.3g}")
    for key, kr in kernels.items():
        lib = "none" if kr["library_ms"] is None else \
            f"{kr['library_ms']:.4f}"
        print(f"[time] {key} {kr['name']}: kernel {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    del A2, C2, Aq2

    # ------------------------------------------------ 3. the main path
    def drive(algo, data, groups, **kw):
        Xtr, ytr, Xq, yq = data
        ops.reset_launches()
        t0 = time.perf_counter()
        est = est_mod.make_fitted(algo, Xtr, ytr, n_groups=groups,
                                  device=dev, **kw)
        engine = NonNeuralServeEngine(est, max_batch=MAX_BATCH, device=dev)
        engine.warmup_buckets(Xtr.shape[1])
        warmed = set(engine.warmed)
        res = engine.classify(Xq)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        wall = time.perf_counter() - t0
        check(set(engine.bucket_launches) <= warmed,
              f"{algo}: served buckets {sorted(engine.bucket_launches)} "
              f"not all warmed {sorted(warmed)}")
        check(res.classes.shape == (len(Xq),) and res.launches == 4,
              f"{algo}: {tuple(res.classes.shape)} in {res.launches}")
        # timed serving after warmup, outside the counted run: queries
        # from host memory as a caller sends them, and already on the card
        def timed(queries, reps=5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                engine.classify(queries)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        call_ms = (timed(Xq), timed(on_card(Xq)))
        kw_ref = {"k": est.k} if algo == "knn" else {}
        est_ref = type(est).from_params(est.params, path="ref", device=dev,
                                        **kw_ref)
        res_ref = NonNeuralServeEngine(est_ref, max_batch=MAX_BATCH,
                                       device=dev).classify(Xq)
        torch.cuda.synchronize()
        acc = float((res.classes.cpu().numpy() == yq).mean())
        return est, res, res_ref, launches, call_ms, acc, wall

    def report(algo, key, launches, call_ms, acc, wall, extra):
        """One line per path: served q/s from the host clock, and the
        share of a classify call that its kernel's device time (at the
        bucket shape, from CUDA events) accounts for."""
        kr = kernels[key]
        count = launches[kr["name"]]
        check(count > 0, f"{algo}: kernel {key} {kr['name']} was never "
              "launched on the main path")
        kr["launches"] = count
        host_ms, card_ms = call_ms
        print(f"[path] {algo}: {N_QUERIES / host_ms * 1e3:.1f} q/s served "
              f"(classify of {N_QUERIES} in 4 buckets of {MAX_BATCH}: "
              f"{host_ms:.4f} ms from host memory, {card_ms:.4f} ms from "
              f"the card, {key} kernel time {4 * kr['serve_ms'] / host_ms:.3f}"
              f" and {4 * kr['serve_ms'] / card_ms:.3f} of those), "
              f"{key} launches={count}, kernel {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, acc={acc:.4f}, fit+warmup+serve "
              f"{wall:.2f}s; {extra}")

    # kNN: neighbours against the ref arm, near-ties allowed
    est, res, res_ref, launches, call_ms, acc, wall = drive(
        "knn", knn_data, KNN["classes"])
    check(acc >= 0.95, f"knn accuracy {acc}")
    Aq, Qq = est.params.A, on_card(knn_data[2])
    dk, scale = pair_dist(Aq[res.aux.long()], Qq)
    dp, _ = pair_dist(Aq[res_ref.aux.long()], Qq)
    n_near = compare_ranked("knn serve", res.aux, res_ref.aux,
                            near(dk, dp, scale), False)
    odd = res.classes != res_ref.classes
    check(bool((res.aux != res_ref.aux).any(1)[odd].all()),
          "knn: a class differs from the ref arm without a near-tie")
    report("knn", "B1", launches, call_ms, acc, wall,
           f"near_ties={n_near}, classes differing at near-ties="
           f"{int(odd.sum())}")
    del est, res, res_ref, Aq

    # K-Means: the fit against the ref arm's fit, assignments against ref
    est, res, res_ref, launches, call_ms, acc, wall = drive(
        "kmeans", km_data, KMEANS["K"])
    fit_ref = est_mod.make_fitted("kmeans", km_data[0], None,
                                  n_groups=KMEANS["K"], device=dev,
                                  path="ref")
    check(int(est.params.n_iter) == int(fit_ref.params.n_iter),
          f"kmeans: {int(est.params.n_iter)} iterations, ref arm "
          f"{int(fit_ref.params.n_iter)}")
    check(torch.allclose(est.params.centroids, fit_ref.params.centroids,
                         **TOL), "kmeans: fitted centroids differ from the "
          "ref arm's")
    Qk, cen = on_card(km_data[2]), est.params.centroids
    dk, scale = (t[:, 0] for t in pair_dist(cen[res.classes.long()][:, None],
                                            Qk))
    dp, _ = pair_dist(cen[res_ref.classes.long()][:, None], Qk)
    n_near = compare_ranked("kmeans serve", res.classes, res_ref.classes,
                            near(dk, dp[:, 0], scale), False)
    check(bool(near(res.aux, res_ref.aux, scale).all()),
          "kmeans: assignment distances differ from the ref arm's")
    # the first K rows seed one centroid in each of the K blobs, so a
    # right fit assigns every query to its own blob
    check(acc >= 0.95, f"kmeans: {acc} of the queries in their blob")
    report("kmeans", "B2", launches, call_ms, acc, wall,
           f"n_iter={int(est.params.n_iter)} (ref arm the same), "
           f"near_ties={n_near}")
    del est, res, res_ref, fit_ref

    # GNB: scores against the ref arm, classes equal but at near-ties
    est, res, res_ref, launches, call_ms, acc, wall = drive(
        "gnb", gnb_data, GNB["classes"])
    check(acc >= 0.95, f"gnb accuracy {acc}")
    check(torch.allclose(res.aux, res_ref.aux, **TOL),
          "gnb: scores differ from the ref arm's")
    odd = res.classes != res_ref.classes
    top2 = res_ref.aux.topk(2, dim=1).values
    check(bool(torch.isclose(top2[:, 0], top2[:, 1], **TOL)[odd].all()),
          "gnb: a class differs from the ref arm without a near-tie")
    report("gnb", "B3", launches, call_ms, acc, wall,
           f"classes differing at near-ties={int(odd.sum())}")

    # ------------------------------------------------ summary lines
    print("kernels: " + " ".join(f"{key}={kr['name']}:{kr['launches']}"
                                 for key, kr in kernels.items()))
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{f: kr[f] for f in order}
                                  for kr in kernels.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
