#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit.  In order it

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc (one process per source, in
   parallel), timing the build;
2. holds each kernel (B1 distance_topk, B2 distance_argmin,
   B3 gnb_scores_batch, B4 pairwise_sq_dist, B5 topk_smallest,
   B9 gnb_scores) against its plain PyTorch version on the card at the
   main-path shapes, at ragged edge shapes, on data with exact ties, on
   rows holding NaN and +Inf and at k = 1, k = n and k > 32, and times
   kernel, plain version and one library call; the blocked kNN arm is
   also checked at N = 2^22, where it splits a bucket's queries into
   chunks to bound its distance matrix;
3. drives each path through the entry points a user calls:
   ``make_fitted`` -> ``NonNeuralServeEngine.warmup_buckets`` ->
   ``classify``, with every launch count set to 0 just before and read
   just after, and checks what it serves against the same estimator run
   with ``path="ref"`` on the card.  The paths: kNN at k = 4 (B1) and k = 64 (the blocked arm, B4 then
   B5), K-Means fused (B2) and blocked (B4, by ``REPRO_BACKEND=blocked``),
   GNB (B3), GMM at d = 784 (B3) and at d = 21 (no kernel), RF (no
   kernel).  B9's entry is ``ops.gnb_scores`` itself, driven one query at
   a time against the fitted GNB moments under its own count.

The comparison rule: values match to rtol = atol = 1e-5, where for a
squared distance rtol applies to ‖a‖² + ‖c‖², the size of the terms of
the expansion that both versions evaluate (see ``near``), and for a GMM
log-responsibility to the size of the terms of the Gaussian log-density
(see ``gauss_scale``); GNB scores use rtol on the score itself.  Indices
match exactly except at a rank where the two rows' distances agree within
that tolerance (a near-tie between different rows), which is counted and
printed.  On integer-valued data every distance is exact, so there the
indices must match exactly; B5 ranks the very floats its plain version
sorts, so its indices must match exactly everywhere.  Any failure exits
non-zero; so does a machine without a card, or a directory without the
package.  The last lines are a JSON object with each kernel's numbers,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
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
# slice 2: kNN past B1's lists on the same data (the blocked arm), GMM on
# the GNB data (d >= 64: B3) and on the kNN data (d = 21: the ref
# E-step), RF at the reference's defaults on 4,000 kNN rows (its CART
# trains in Python loops on the host)
KNN_BLOCKED_K = 64
GMM_NARROW_ROWS = 1 << 18
RF = dict(n=4_000, trees=16, depth=8)

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
    from repro_torch.kernels import _build, dispatch, ops, ref
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

    def dist_case(N, K, d, col_major, ints, what):
        """B4 in either layout against the plain version."""
        A, C = rand((N, d), ints), rand((K, d), ints)
        e = ops.pairwise_sq_dist(A, C, col_major=col_major)
        p = ref.pairwise_sq_dist(A, C)
        torch.cuda.synchronize()
        check(e.shape == (N, K) and (e.T if col_major else e).is_contiguous(),
              f"{what}: layout {tuple(e.shape)} strides {e.stride()}")
        scale = (A * A).sum(1)[:, None] + (C * C).sum(1)[None, :]
        check(bool(near(e, p, scale).all()),
              f"{what}: values differ by {float((e - p).abs().max())}")
        check(not ints or torch.equal(e, p), f"{what}: a distance differs "
              "on integer data, where every distance is exact")
        return float((e - p).abs().max())

    def select_case(x, k, what):
        """B5 against the plain version on the same tensor: both rank the
        same floats, so indices and values must be equal; indices are
        distinct in every row."""
        kv, ki = ops.topk_smallest(x, k)
        pv, pi = ref.topk_smallest(x, k)
        torch.cuda.synchronize()
        check(ki.shape == (x.shape[0], k) and ki.dtype == torch.int32,
              f"{what}: {tuple(ki.shape)} {ki.dtype}")
        check(torch.equal(ki, pi), f"{what}: indices differ from the plain "
              f"version's at {int((ki != pi).sum())} places")
        check(bool(torch.isclose(kv, pv, rtol=0, atol=0,
                                 equal_nan=True).all()),
              f"{what}: values differ from the plain version's")
        srt = ki.sort(dim=1).values
        check(bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"{what}: an index appears twice in one row")
        return int(kv.isnan().sum()), int(kv.isinf().sum())

    def rows(R, n, kind):
        if kind == "ints":        # few values: long runs of exact ties
            return torch.randint(0, 4, (R, n), generator=gen).float().to(dev)
        x = torch.randn((R, n), generator=gen)
        if kind == "inf":         # four fifths +Inf: k reaches them
            x[:, torch.rand(n, generator=gen) < 0.8] = float("inf")
        if kind == "nan":         # NaN, ±Inf and signed zeros mixed in
            u = torch.rand((R, n), generator=gen)
            x[u < 0.3] = float("nan")
            x[(u >= 0.3) & (u < 0.4)] = float("inf")
            x[(u >= 0.4) & (u < 0.45)] = -float("inf")
            x[(u >= 0.45) & (u < 0.5)] = -0.0
            x[(u >= 0.5) & (u < 0.55)] = 0.0
        return x.to(dev)

    for N, K, d, col_major, ints in [(4099, 1, 1, True, True),
                                     (4099, 257, 5, False, True),
                                     (70_001, 1023, 21, True, False),
                                     (1001, 65, 784, False, False),
                                     (33, 40, 21, True, True),
                                     (1, 1, 21, False, False)]:
        err = dist_case(N, K, d, col_major, ints,
                        f"B4 N={N} K={K} d={d} col_major={col_major}")
        print(f"[edge] B4 N={N} K={K} d={d} col_major={col_major} "
              f"ints={ints}: max_abs_err={err:.3g}")
        edges += 1
    for R, n, k, kind in [(3, 4099, 1, "normal"), (5, 4099, 4099, "ints"),
                          (7, 5000, 33, "ints"), (37, 70_001, 64, "normal"),
                          (2, 3, 3, "normal"), (4, 9000, 2049, "inf"),
                          (6, 300, 300, "nan"), (9, 20_000, 64, "nan"),
                          (1, 1, 1, "normal"), (1030, 2048, 2048, "ints")]:
        n_nan, n_inf = select_case(rows(R, n, kind), k,
                                   f"B5 R={R} n={n} k={k} {kind}")
        print(f"[edge] B5 R={R} n={n} k={k} {kind}: indices equal, "
              f"{n_nan} NaN and {n_inf} Inf values")
        edges += 1
    # the reference's finding: its Pallas B5 repeats index 0 on this row
    kv, ki = ops.topk_smallest(torch.tensor(
        [[1.0, float("inf"), float("inf"), 0.5]], device=dev), 4)
    check(ki.tolist() == [[3, 0, 1, 2]], f"B5 +Inf row: {ki.tolist()}")
    # the blocked arm's hand-over: B5 reads the transpose of B4's
    # column-major matrix in place, and a row-strided slice of it
    e = ops.pairwise_sq_dist(rand((5000, 21), False), rand((40, 21), False),
                             col_major=True)
    select_case(e.T, 64, "B5 on the transposed view of B4")
    select_case(e.T[::3], 100, "B5 on a row-strided view")
    edges += 3
    del e
    for d, C in [(784, 10), (1, 1), (65, 257), (5, 9)]:
        X, mu_e, var_e, lp_e = gnb_inputs(1, d, C)
        ks = ops.gnb_scores(X[0], mu_e, var_e, lp_e)
        ps = ref.gnb_scores(X[0], mu_e, var_e, lp_e)
        torch.cuda.synchronize()
        check(ks.shape == (C,) and bool(torch.isclose(ks, ps, **TOL).all()),
              f"B9 d={d} C={C}: scores differ by "
              f"{float((ks - ps).abs().max())}")
        print(f"[edge] B9 d={d} C={C}: max_abs_err="
              f"{float((ks - ps).abs().max()):.3g}")
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
    d_g = d
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

    # B4 at the kNN serving shape: the (N, Q) matrix of one full bucket,
    # column-major as the blocked kNN arm writes it
    E = ops.pairwise_sq_dist(A, Cq, col_major=True)
    P = ref.pairwise_sq_dist(A, Cq)
    torch.cuda.synchronize()
    scale = (A * A).sum(1)[:, None] + (Cq * Cq).sum(1)[None, :]
    check(bool(near(E, P, scale).all()),
          f"B4 main: values differ by {float((E - P).abs().max())}")
    err = float((E - P).abs().max())
    del P, scale
    N, d, Q = A.shape[0], A.shape[1], Cq.shape[0]
    b, by = bound_ms(N * Q * (2 * d + 1) + 2 * d * (N + Q),
                     4 * d * (N + Q) + 4 * N * Q, peaks)
    kernels["B4"] = dict(
        name="pairwise_sq_dist", route="cuda",
        source="src/repro_torch/kernels/csrc/pairwise_sq_dist.cu",
        replaces="src/repro/kernels/distance.py:18",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.pairwise_sq_dist(A, Cq,
                                                       col_major=True), 10),
        plain_ms=cuda_ms(torch, lambda: ref.pairwise_sq_dist(A, Cq), 3),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(A, Cq) ** 2, 3))
    kernels["B4"]["serve_ms"] = kernels["B4"]["ms"]
    # and at the K-Means shapes: the fit (every row against K centroids)
    # and one serving bucket, row-major as the blocked K-Means arm writes
    Nk, Kk = A2.shape[0], C2.shape[0]
    b_km, by_km = bound_ms(Nk * Kk * (2 * d + 1) + 2 * d * (Nk + Kk),
                           4 * d * (Nk + Kk) + 4 * Nk * Kk, peaks)
    km_fit = dict(ms=cuda_ms(torch, lambda: ops.pairwise_sq_dist(A2, C2), 20),
                  plain=cuda_ms(torch, lambda: ref.pairwise_sq_dist(A2, C2),
                                10),
                  lib=cuda_ms(torch, lambda: torch.cdist(A2, C2) ** 2, 10))
    kernels["B4"]["serve_ms_kmeans"] = cuda_ms(
        torch, lambda: ops.pairwise_sq_dist(Aq2, C2), 200)
    print(f"[kernel] B4 pairwise_sq_dist N={N} K={Q} d={d} col_major: "
          f"max_abs_err={err:.3g}; at the K-Means fit shape N={Nk} K={Kk}: "
          f"kernel {km_fit['ms']:.4f} ms, plain {km_fit['plain']:.4f} ms, "
          f"library {km_fit['lib']:.4f} ms, bound {b_km:.4f} ms ({by_km}); "
          f"at the K-Means serving shape N={MAX_BATCH}: "
          f"{kernels['B4']['serve_ms_kmeans']:.4f} ms")

    # B5 on the transpose of that matrix: the k = 64 nearest of 2^20 rows
    # for each query of the bucket, read in place
    kb = KNN_BLOCKED_K
    X5 = E.T
    kv, ki = ops.topk_smallest(X5, kb)
    torch.cuda.synchronize()
    err = 0.0
    for i in range(0, Q, 128):
        pv, pi = ref.topk_smallest(X5[i:i + 128], kb)
        check(torch.equal(ki[i:i + 128], pi) and torch.equal(kv[i:i + 128],
                                                              pv),
              f"B5 main: rows {i}..{i + 127} differ from the plain version")
        err = max(err, float((kv[i:i + 128] - pv).abs().max()))
    del pv, pi
    R, n = X5.shape
    b, by = bound_ms(R * n, 4 * R * n + 8 * R * kb, peaks)
    kernels["B5"] = dict(
        name="topk_smallest", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_select.cu",
        replaces="src/repro/kernels/topk_select.py:22",
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.topk_smallest(X5, kb), 10),
        plain_ms=cuda_ms(torch, lambda: [ref.topk_smallest(
            X5[i:i + 128], kb) for i in range(0, R, 128)], 2),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.topk(X5, kb, dim=1,
                                                     largest=False), 3))
    kernels["B5"]["serve_ms"] = kernels["B5"]["ms"]
    # the two arms meet at k = 32: B4 + B5 and the fused B1 rank the same
    # distances, summed in the same order
    bv, bi = ops.topk_smallest(X5, TOPK_K_MAX)
    fv, fi = ops.distance_topk(A, Cq, TOPK_K_MAX)
    torch.cuda.synchronize()
    same_idx = int((bi == fi).sum())
    same_val = int((bv == fv).sum())
    print(f"[kernel] B5 topk_smallest R={R} n={n} k={kb} on B4's "
          f"transpose: indices and values equal the plain version's; at "
          f"k={TOPK_K_MAX} blocked vs fused B1: {same_idx} of {bi.numel()} "
          f"indices and {same_val} values bitwise equal")
    del E, X5, kv, ki, bv, bi, fv, fi

    # the blocked kNN arm past its byte budget: at N = 2^22 one bucket's
    # matrix would take 16 GiB, so the queries go through B4 and B5 in
    # chunks; sampled queries, chunk edges among them, against the plain
    # version
    N_big = 4 * KNN["n"]
    A_big = torch.randn((N_big, KNN["d"]), generator=gen).to(dev)
    step = max(1, dispatch.BLOCKED_BYTES // (4 * N_big))
    before = dict(ops.LAUNCHES)
    kv, ki = dispatch.distance_topk(A_big, Cq, kb, path="blocked")
    torch.cuda.synchronize()
    n_chunks = -(-Q // step)
    grew = {n: ops.LAUNCHES[n] - before[n] for n in before}
    check(grew["pairwise_sq_dist"] == grew["topk_smallest"] == n_chunks > 1,
          f"blocked kNN N={N_big}: launches {grew} for {n_chunks} chunks")
    sel = torch.tensor(sorted({*range(0, Q, 16), *(
        j for c0 in range(step, Q, step) for j in (c0 - 1, c0))}),
        device=dev)
    pv, pi = ref.distance_topk(A_big, Cq[sel], kb)
    dk, scale = pair_dist(A_big[ki[sel].long()], Cq[sel])
    dp, _ = pair_dist(A_big[pi.long()], Cq[sel])
    n_near = compare_ranked("blocked kNN chunked", ki[sel], pi,
                            near(dk, dp, scale), False)
    check(bool(near(kv[sel], pv, scale).all()),
          f"blocked kNN N={N_big}: values differ from the plain version")
    big_ms = cuda_ms(torch, lambda: dispatch.distance_topk(
        A_big, Cq, kb, path="blocked"), 3)
    print(f"[kernel] blocked kNN N={N_big} Q={Q} k={kb}: {n_chunks} chunks "
          f"of {step} queries (matrix budget {dispatch.BLOCKED_BYTES} "
          f"bytes), {big_ms:.4f} ms per bucket; {len(sel)} sampled queries "
          f"against the plain version, near_ties={n_near}")
    del A_big, kv, ki, pv, pi, dk, dp, scale

    # B9: one query at the GNB width, B3 at B = 1
    xg = Xg[0].contiguous()
    ks, ps = ops.gnb_scores(xg, mu, var, lp), ref.gnb_scores(xg, mu, var, lp)
    torch.cuda.synchronize()
    check(bool(torch.isclose(ks, ps, **TOL).all()),
          f"B9 main: scores differ by {float((ks - ps).abs().max())}")
    C = mu.shape[0]
    b, by = bound_ms(7 * C * d_g + C * d_g + C,
                     4 * (d_g + 2 * C * d_g + 2 * C), peaks)
    kernels["B9"] = dict(
        name="gnb_scores", route="cuda",
        source="src/repro_torch/kernels/csrc/gnb_score.cu",
        replaces="src/repro/kernels/gnb_score.py:20",
        max_abs_err=float((ks - ps).abs().max()),
        ms=cuda_ms(torch, lambda: ops.gnb_scores(xg, mu, var, lp), 200),
        plain_ms=cuda_ms(torch, lambda: ref.gnb_scores(xg, mu, var, lp),
                         200),
        bound_ms=b, bound_by=by, library_ms=None)
    print(f"[kernel] B9 gnb_scores C={C} d={d_g}: "
          f"max_abs_err={kernels['B9']['max_abs_err']:.3g}")
    for kr in kernels.values():
        kr["launches"] = 0
    for key, kr in kernels.items():
        lib = "none" if kr["library_ms"] is None else \
            f"{kr['library_ms']:.4f}"
        print(f"[time] {key} {kr['name']}: kernel {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']})")
    del A2, C2, Aq2

    # ------------------------------------------------ 3. the paths
    def drive(algo, data, groups, **kw):
        """Fit, warm every bucket and serve the queries, with the launch
        counts set to 0 just before and read just after."""
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
        check(bool(((res.classes >= 0) & (res.classes < groups)).all()),
              f"{algo}: a class outside [0, {groups})")
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
        return dict(est=est, res=res, res_ref=res_ref, launches=launches,
                    call_ms=call_ms, acc=acc, wall=wall,
                    n_buckets=len(warmed) + res.launches)

    def report(algo, keys, run, extra, bucket_ms=0.0):
        """One line per path: served q/s from the host clock, the share of
        a classify call that its kernels' device time (at the bucket
        shape, from CUDA events) accounts for, and each kernel's launches
        in the counted run.  A path without a kernel must launch none."""
        launches = run["launches"]
        counts = []
        for key in keys:
            kr = kernels[key]
            count = launches[kr["name"]]
            check(count > 0, f"{algo}: kernel {key} {kr['name']} was never "
                  "launched on the path")
            kr["launches"] += count
            counts.append(f"{key} launches={count} (kernel {kr['ms']:.4f} "
                          f"ms, plain {kr['plain_ms']:.4f} ms)")
        if not keys:
            check(not any(launches.values()),
                  f"{algo}: kernels ran on a path that has none: {launches}")
            counts.append("no kernel on this path (launches all 0)")
        host_ms, card_ms = run["call_ms"]
        share = (f", kernel time {4 * bucket_ms / host_ms:.3f} and "
                 f"{4 * bucket_ms / card_ms:.3f} of those") if keys else ""
        print(f"[path] {algo}: {N_QUERIES / host_ms * 1e3:.1f} q/s served "
              f"(classify of {N_QUERIES} in 4 buckets of {MAX_BATCH}: "
              f"{host_ms:.4f} ms from host memory, {card_ms:.4f} ms from "
              f"the card{share}), {', '.join(counts)}, "
              f"acc={run['acc']:.4f}, fit+warmup+serve {run['wall']:.2f}s; "
              f"{extra}")

    def knn_checks(what, run):
        """Neighbours against the ref arm, near-ties allowed; a class may
        differ only where the neighbours do."""
        res, res_ref = run["res"], run["res_ref"]
        check(run["acc"] >= 0.95, f"{what} accuracy {run['acc']}")
        Aq, Qq = run["est"].params.A, on_card(knn_data[2])
        dk, scale = pair_dist(Aq[res.aux.long()], Qq)
        dp, _ = pair_dist(Aq[res_ref.aux.long()], Qq)
        n_near = compare_ranked(f"{what} serve", res.aux, res_ref.aux,
                                near(dk, dp, scale), False)
        odd = res.classes != res_ref.classes
        check(bool((res.aux != res_ref.aux).any(1)[odd].all()),
              f"{what}: a class differs from the ref arm without a near-tie")
        return n_near, int(odd.sum())

    def kmeans_checks(what, run):
        """The fit against the ref arm's fit, assignments against ref."""
        est, res, res_ref = run["est"], run["res"], run["res_ref"]
        fit_ref = est_mod.make_fitted("kmeans", km_data[0], None,
                                      n_groups=KMEANS["K"], device=dev,
                                      path="ref")
        check(int(est.params.n_iter) == int(fit_ref.params.n_iter),
              f"{what}: {int(est.params.n_iter)} iterations, ref arm "
              f"{int(fit_ref.params.n_iter)}")
        check(torch.allclose(est.params.centroids, fit_ref.params.centroids,
                             **TOL), f"{what}: fitted centroids differ from "
              "the ref arm's")
        Qk, cen = on_card(km_data[2]), est.params.centroids
        dk, scale = (t[:, 0] for t in pair_dist(
            cen[res.classes.long()][:, None], Qk))
        dp, _ = pair_dist(cen[res_ref.classes.long()][:, None], Qk)
        n_near = compare_ranked(f"{what} serve", res.classes,
                                res_ref.classes, near(dk, dp[:, 0], scale),
                                False)
        check(bool(near(res.aux, res_ref.aux, scale).all()),
              f"{what}: assignment distances differ from the ref arm's")
        # the first K rows seed one centroid in each of the K blobs, so a
        # right fit assigns every query to its own blob
        check(run["acc"] >= 0.95, f"{what}: {run['acc']} of the queries in "
              "their blob")
        return int(est.params.n_iter), n_near

    def gauss_scale(X, mu, var):
        """Size of the terms of the GEMM-identity log-density (x² and x·mu
        over var, and the per-component constant): the rounding of a
        log-responsibility follows it, not the log-responsibility."""
        inv = 1.0 / var
        return (X * X) @ (0.5 * inv).T + X.abs() @ (mu * inv).abs().T + \
            0.5 * (mu * mu * inv + torch.log(var).abs() + math.log(
                2 * math.pi)).sum(1)

    def gmm_checks(what, run, Xq):
        """Log-responsibilities against the ref arm (the chunked E-step);
        a class may differ only where the ref arm's top two are a
        near-tie."""
        est, res, res_ref = run["est"], run["res"], run["res_ref"]
        p = est.params
        scale = gauss_scale(on_card(Xq), p.mu.float(), p.var.float())
        check(bool(torch.isfinite(res.aux).all()),
              f"{what}: a log-responsibility is not finite")
        diff = (res.aux - res_ref.aux).abs()
        check(bool((diff <= TOL["atol"] + TOL["rtol"] * scale).all()),
              f"{what}: log-responsibilities differ from the ref arm's by "
              f"{float(diff.max())}")
        odd = res.classes != res_ref.classes
        top2 = res_ref.aux.topk(2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]).abs() <= TOL["atol"] + \
            TOL["rtol"] * scale.max(1).values
        check(bool(tie[odd].all()),
              f"{what}: a class differs from the ref arm without a "
              "near-tie")
        return float(diff.max()), int(odd.sum()), int(p.n_iter)

    # kNN, k = 4: the fused B1
    run = drive("knn", knn_data, KNN["classes"])
    n_near, n_odd = knn_checks("knn", run)
    report("knn", ["B1"], run, f"near_ties={n_near}, classes differing at "
           f"near-ties={n_odd}", kernels["B1"]["serve_ms"])
    del run

    # kNN, k = 64: past B1's lists, the selector takes the blocked arm;
    # every bucket of the counted run goes through B4 then B5
    sizes = sorted({min(MAX_BATCH, 1 << i) for i in range(11)})
    arms = {dispatch.resolve("knn", "distance_topk", N=KNN["n"], d=KNN["d"],
                             Q=q, k=KNN_BLOCKED_K).name for q in sizes}
    check(arms == {"blocked"}, f"knn k={KNN_BLOCKED_K} resolves to {arms}")
    run = drive("knn", knn_data, KNN["classes"], k=KNN_BLOCKED_K)
    n_near, n_odd = knn_checks(f"knn k={KNN_BLOCKED_K}", run)
    ln = run["launches"]
    check(ln["pairwise_sq_dist"] == ln["topk_smallest"] == run["n_buckets"]
          and ln["distance_topk"] == 0,
          f"knn k={KNN_BLOCKED_K}: {run['n_buckets']} buckets, launches "
          f"{ln}: a bucket did not go through B4 and B5")
    report(f"knn k={KNN_BLOCKED_K}", ["B4", "B5"], run,
           f"all {run['n_buckets']} buckets through B4 then B5, no B1 and "
           f"no plain version, near_ties={n_near}, classes differing at "
           f"near-ties={n_odd}",
           kernels["B4"]["serve_ms"] + kernels["B5"]["serve_ms"])
    del run

    # K-Means: the fused B2, in the fit and in serving
    run = drive("kmeans", km_data, KMEANS["K"])
    n_iter, n_near = kmeans_checks("kmeans", run)
    report("kmeans", ["B2"], run, f"n_iter={n_iter} (ref arm the same), "
           f"near_ties={n_near}", kernels["B2"]["serve_ms"])
    del run

    # K-Means, blocked: REPRO_BACKEND selects B4 + min/argmin everywhere
    os.environ["REPRO_BACKEND"] = "blocked"
    try:
        run = drive("kmeans", km_data, KMEANS["K"])
    finally:
        del os.environ["REPRO_BACKEND"]
    check(run["launches"]["distance_argmin"] == 0,
          f"kmeans blocked: B2 ran {run['launches']['distance_argmin']} "
          "times")
    n_iter, n_near = kmeans_checks("kmeans blocked", run)
    report("kmeans blocked", ["B4"], run, f"REPRO_BACKEND=blocked, "
           f"n_iter={n_iter} (ref arm the same), near_ties={n_near}",
           kernels["B4"]["serve_ms_kmeans"])
    del run

    # GNB: scores against the ref arm, classes equal but at near-ties
    run = drive("gnb", gnb_data, GNB["classes"])
    res, res_ref = run["res"], run["res_ref"]
    check(run["acc"] >= 0.95, f"gnb accuracy {run['acc']}")
    check(torch.allclose(res.aux, res_ref.aux, **TOL),
          "gnb: scores differ from the ref arm's")
    odd = res.classes != res_ref.classes
    top2 = res_ref.aux.topk(2, dim=1).values
    check(bool(torch.isclose(top2[:, 0], top2[:, 1], **TOL)[odd].all()),
          "gnb: a class differs from the ref arm without a near-tie")
    report("gnb", ["B3"], run, f"classes differing at near-ties="
           f"{int(odd.sum())}", kernels["B3"]["serve_ms"])

    # B9's own entry, ops.gnb_scores: one query at a time against the
    # fitted moments, each equal to its row of the served batch
    singles = 16
    p = run["est"].params
    Xs = on_card(gnb_data[2][:singles])
    ops.reset_launches()
    one = [ops.gnb_scores(Xs[i], p.mu, p.var, p.log_prior)
           for i in range(singles)]
    torch.cuda.synchronize()
    b9 = dict(launches=dict(ops.LAUNCHES))
    check(b9["launches"]["gnb_scores"] == singles and
          sum(b9["launches"].values()) == singles,
          f"gnb one query: launches {b9['launches']} for {singles} calls")
    for i, s1 in enumerate(one):
        check(torch.allclose(s1, res.aux[i], **TOL),
              f"gnb one query: scores of query {i} differ from its batch "
              "row")
    n_launch = kernels["B9"]["launches"] = b9["launches"]["gnb_scores"]
    print(f"[path] gnb one query: ops.gnb_scores (B9) launches={n_launch} "
          f"(kernel {kernels['B9']['ms']:.4f} ms, plain "
          f"{kernels['B9']['plain_ms']:.4f} ms) for {singles} queries, "
          "scores equal to their rows of the served batch")
    del run, res, res_ref, one, Xs

    # GMM at the GNB width: EM on the chunked E-step, served through B3
    run = drive("gmm", gnb_data, GNB["classes"])
    check(run["acc"] >= 0.95, f"gmm wide: {run['acc']} of the queries in "
          "their blob")
    err, n_odd, n_iter = gmm_checks("gmm wide", run, gnb_data[2])
    report("gmm wide", ["B3"], run, f"n_iter={n_iter}, log-resp max diff "
           f"from the ref arm {err:.3g}, classes differing at near-ties="
           f"{n_odd}", kernels["B3"]["serve_ms"])
    del run

    # GMM at the kNN width: d < 64, the ref arm (no kernel)
    narrow = tuple(a[:GMM_NARROW_ROWS] for a in knn_data[:2]) + \
        knn_data[2:]
    run = drive("gmm", narrow, KNN["classes"])
    check(run["acc"] >= 0.95, f"gmm narrow: {run['acc']} of the queries "
          "in their blob")
    check(torch.equal(run["res"].classes, run["res_ref"].classes) and
          torch.equal(run["res"].aux, run["res_ref"].aux),
          "gmm narrow: the default arm differs from the ref arm")
    report("gmm narrow", [], run, f"n_iter={int(run['est'].params.n_iter)}"
           f", {GMM_NARROW_ROWS} training rows, equal to the ref arm")
    del run

    # RF at the reference's defaults: host CART, traversal in torch ops
    rf_data = (knn_data[0][:RF["n"]], knn_data[1][:RF["n"]]) + knn_data[2:]
    run = drive("rf", rf_data, KNN["classes"], n_trees=RF["trees"],
                max_depth=RF["depth"])
    check(run["acc"] >= 0.95, f"rf accuracy {run['acc']}")
    check(torch.equal(run["res"].classes, run["res_ref"].classes) and
          torch.equal(run["res"].aux, run["res_ref"].aux) and
          bool((run["res"].aux.sum(1) == RF["trees"]).all()),
          "rf: votes differ from the ref arm's or do not sum to the trees")
    report("rf", [], run, f"{RF['trees']} trees of depth <= {RF['depth']} "
           f"on {RF['n']} rows, traversal depth "
           f"{run['est']._depth}, votes equal to the ref arm")
    del run

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
