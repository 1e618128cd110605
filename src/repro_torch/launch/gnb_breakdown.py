"""Where the time of B3 (batched GNB scores) and B7 (int8 distance ->
argmin) goes: time cut-down copies of their CUDA kernels.

    python3 src/repro_torch/launch/gnb_breakdown.py [--src DIR] [--new]

With ``--src DIR``, the design before the Hopper redesign of B3: DIR is
the ``src`` directory of a checkout whose ``gnb_score.cu`` still holds
the (32 query x 8 class) tile kernel ``gnb_batch_kernel``, which stages
64-feature chunks of X, mu and var and takes ``logf`` of var in every
block.  With ``--new``, this checkout's B3 (a warp or more a query,
every class of a group in registers) and B7 (``q8_argmin_kernel`` of
``quantized.cu``: resident centroids, mma.sync dot products).  The
script copies the sources, cuts each into variants by replacing whole
statements (``kernel_cuts.cut``: it stops if a statement is not found,
so it refuses any other design), builds every variant with nvcc for sm_90a
into ``kernels/build/breakdown/`` of this checkout, all at once, and
times each through its C entry point by CUDA events over 200 calls
(B7 at the fit shape: 20) after two warm calls, and by the replay of a
CUDA graph of 20 calls (``lm_kernel_times.device_ms``: device time
alone).

The data: one GNB bucket of ``chip_smoke.py`` (B = 1024 queries, C = 10
classes, d = 784): the last 4096 of 64,000 seeded 10-class
``class_blobs`` rows (seed 2) are the queries, the first 60,000 fit the
moments (``fit_gnb``).  B7: the K-Means fit shape (the first 262,144 of
266,240 seeded 256-class rows, d = 21, seed 1, against their first 256
rows, on the centroids' int8 lattice) and one 1024-row serving bucket
of the last 4096.

``--src`` variants (``gnb_batch_kernel``):
  base        the source as it is;
  no_logf     log var not taken: var itself is staged in its place (as if
              log var came precomputed);
  no_div      each term multiplies by var where it divided;
  no_staging  X is not staged: each thread reads its query's feature
              from device memory in the loop;
  loop_only   only the first chunk is staged (X, mu, var, log var); the
              other chunks run the loop on what shared memory holds.
``--new`` variants (``gnb_scores_kernel<10>`` of this checkout):
  base        the source as it is;
  no_div      each term multiplies by var where it divided;
  no_logf     the class constants' log var terms are not taken;
  stage_only  no query is scored: the staging of mu and var, the class
              constants, the reduction and the stores alone.
``--new`` B7 variants (``q8_argmin_kernel``):
  base        the source as it is;
  no_select   the packed keys are neither formed nor compared (the dot
              products are still consumed);
  no_mma      the dot products are not taken (the fragments are loaded
              and summed as they are);
  no_a_loads  the rows' fragments are not loaded from device memory.

Each variant's ``ptxas -v`` line is printed beside its time.  Prints one
JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROWS, D, C = 60_000, 784, 10
KM_ROWS, KM_D, KM_K = 1 << 18, 21, 256
N_QUERIES, BUCKET = 4096, 1024
REPS, REPS_FIT = 200, 20

# ---- the design before the redesign (--src)
OLD_VARIANTS = dict(
    base=[],
    no_logf=[("lv_s[r][j] = logf(v);", "lv_s[r][j] = v;")],
    no_div=[("(diff * diff) / var_s[tx][j]", "(diff * diff) * var_s[tx][j]")],
    no_staging=[
        ("for (int e = tid; e < GBT * GDC; e += GCT * GBT) {",
         "for (int e = tid; e < 0; e += GCT * GBT) {"),
        ("const float diff = x_s[ty][j] - mu_s[tx][j];",
         "const float diff = X[(size_t)min(b0 + ty, B - 1) * d + f0 + j]"
         " - mu_s[tx][j];")],
    loop_only=[
        ("for (int e = tid; e < GBT * GDC; e += GCT * GBT) {",
         "for (int e = tid; f0 == 0 && e < GBT * GDC; e += GCT * GBT) {"),
        ("for (int e = tid; e < GCT * GDC; e += GCT * GBT) {",
         "for (int e = tid; f0 == 0 && e < GCT * GDC; e += GCT * GBT) {")],
)

# ---- this checkout's design (--new)
NEW_VARIANTS = dict(
    base=[],
    no_div=[("acc[c] += num[c] / den[c];", "acc[c] += num[c] * den[c];")],
    no_logf=[("lv[c] += logf(v[c].y) + LOG2PI;", "")],
    stage_only=[("if (b >= B) continue;", "continue;")],
)
NEW_B7_VARIANTS = dict(
    base=[],
    no_select=[("best[h] = min(best[h], min(acc[j][2 * h] * mul + cn[j].x, "
                "acc[j][2 * h + 1] * mul + cn[j].y));",
                "best[h] ^= acc[j][2 * h] + acc[j][2 * h + 1];")],
    no_mma=[("mma_s8(acc[j], a, p[0], p[4]);",
             "acc[j][0] += p[0]; acc[j][1] += p[4]; acc[j][2] += a[0]; "
             "acc[j][3] += a[1];")],
    no_a_loads=[("a_frag(a0, A, r, N, d, 0, tig);",
                 "a0[0] = a0[1] = a0[2] = a0[3] = r;")],
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="the src directory of a checkout with the "
                                  "tile B3 (gnb_batch_kernel)")
    ap.add_argument("--new", action="store_true",
                    help="time cut-down copies of this checkout's B3 and B7")
    args = ap.parse_args(argv)
    if args.src is None and not args.new:
        ap.error("give --src DIR, --new or both")
    import numpy as np
    import torch
    from kernel_cuts import build, card, cut, events_ms, ptxas_line
    from lm_kernel_times import device_ms
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    here_src = Path(__file__).resolve().parents[2]
    here = here_src / "repro_torch" / "kernels" / "csrc"
    out_dir = here.parent / "build" / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}     # (job, kernel, variant) -> (edits, source)
    if args.src is not None:
        csrc = Path(args.src).resolve() / "repro_torch" / "kernels" / "csrc"
        for name, edits in OLD_VARIANTS.items():
            sources[("old", "B3", name)] = (edits, csrc / "gnb_score.cu")
    if args.new:
        for name, edits in NEW_VARIANTS.items():
            sources[("new", "B3", name)] = (edits, here / "gnb_score.cu")
        for name, edits in NEW_B7_VARIANTS.items():
            sources[("new", "B7", name)] = (edits, here / "quantized.cu")
    jobs = {}
    for key, (edits, path) in sources.items():
        stem = "_".join(key)
        src = out_dir / f"gnb_{stem}.cu"
        src.write_text(cut(path.read_text(), edits))
        jobs[key] = (src, out_dir / f"gnb_{stem}.so", path.parent)
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    libs = {key: ctypes.CDLL(str(so)) for key, (_, so, _) in jobs.items()}
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sys.path.insert(0, str(here_src))
    from repro_torch.core.gnb import fit_gnb
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import quantized as qk
    from repro_torch.kernels import ref

    X, y = class_blobs(n=ROWS + N_QUERIES, d=D, n_class=C, seed=2)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    mu, var, lp = fit_gnb(on_card(X[:ROWS]), on_card(y[:ROWS]), C)
    Xb = on_card(X[ROWS:ROWS + BUCKET])
    want = ref.gnb_scores_batch(Xb, mu, var, lp)
    out = torch.empty((BUCKET, C), device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int

    def call(lib, new):
        fn = lib.gnb_scores_batch_f32
        fn.restype = ctypes.c_int
        if new:
            from repro_torch.kernels import gnb_score as gs
            split, chunk, grid = gs.plan(BUCKET, C, D, sms)
            fn.argtypes = [P] * 5 + [I] * 6 + [P]
            ptrs = (Xb, mu, var, lp, out)
            tail = (BUCKET, C, D, split, chunk, grid)
        else:
            fn.argtypes = [P] * 5 + [I] * 3 + [P]
            ptrs = (Xb, mu, var, lp, out)
            tail = (BUCKET, C, D)

        def run():   # on the current stream, so a graph captures it
            err = fn(*(t.data_ptr() for t in ptrs), *tail,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"gnb_scores_batch_f32: CUDA error {err}")
        return run

    Xk, _ = class_blobs(n=KM_ROWS + N_QUERIES, d=KM_D, n_class=KM_K, seed=1)
    Ak = on_card(Xk)
    scale = qk.feature_scales(Ak[:KM_K].abs().amax(0))
    C8 = qk.quantize_rows(Ak[:KM_K], scale)
    A8 = {"fit": qk.quantize_rows(Ak[:KM_ROWS], scale),
          "serve": qk.quantize_rows(Ak[KM_ROWS:KM_ROWS + BUCKET], scale)}
    del Ak
    want8 = {shape: ref.distance_argmin_q8(a, C8) for shape, a in A8.items()}

    def call8(lib, a):
        fn = lib.distance_argmin_q8
        fn.restype = ctypes.c_int
        fn.argtypes = [P] * 4 + [I] * 6 + [P]
        N = a.shape[0]
        vals = torch.empty((N,), dtype=torch.int32, device=dev)
        idx = torch.empty((N,), dtype=torch.int32, device=dev)
        tail = (N, KM_K, KM_D) + qk.argmin_plan(N, KM_K, KM_D, sms)

        def run():
            err = fn(a.data_ptr(), C8.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), *tail,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"distance_argmin_q8: CUDA error {err}")
        return run, (vals, idx)

    result = {"B3": {}, "B7": {}}
    for (job, kernel, name), lib in libs.items():
        log = logs[(job, kernel, name)]
        if kernel == "B3":
            run = call(lib, job == "new")
            run()
            torch.cuda.synchronize()
            result["B3"][f"{job}_{name}"] = dict(
                ms=events_ms(run, REPS, warm=2), device_ms=device_ms(run),
                max_abs_err=float((out - want).abs().max()),
                ptxas=ptxas_line(log, "gnb_scores_kernelILi10E" if job == "new"
                                 else "gnb_batch_kernel"))
            continue
        row = dict(ptxas=ptxas_line(log, "q8_argmin_kernel"))
        for shape, a in A8.items():
            run, got = call8(lib, a)
            run()
            torch.cuda.synchronize()
            row[shape] = dict(
                ms=events_ms(run, REPS_FIT if shape == "fit" else REPS,
                             warm=2),
                device_ms=device_ms(run),
                equal=all(torch.equal(g, w)
                          for g, w in zip(got, want8[shape])))
        result["B7"][f"{job}_{name}"] = row
    print(json.dumps(dict(
        src=args.src and str(Path(args.src).resolve()), card=card(),
        torch=torch.__version__, b3_shape=dict(B=BUCKET, C=C, d=D),
        b7_shapes=dict(fit=[KM_ROWS, KM_K, KM_D], serve=[BUCKET, KM_K, KM_D]),
        **result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
