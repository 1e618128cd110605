"""Where the time of B2 (distance -> argmin) and B8 (IVF-PQ ADC -> top-k)
goes: time cut-down copies of their CUDA kernels.

    python3 src/repro_torch/launch/ann_breakdown.py [--src DIR] [--new]

With ``--src DIR``, the design before the Hopper redesign of B2 and B8:
DIR is the ``src`` directory of a checkout whose ``distance_topk.cu``
still holds the one-row-a-thread ``argmin_kernel`` and whose
``adc_topk.cu`` holds the per-warp ``adc_dist_kernel`` that writes the
(Q, L) distance matrix for B5.  With ``--new``, this checkout's B2
(``distance_argmin.cu``) and fused B8 (``adc_topk.cu``).  The script
copies the sources, cuts each into variants by replacing whole
statements (``kernel_cuts.cut``: it stops if a statement is not found,
so it refuses any other design), builds every variant with nvcc for
sm_90a into ``kernels/build/breakdown/`` of this checkout, all at once,
and times each through its C entry point by CUDA events over 20 calls
(B8: 10) after two warm calls.

The data.  B2: the K-Means fit shape of ``chip_smoke.py`` (the first
262,144 of 266,240 seeded 256-class ``class_blobs`` rows, d = 21, seed
1, against their first 256 rows), and its first feature alone (d = 1, the ANN path's PQ
codebook fits) at 65,536 and 262,144 rows.  B8: the IVF-PQ ANN bucket of
``chip_smoke.py`` (``kernel_cuts.ann_fit``: Q = 1024, L = 32,768,
m = 21, 256 codes, k = 128), its LUTs, candidate codes and ids.

``--src`` B2 variants (``argmin_kernel``):
  base          the source as it is;
  no_zero_fill  rows and centroids staged only to the d features a chunk
                has, not zero-filled to 32;
  fmas_only     the staging loads cut (shared memory keeps what it
                holds), so the dot products and the selection alone;
and, as the floor of one read of the rows, ``torch.amin`` over A's rows.
``--src`` B8 variants (``adc_dist_kernel``):
  ids_only      every warp takes the padding path: the ids are read and
                the sentinel written, no code is read;
  no_lookup     the codes are staged and summed as they are, no LUT
                lookup;
  no_store      the lookups stay, the distance stores are cut;
  base          the source as it is;
and B5's int32 mode (``ops.topk_smallest``, this checkout) on the base
variant's matrix, k = 128.

``--new`` B2 variants (``distance_argmin.cu``), at the same shapes:
  base          the source as it is;
  no_select     the running (value, index) minimum replaced by a compare
                that never takes (the distances stay live);
``--new`` B8 variants (the fused ``adc_topk_kernel``), at the bucket:
  base          the source as it is;
  no_select     no key passes the threshold (ids, codes, lookups stay);
  no_lookup     the code bytes are summed as they are, no LUT lookup;
  ids_only      no code run is copied or summed: the ids' ring, the
                sentinels and the selection alone.

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

KM_ROWS, D, KM_K = 1 << 18, 21, 256
D1_ROWS = (1 << 16, 1 << 18)
N_QUERIES, BUCKET = 4096, 1024
REPS_B2, REPS_B8 = 20, 10

# ---- the design before the redesign (--src)
_AM_STAGE_A = ("for (int e = t; e < AM_ROWS * ADC; e += AM_ROWS) {\n"
               "                    const int r = e / ADC, j = e % ADC;\n"
               "                    a_s[r][j] = (row0 + r < N && j < dc)",
               "for (int e = t; e < AM_ROWS * dc; e += AM_ROWS) {\n"
               "                    const int r = e / dc, j = e % dc;\n"
               "                    a_s[r][j] = (row0 + r < N)")
_AM_STAGE_C = ("for (int e = t; e < KT * ADC; e += AM_ROWS) {\n"
               "                const int kk = e % KT, j = e / KT;\n"
               "                c_s[j][kk] = (kk < kt && j < dc)",
               "for (int e = t; e < KT * dc; e += AM_ROWS) {\n"
               "                const int kk = e % KT, j = e / KT;\n"
               "                c_s[j][kk] = (kk < kt)")
_AM_NO_LOAD_A = ("for (int e = t; e < AM_ROWS * ADC; e += AM_ROWS) {",
                 "for (int e = t; e < 0; e += AM_ROWS) {")
_AM_NO_LOAD_C = ("for (int e = t; e < KT * ADC; e += AM_ROWS) {",
                 "for (int e = t; e < 0; e += AM_ROWS) {")
_ADC_IDS_ONLY = ("if (!__any_sync(FULL, valid)) {", "if (true) {")
_ADC_NO_LOOKUP = ("s += table[(j - lo) * n_codes + code];", "s += code;")
_ADC_NO_STORE = [("if (live) out_q[t] = dmax;",
                  "if (live && t < 0) out_q[t] = dmax;"),
                 ("if (live) out_q[t] = valid ? s : dmax;",
                  "if (live && s == -12345) out_q[t] = valid ? s : dmax;")]

OLD_VARIANTS = {
    "distance_topk": dict(base=[], no_zero_fill=[_AM_STAGE_A, _AM_STAGE_C],
                          fmas_only=[_AM_NO_LOAD_A, _AM_NO_LOAD_C]),
    "adc_topk": dict(ids_only=[_ADC_IDS_ONLY], no_lookup=[_ADC_NO_LOOKUP],
                     no_store=_ADC_NO_STORE, base=[]),
}

# ---- this checkout's design (--new)
NEW_VARIANTS = {
    "distance_argmin": dict(
        base=[],
        no_select=[("if (ok[qi] && acc[qi][ri] < bv[ri]) {",
                    "if (acc[qi][ri] == -1.2345e-30f) {"),
                   ("if (acc < bv[r]) {", "if (acc == -1.2345e-30f) {")]),
    "adc_topk": dict(
        base=[],
        no_select=[("const bool pass = t < c_hi && key < tau;",
                    "const bool pass = t < c_hi && key == 0x0123456789ull;")],
        no_lookup=[("s += tq[b * ROW + byte_of(w, b)];",
                    "s += byte_of(w, b);")],
        ids_only=[("fetch(codes_q, t + FT, m, id1, r1);", ""),
                  ("if (id0 >= 0) {\n                const int o",
                   "if (false) {\n                const int o")]),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="the src directory of a checkout with the "
                                  "one-row-a-thread B2 and the matrix B8")
    ap.add_argument("--new", action="store_true",
                    help="time cut-down copies of this checkout's B2 and B8")
    args = ap.parse_args(argv)
    if args.src is None and not args.new:
        ap.error("give --src DIR, --new or both")
    import numpy as np
    import torch
    from kernel_cuts import (ann_bucket, ann_fit, build, card, cut,
                             events_ms, ptxas_line)
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    here_src = Path(__file__).resolve().parents[2]
    here = here_src / "repro_torch" / "kernels" / "csrc"
    out_dir = here.parent / "build" / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}     # (job, stem, variant) -> (edits, source, include dir)
    if args.src is not None:
        csrc = Path(args.src).resolve() / "repro_torch" / "kernels" / "csrc"
        for stem, variants in OLD_VARIANTS.items():
            for name, edits in variants.items():
                sources[("old", stem, name)] = (edits, csrc / f"{stem}.cu",
                                                csrc)
    if args.new:
        for stem, variants in NEW_VARIANTS.items():
            for name, edits in variants.items():
                sources[("new", stem, name)] = (edits, here / f"{stem}.cu",
                                                here)
    jobs = {}
    for key, (edits, path, include) in sources.items():
        stem = "_".join(key)
        src = out_dir / f"ann_{stem}.cu"
        src.write_text(cut(path.read_text(), edits))
        jobs[key] = (src, out_dir / f"ann_{stem}.so", include)
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    libs = {key: ctypes.CDLL(str(so)) for key, (_, so, _) in jobs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sys.path.insert(0, str(here_src))
    from repro_torch.data.datasets import class_blobs
    from repro_torch.kernels import ops

    X, _ = class_blobs(n=KM_ROWS + N_QUERIES, d=D, n_class=KM_K, seed=1)
    A = torch.from_numpy(np.ascontiguousarray(X[:KM_ROWS])).to(dev)
    A1 = A[:, :1].contiguous()
    shapes = {"kmeans_fit": (A, A[:KM_K].clone())}
    for n in D1_ROWS:
        shapes[f"d1_{n}"] = (A1[:n].contiguous(), A1[:KM_K].clone())
    est, queries, _ = ann_fit(dev, N_QUERIES)
    qlut, codes, cand, want = ann_bucket(est, queries[:BUCKET])
    del est
    Q, L, m = codes.shape
    n_codes = qlut.shape[1] // m
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    result = {"B2": {}, "B8": {}}

    def b2_call(lib, a, c, vals, idx, new):
        fn = lib.distance_argmin_f32
        if new:
            from repro_torch.kernels import distance_argmin as da
            way = da.route(a, c)
            grid = da.plan(a.shape[0], c.shape[0], sms, way)
            fn.argtypes = [P] * 4 + [I] * 5 + [P]
            args = (a.shape[0], c.shape[0], a.shape[1],
                    da.ROUTES.index(way), grid)
        else:
            fn.argtypes = [P] * 4 + [I] * 3 + [P]
            args = (a.shape[0], c.shape[0], a.shape[1])
        fn.restype = ctypes.c_int

        def call():
            err = fn(a.data_ptr(), c.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), *args, stream)
            if err:
                raise SystemExit(f"distance_argmin_f32: CUDA error {err}")
        return call

    def b8_call(lib, new):
        if new:
            from repro_torch.kernels import ann as kann
            n_splits, span = kann.plan(Q, L, want, sms)
            vals = torch.empty((Q, want), dtype=torch.int32, device=dev)
            idx = torch.empty((Q, want), dtype=torch.int32, device=dev)
            part = torch.empty((Q, n_splits * want), dtype=torch.int64,
                               device=dev) if n_splits > 1 else None
            fn = lib.adc_topk_i32
            fn.argtypes = [P] * 6 + [I] * 7 + [P]
            args = (qlut, codes, cand, vals, idx)
            tail = (None if part is None else part.data_ptr(), Q, L, m,
                    n_codes, want, n_splits, span)
        else:
            out = torch.empty((Q, L), dtype=torch.int32, device=dev)
            fn = lib.adc_dist_i32
            fn.argtypes = [P] * 4 + [I] * 4 + [P]
            args = (qlut, codes, cand, out)
            tail = (Q, L, m, n_codes)
        fn.restype = ctypes.c_int

        def call():
            err = fn(*(t.data_ptr() for t in args), *tail, stream)
            if err:
                raise SystemExit(f"B8: CUDA error {err}")
        return call, args[-1]

    for (job, stem, name), lib in libs.items():
        new = job == "new"
        if stem in ("distance_topk", "distance_argmin"):
            row = {}
            for label, (a, c) in shapes.items():
                vals = torch.empty((a.shape[0],), device=dev)
                idx = torch.empty((a.shape[0],), dtype=torch.int32,
                                  device=dev)
                row[f"{label}_ms"] = events_ms(
                    b2_call(lib, a, c, vals, idx, new), REPS_B2, warm=2)
            row["ptxas"] = ptxas_line(
                logs[(job, stem, name)],
                "argmin_wideILb1" if new else "argmin_kernel")
            result["B2"][f"{job}_{name}"] = row
        else:
            call, out = b8_call(lib, new)
            row = dict(ms=events_ms(call, REPS_B8, warm=2),
                       ptxas=ptxas_line(logs[(job, stem, name)],
                                        "adc_topk_kernelILb1" if new
                                        else "adc_dist_kernel"))
            if not new and name == "base":
                row["b5_int32_ms"] = events_ms(
                    lambda: ops.topk_smallest(out, want), REPS_B8, warm=2)
            result["B8"][f"{job}_{name}"] = row
            del out
    result["B2"]["amin_rows_ms"] = {
        label: events_ms(lambda: torch.amin(a, dim=1), REPS_B2, warm=2)
        for label, (a, _) in shapes.items()}
    print(json.dumps(dict(
        src=args.src and str(Path(args.src).resolve()), card=card(),
        torch=torch.__version__,
        shapes=dict(kmeans_fit=[KM_ROWS, KM_K, D],
                    d1=[[n, KM_K, 1] for n in D1_ROWS],
                    ann_bucket=dict(Q=Q, L=L, m=m, n_codes=n_codes, k=want,
                                    invalid=float((cand < 0).float().mean()))),
        **result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
