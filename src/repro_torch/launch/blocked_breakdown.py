"""Where the time of the blocked kNN arm's two kernels goes: time cut-down
copies of B5 (top-k selection, ``topk_select.cu``) and B4 (squared-distance
matrix, ``pairwise_sq_dist.cu``) of the port, and of B1's 8 x 8 micro-tile
arithmetic without its selection.

    python3 src/repro_torch/launch/blocked_breakdown.py [--src DIR] [--new]

With ``--src DIR``, the design before the Hopper redesign of B5 and B4:
DIR is the ``src`` directory of a checkout that still holds that B5 and
B4 (one block per row and three or four radix passes over it; a 4 x 4
register micro-tile with stores at the end of each block) and B1's Hopper
design (its 8 x 8 micro-tile).  With ``--new``, this checkout's B4 and
B5.  The script copies the sources, cuts each into variants by replacing
whole statements (``kernel_cuts.cut``: it stops if a statement is not
found, so it refuses any other design), builds every variant with nvcc
for sm_90a into ``kernels/build/breakdown/`` of this checkout, all at
once, and times each through its C entry point by CUDA events over 10
calls after two warm calls.

The data: 2^20 seeded ``class_blobs`` rows (d = 21, 3 classes) and
1024 queries from the same blobs, the kNN k = 64 path's bucket.  B5 reads
the (1024, 2^20) matrix of their squared distances (computed once by
torch in fp32), k = 64; B4 writes that matrix column-major.

``--src`` B5 variants:
  base          the source as it is;
  count         base, and each row's number of radix passes written into
                its first index (printed: passes per row);
  no_gather     the gather read is cut (the radix passes alone);
  one_pass      only the first radix pass (histogram of the top 12 bits);
  one_pass_no_atomic  that pass with its shared atomicAdd replaced by a
                compare that never stores (the read and the key alone).
  At R = 16 (the first 16 rows): base and one_pass with one block a row,
  and one_pass and base on the same bytes cut into 8 segments a row
  (128 rows of 2^17), i.e. eight blocks a row without their merge.
``--src`` B4 variants:
  base          the source as it is;
  no_stores     the store of each value replaced by a compare that never
                stores (the value stays live);
  stores_only   the FMA loop cut (staging, norms and stores stay);
  stores_bare   stores_only with the staging loads replaced by numbers
                computed from the indices;
  b1_tile       B1 (``distance_topk.cu``, bulk route) at the same shape
                with its selection cut (every distance compared with a
                value none takes): the 8 x 8 micro-tile arithmetic
                without any store epilogue, k = 4.
Library references on the same tensors: ``fill_`` of the (1024, 2^20)
matrix (a write of its bytes) and ``amax`` over its rows (a read).

``--new`` B4 variants, column-major at the kNN shape and row-major at the
K-Means fit shape (262,144 rows, 256 centroids); both pitches are 16-byte
aligned, so every variant stores by TMA:
  base          the source as it is;
  no_fma        the feature loop cut (staging, norms, epilogue stay);
  no_stores     the TMA and element stores to E cut (the tile still goes
                through the staging buffers and their barriers, so every
                value stays live);
and B5's filter route on the same (1024, 2^20) matrix, k = 64:
  base          the source as it is;
  stream_only   no element passes the threshold's compare (the loads,
                the compare and the barrier of each stage stay; no merge).

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

N, Q, D, K5, CLASSES = 1 << 20, 1024, 21, 64, 3
REPS = 10

_GATHER = ("if (tid == 0) gathered = 0;\n        __syncthreads();\n"
           "        for (int base = 0; base < n;",
           "if (tid == 0) gathered = 0;\n        __syncthreads();\n"
           "        for (int base = 0; base < 0;")
_GATHER_IDX = ("const int e = (int)(unsigned int)keys[j];",
               "const int e = (int)((unsigned int)keys[j] % (unsigned)n);")
_ONE_PASS = ("if (exact || shift == 0) break;", "break;")
_NO_ATOMIC = ("atomicAdd(&hist[(unsigned int)(key >> nshift) & mask], 1u);",
              "if (key == 0x0123456789ull) "
              "hist[(unsigned int)(key >> nshift) & mask] = 1u;")
_COUNT = [("bool after = false;", "bool after = false; int npass = 0;"),
          ("if (exact || shift == 0) break;",
           "++npass;\n            if (exact || shift == 0) break;"),
          ("        last = keys[t - 1];",
           "        __syncthreads();\n"
           "        if (tid == 0) out_i[0] = npass;\n"
           "        last = keys[t - 1];")]
_NO_STORE = ("E[(size_t)s * nf + f] = (an - 2.0f * acc[i][q]) + cn;",
             "{ const float v_ = (an - 2.0f * acc[i][q]) + cn;\n"
             "                  if (v_ == -1.2345e-30f) "
             "E[(size_t)s * nf + f] = v_; }")
_NO_FMA = ("for (int j = 0; j < dc; ++j) {\n            const float4 sv",
           "for (int j = 0; j < 0; ++j) {\n            const float4 sv")
_NO_STAGE = [("? F[(size_t)(f0 + r) * d + j0 + j] : 0.f;",
              "? (float)(((f0 + r) ^ (j * 40503)) & 1023) * 0.01f : 0.f;"),
             ("? S[(size_t)(s0 + r) * d + j0 + j] : 0.f;",
              "? (float)(((s0 + r) ^ (j * 40503)) & 1023) * 0.01f : 0.f;")]
_B1_NO_SELECT = ("any |= !(acc[qi][ri] > tau[qi]);",
                 "any |= acc[qi][ri] == -1.2345e-30f;")

VARIANTS = {
    "topk_select": dict(
        base=[], count=_COUNT, no_gather=[_GATHER, _GATHER_IDX],
        one_pass=[_ONE_PASS, _GATHER, _GATHER_IDX],
        one_pass_no_atomic=[_ONE_PASS, _GATHER, _GATHER_IDX, _NO_ATOMIC]),
    "pairwise_sq_dist": dict(
        base=[], no_stores=[_NO_STORE], stores_only=[_NO_FMA],
        stores_bare=[_NO_FMA] + _NO_STAGE),
    "distance_topk": dict(b1_tile=[_B1_NO_SELECT]),
}
NEW_B5_VARIANTS = dict(
    base=[],
    stream_only=[("any |= !(v[4 * u + q] > lim);",
                  "any |= v[4 * u + q] == T(-12345);"),
                 ("const int e = static_cast<int>(static_cast<unsigned>"
                  "(keys[j]));", "const int e = 0;")])
NEW_VARIANTS = dict(
    base=[],
    no_fma=[("dtile::dots<true>(a_s, d, c_t, d, tq, tr, acc);", "")],
    no_stores=[("hop::tma_store_2d(tm_e, buf, minor0, first);", ""),
               ("__stcs(E + (first + l) * pitch + minor0 + c, "
                "buf[l * LINE + c]);", "{}")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src",
                    help="the src directory of a checkout with the radix "
                         "B5, the 4 x 4 B4 and the 8 x 8 B1")
    ap.add_argument("--new", action="store_true",
                    help="time cut-down copies of this checkout's B4 and B5")
    args = ap.parse_args(argv)
    if args.src is None and not args.new:
        ap.error("give --src DIR, --new or both")
    import numpy as np
    import torch
    from kernel_cuts import build, card, cut, events_ms, ptxas_line
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    here_src = Path(__file__).resolve().parents[2]
    here = here_src / "repro_torch" / "kernels" / "csrc"
    out_dir = here.parent / "build" / "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}     # (job, variant) -> (edits, source, include dir)
    if args.src is not None:
        csrc = Path(args.src).resolve() / "repro_torch" / "kernels" / "csrc"
        for stem, variants in VARIANTS.items():
            for name, edits in variants.items():
                sources[(stem, name)] = (edits, csrc / f"{stem}.cu", csrc)
    if args.new:
        for job, stem, variants in (("new", "pairwise_sq_dist", NEW_VARIANTS),
                                    ("new_b5", "topk_select",
                                     NEW_B5_VARIANTS)):
            for name, edits in variants.items():
                sources[(job, name)] = (edits, here / f"{stem}.cu", here)
    jobs = {}
    for (job, name), (edits, path, include) in sources.items():
        src = out_dir / f"{job}_{name}.cu"
        src.write_text(cut(path.read_text(), edits))
        jobs[(job, name)] = (src, out_dir / f"{job}_{name}.so", include)
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    libs = {key: ctypes.CDLL(str(so)) for key, (_, so, _) in jobs.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sys.path.insert(0, str(here_src))
    from repro_torch.data.datasets import class_blobs
    X, _ = class_blobs(n=N + Q, d=D, n_class=CLASSES, seed=0)
    A = torch.from_numpy(np.ascontiguousarray(X[:N])).to(dev)
    C = torch.from_numpy(np.ascontiguousarray(X[N:])).to(dev)
    E = ((C * C).sum(1)[:, None] - 2.0 * (C @ A.T)) + (A * A).sum(1)[None]
    out = torch.empty((Q, N), device=dev)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream().cuda_stream
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    result = {}

    def timed(call):
        return events_ms(call, REPS, warm=2)

    if args.src is not None:
        result.update(B5={}, B4={})

        def topk_call(lib, x, R, n, ld, k, vals, idx):
            fn = lib.topk_smallest_f32
            fn.argtypes = [P, LL, I, I, I, P, P, P]
            fn.restype = ctypes.c_int

            def call():
                err = fn(x.data_ptr(), ld, R, n, k, vals.data_ptr(),
                         idx.data_ptr(), stream)
                if err:
                    raise SystemExit(f"topk_smallest_f32: CUDA error {err}")
            return call

        def b5(name, x, R, n, ld, k=K5):
            vals = torch.empty((R, k), device=dev)
            idx = torch.empty((R, k), dtype=torch.int32, device=dev)
            call = topk_call(libs[("topk_select", name)], x, R, n, ld, k,
                             vals, idx)
            return timed(call), idx

        for name in VARIANTS["topk_select"]:
            ms, idx = b5(name, E, Q, N, N)
            row = dict(ms=ms, ptxas=ptxas_line(logs[("topk_select", name)],
                                              "topk_kernel"))
            if name == "count":
                passes = idx[:, 0].float()
                row["passes_per_row"] = dict(mean=float(passes.mean()),
                                             min=int(passes.min()),
                                             max=int(passes.max()))
            result["B5"][name] = row
        x16 = E[:16].contiguous()
        seg = N // 8
        result["B5"]["R16"] = {
            "base_one_block_a_row": b5("base", x16, 16, N, N)[0],
            "one_pass_one_block_a_row": b5("one_pass", x16, 16, N, N)[0],
            "base_eight_blocks_a_row": b5("base", x16, 128, seg, seg)[0],
            "one_pass_eight_blocks_a_row": b5("one_pass", x16, 128, seg,
                                              seg)[0]}
        del x16

        # B4, column-major as the kNN arm writes it
        for name in VARIANTS["pairwise_sq_dist"]:
            fn = libs[("pairwise_sq_dist", name)].pairwise_sq_dist_f32
            fn.argtypes = [P] * 3 + [I] * 4 + [P]
            fn.restype = ctypes.c_int

            def call():
                err = fn(A.data_ptr(), C.data_ptr(), out.data_ptr(), N, Q, D,
                         1, stream)
                if err:
                    raise SystemExit(f"pairwise_sq_dist_f32: CUDA error "
                                     f"{err}")
            result["B4"][name] = dict(
                ms=timed(call),
                ptxas=ptxas_line(logs[("pairwise_sq_dist", name)],
                                 "pairwise_kernel"))
        # B1's arithmetic without its selection, planned as B1's wrapper
        q_tiles = -(-Q // 128)
        want = max(1, -(-2 * sms // q_tiles))
        rows = -(-(-(-N // want)) // 32) * 32
        n_splits = -(-N // rows)
        k1 = 4
        part_v = torch.empty((Q, n_splits * k1), device=dev)
        part_i = torch.empty((Q, n_splits * k1), dtype=torch.int32,
                             device=dev)
        vals = torch.empty((Q, k1), device=dev)
        idx = torch.empty((Q, k1), dtype=torch.int32, device=dev)
        fn = libs[("distance_topk", "b1_tile")].distance_topk_f32
        fn.argtypes = [P] * 6 + [I] * 7 + [P]
        fn.restype = ctypes.c_int

        def b1_call():
            err = fn(A.data_ptr(), C.data_ptr(), part_v.data_ptr(),
                     part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(), N,
                     Q, D, k1, n_splits, rows, 1, stream)
            if err:
                raise SystemExit(f"distance_topk_f32: CUDA error {err}")
        result["B4"]["b1_tile"] = dict(
            ms=timed(b1_call),
            ptxas=ptxas_line(logs[("distance_topk", "b1_tile")],
                             "topk_partial_kernel"))

    if args.new:
        A2 = A[:1 << 18].contiguous()
        C2 = A2[:256].clone()
        out2 = torch.empty((1 << 18, 256), device=dev)
        result["B4_new"] = {}
        for name in NEW_VARIANTS:
            fn = libs[("new", name)].pairwise_sq_dist_f32
            fn.argtypes = [P] * 3 + [I] * 6 + [P]
            fn.restype = ctypes.c_int
            row = dict(ptxas=ptxas_line(logs[("new", name)],
                                        "pairwise_kernelILb1ELb1ELb1E"))
            for label, a, c, e, a_fast in (("knn", A, C, out, 1),
                                           ("kmeans_fit", A2, C2, out2, 0)):
                n_a, n_c = a.shape[0], c.shape[0]
                # the grid of kernels/pairwise_sq_dist.plan (q_tiles <= 264)
                q_tiles = -(-n_c // 128)
                grid = q_tiles * min(-(-n_a // 128), 2 * sms // q_tiles)

                def call():
                    err = fn(a.data_ptr(), c.data_ptr(), e.data_ptr(), n_a,
                             n_c, D, a_fast, 1, grid, stream)
                    if err:
                        raise SystemExit(f"new B4 {name}: CUDA error {err}")
                row[f"{label}_ms"] = timed(call)
            result["B4_new"][name] = row
        result["B5_new"] = {}
        vals = torch.empty((Q, K5), device=dev)
        idx = torch.empty((Q, K5), dtype=torch.int32, device=dev)
        for name in NEW_B5_VARIANTS:
            fn = libs[("new_b5", name)].topk_smallest_f32
            fn.argtypes = [P, LL, I, I, I, P, P, P, I, I, I, P]
            fn.restype = ctypes.c_int

            def call():
                err = fn(E.data_ptr(), N, Q, N, K5, vals.data_ptr(),
                         idx.data_ptr(), None, 1, N, 1, stream)
                if err:
                    raise SystemExit(f"new B5 {name}: CUDA error {err}")
            result["B5_new"][name] = dict(
                ms=timed(call),
                ptxas=ptxas_line(logs[("new_b5", name)], "filter_kernelIf"))
    result["library"] = dict(
        fill_ms=timed(lambda: out.fill_(1.0)),
        amax_ms=timed(lambda: torch.amax(E, dim=1)))
    print(json.dumps(dict(src=args.src and str(Path(args.src).resolve()),
                          card=card(), torch=torch.__version__,
                          shape=dict(N=N, Q=Q, d=D, k=K5), reps=REPS,
                          **result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
