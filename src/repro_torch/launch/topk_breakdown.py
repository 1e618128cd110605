"""Where the time of the split-N list design of B1 and B6 goes: time
cut-down copies of its partial kernels at the kNN shape.

    python3 src/repro_torch/launch/topk_breakdown.py --src DIR

DIR is the ``src`` directory of a checkout whose ``distance_topk.cu`` and
``quantized.cu`` still hold that design (per-thread sorted lists of k,
8 row lanes a block, 64-row tiles staged by element-wise loads; the port
before its Hopper redesign of B1 and B6).  The script copies the two
sources, cuts each into variants by replacing whole statements (it stops
if a statement is not found, so it refuses any other design), builds
every variant with nvcc for sm_90a into ``kernels/build/breakdown/`` of
this checkout, and times each through its C entry point at N = 2^20
rows, Q = 1024 queries, d = 21, k = 4 (random normal fp32 rows and
queries for B1, uniform int8 lattice rows for B6), by CUDA events over
20 calls after warm calls (helpers in ``kernel_cuts.py``).  The
variants:

  base       the source as it is;
  no_select  no row is ever inserted: the one compare per row stays,
             the sorted-list insertion never runs;
  no_stage   the staged tile is computed from the row and feature
             numbers instead of loaded from device memory (the shared
             stores and barriers stay);
  reg_lists  the lists are 4 long and indexed only by constants, so
             they live in registers (valid at k = 4 only);
  compute    no_select and no_stage together: dot products, norms,
             barriers and the merge kernel.

Each variant's ``ptxas -v`` line (registers, stack frame, spills) is
printed beside its time.  Prints one JSON line; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N, Q, D, K = 1 << 20, 1024, 21, 4
REPS = 20

# statement replacements, each (old, new); every old text must occur
_F32_SELECT = ("if (row < row_hi && !(dist > worst) &&",
               "if (row < row_hi && dist == -1.2345e-30f &&")
_Q8_SELECT = ("if (row < row_hi && rank_less(dist, row, worst, worst_i)) {",
              "if (row < row_hi && dist == -123456789 && "
              "rank_less(dist, row, worst, worst_i)) {")
_F32_STAGE = ("? A[(size_t)row * d + c0 + j] : 0.f;",
              "? (float)((row ^ (j * 40503)) & 1023) * 0.01f : 0.f;")
_Q8_STAGE = ("? row_word(A + (size_t)row * d, 4 * (w0 + w), d) : 0;",
             "? (int)((unsigned)row * 2654435761u ^ "
             "(unsigned)(w * 2246822507u)) : 0;")


def _reg_lists(t: str) -> list:
    """The replacements that keep lists of 4 in registers, for key type
    ``t``."""
    return [
        (f"{t} tv[TOPK_K_MAX];\n    int ti[TOPK_K_MAX];\n"
         "    for (int r = 0; r < TOPK_K_MAX; ++r) {",
         f"{t} tv[4];\n    int ti[4];\n#pragma unroll\n"
         "    for (int r = 0; r < 4; ++r) {"),
        ("                int p = k - 1;\n"
         "                while (p > 0 && rank_less(dist, row, tv[p - 1], "
         "ti[p - 1])) {\n"
         "                    tv[p] = tv[p - 1];\n"
         "                    ti[p] = ti[p - 1];\n"
         "                    --p;\n"
         "                }\n"
         "                tv[p] = dist;\n"
         "                ti[p] = row;\n"
         "                worst = tv[k - 1];\n"
         "                worst_i = ti[k - 1];",
         f"                {t} cv = dist;\n"
         "                int ci = row;\n"
         "#pragma unroll\n"
         "                for (int p = 0; p < 4; ++p) {\n"
         "                    if (rank_less(cv, ci, tv[p], ti[p])) {\n"
         f"                        const {t} sv = tv[p];\n"
         "                        const int si = ti[p];\n"
         "                        tv[p] = cv; ti[p] = ci; cv = sv; ci = si;\n"
         "                    }\n"
         "                }\n"
         "                worst = tv[3];\n"
         "                worst_i = ti[3];"),
        ("        for (int r = 0; r < k; ++r) {\n"
         "            part_v[base + r] = tv[r];",
         "#pragma unroll\n"
         "        for (int r = 0; r < 4; ++r) {\n"
         "            part_v[base + r] = tv[r];"),
    ]


VARIANTS = {
    "distance_topk": dict(base=[], no_select=[_F32_SELECT],
                          no_stage=[_F32_STAGE],
                          reg_lists=_reg_lists("float"),
                          compute=[_F32_SELECT, _F32_STAGE]),
    "quantized": dict(base=[], no_select=[_Q8_SELECT], no_stage=[_Q8_STAGE],
                      reg_lists=_reg_lists("int"),
                      compute=[_Q8_SELECT, _Q8_STAGE]),
}
ENTRY = {"distance_topk": "distance_topk_f32", "quantized": "distance_topk_q8"}


def old_split(n: int, q: int, sms: int):
    """The design's own planning: 64-row tiles, 32 queries a block, N
    split until about four blocks an SM."""
    q_tiles = -(-q // 32)
    tiles = -(-n // 64)
    want = max(1, min(tiles, -(-4 * sms // q_tiles)))
    rows = -(-tiles // want) * 64
    return -(-n // rows), rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of a checkout with the "
                         "split-N list design")
    args = ap.parse_args(argv)
    import torch
    from kernel_cuts import build, card, cut, events_ms, ptxas_line
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    csrc = Path(args.src).resolve() / "repro_torch" / "kernels" / "csrc"
    out_dir = Path(__file__).resolve().parents[1] / "kernels" / "build" / \
        "breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, variants in VARIANTS.items():
        text = (csrc / f"{stem}.cu").read_text()
        for name, edits in variants.items():
            src = out_dir / f"{stem}_{name}.cu"
            src.write_text(cut(text, edits))
            jobs[(stem, name)] = (src, out_dir / f"{stem}_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = {
        "distance_topk": (torch.randn((N, D), generator=gen, device=dev),
                          torch.randn((Q, D), generator=gen, device=dev),
                          torch.float32),
        "quantized": (torch.randint(-127, 128, (N, D), generator=gen,
                                    device=dev).to(torch.int8),
                      torch.randint(-127, 128, (Q, D), generator=gen,
                                    device=dev).to(torch.int8),
                      torch.int32)}
    n_splits, rows = old_split(N, Q, sms)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    result = {}
    for (stem, name), (_, lib_path) in jobs.items():
        a, c, vtype = inputs[stem]
        fn = getattr(ctypes.CDLL(str(lib_path)), ENTRY[stem])
        fn.argtypes = [P] * 6 + [I] * 6 + [P]
        fn.restype = ctypes.c_int
        part_v = torch.empty((Q, n_splits * 8 * K), dtype=vtype, device=dev)
        part_i = torch.empty((Q, n_splits * 8 * K), dtype=torch.int32,
                             device=dev)
        vals = torch.empty((Q, K), dtype=vtype, device=dev)
        idx = torch.empty((Q, K), dtype=torch.int32, device=dev)

        def call():
            err = fn(a.data_ptr(), c.data_ptr(), part_v.data_ptr(),
                     part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                     N, Q, D, K, n_splits, rows, stream)
            if err:
                raise SystemExit(f"{stem} {name}: CUDA error {err}")

        kernel = "q8_topk_partial_kernel" if stem == "quantized" else \
            "topk_partial_kernel"
        result.setdefault(stem, {})[name] = dict(
            ms=events_ms(call, REPS, warm=3),
            ptxas=ptxas_line(logs[(stem, name)], kernel))
    print(json.dumps(dict(src=str(Path(args.src).resolve()), card=card(),
                          torch=torch.__version__, shape=dict(N=N, Q=Q, d=D,
                                                              k=K),
                          splits=n_splits, rows_per_split=rows, reps=REPS,
                          variants=result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
