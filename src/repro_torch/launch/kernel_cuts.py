"""Helpers of the scripts that time the port's kernels and cut-down copies
of them (``topk_breakdown.py``, ``blocked_breakdown.py``,
``knn_kernel_times.py``, ``ann_breakdown.py``, ``ann_kernel_times.py``):
cut a kernel source into a variant, build it with nvcc for sm_90a, read
its ``ptxas -v`` line, time calls by CUDA events, name the card, and
fit the IVF-PQ ANN path of ``chip_smoke.py`` and form one bucket's B8
inputs.

The scripts run as files (``python3 src/repro_torch/launch/<script>.py``)
and import this module from their own directory, so that a script may
import ``repro_torch`` from another checkout.
"""
from __future__ import annotations

import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Iterable, Optional, Tuple

NVCC = "/usr/local/cuda/bin/nvcc"
# the ANN path of chip_smoke.py: 2^18 seeded 256-class blob rows (d = 21,
# seed 3), 256 cells, m = 21 (dsub 1), 256 codes, k = 10, refine 128,
# nprobe 16, 10 training iterations
ANN_FIT = dict(n=1 << 18, d=21, classes=256, cells=256, pq_m=21,
               n_codes=256, k=10, refine=128, nprobe=16, train_iters=10)


def cut(text: str, edits: Iterable[Tuple[str, str]]) -> str:
    """Apply (old, new) replacements, each to the first occurrence of
    ``old``; a run of white space in ``old`` matches any run of white
    space, so a source that was only reformatted still takes the cut.
    Stops the script if an ``old`` is not found: the source is not the
    design the variant was written for."""
    for old, new in edits:
        pattern = r"\s+".join(re.escape(tok) for tok in old.split())
        text, n = re.subn(pattern, lambda _: new, text, count=1)
        if not n:
            raise SystemExit(f"not the design this script cuts: "
                             f"{old.strip()[:60]!r} not found")
    return text


def build(src: Path, out: Path, include: Optional[Path] = None) -> str:
    """nvcc ``src`` into the shared library ``out`` for sm_90a; returns
    ptxas's verbose log (its standard error)."""
    cmd = [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    if include is not None:
        cmd += ["-I", str(include)]
    proc = subprocess.run(cmd + ["-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for {src.name}:\n{proc.stderr}")
    return proc.stderr


def ptxas_line(log: str, kernel: str) -> str:
    """The registers/stack line ptxas printed for ``kernel``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 6]:
                if "registers" in nxt:
                    return " ".join(nxt.split())
    return "not found"


def events_ms(fn: Callable[[], object], reps: int, warm: int = 1) -> float:
    """Mean device time of one call over ``reps`` calls after ``warm``
    calls, from CUDA events on the current stream."""
    import torch
    for _ in range(warm):
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


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def ann_fit(dev, n_queries: int):
    """(fitted ANN estimator, its (n_queries, d) fp32 queries on the card,
    the fit's host-clock seconds), from ``repro_torch`` as found on the
    path: ``ANN_FIT`` on seeded ``class_blobs``."""
    import numpy as np
    import torch
    from repro_torch.core import estimator as est_mod
    from repro_torch.data.datasets import class_blobs
    f = ANN_FIT
    X, y = class_blobs(n=f["n"] + n_queries, d=f["d"],
                       n_class=f["classes"], seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = est_mod.make_fitted(
        "ann", X[:f["n"]], y[:f["n"]], n_groups=f["classes"], device=dev,
        k=f["k"], n_cells=f["cells"], nprobe=f["nprobe"], pq_m=f["pq_m"],
        n_codes=f["n_codes"], refine=f["refine"],
        train_iters=f["train_iters"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    queries = torch.from_numpy(np.ascontiguousarray(X[f["n"]:])).to(dev)
    return est, queries, fit_s


def ann_bucket(est, Xb):
    """B8's inputs for the bucket Xb as ``core/ann.ann_classify_batch``
    forms them: (query LUTs, candidate codes, candidate ids, k =
    max(k, refine))."""
    from repro_torch.core.ann import build_query_luts
    from repro_torch.kernels import ops
    p = est.params
    _, probed = ops.distance_topk(p.centroids, Xb, est.nprobe)
    cand = p.cell_ids[probed.long()].reshape(Xb.shape[0], -1).contiguous()
    codes = p.codes[cand.clamp(min=0).long()].contiguous()
    return (build_query_luts(Xb, p.codebooks), codes, cand,
            max(est.k, est.refine))
