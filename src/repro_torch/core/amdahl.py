"""Amdahl's-law analysis (paper §5.3, Eq. 15) from the implementation's own
parallel/sequential op split: the port's copy of the JAX package's
``core/amdahl.py``.

The paper profiles the sequential fraction of each kernel and reports the
resulting theoretical speedup next to the measured one (Table 3). Here the
parallel/sequential split comes from the censuses in core/precision.py, and
a simple non-ideality model (barrier cost + I$ warmup per core) explains the
gap between the Amdahl bound and the paper's measured speedups.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.precision import BackendCosts, Census, predicted_cycles


def amdahl_speedup(p: float, n: int) -> float:
    """Eq. 15: 1 / ((1-p) + p/n)."""
    return 1.0 / ((1.0 - p) + p / n)


@dataclass
class ParallelModel:
    """Predicted parallel behaviour for one kernel on one backend."""

    kernel: str
    backend: str
    seq_cycles_1: float
    par_cycles_1: float
    p: float                    # parallel fraction of single-core time
    theoretical_speedup: float  # Amdahl at n cores
    predicted_speedup: float    # with overheads
    predicted_cycles_n: float


# per-barrier cost (Event Unit HW barrier) and per-core I$ warmup penalty
BARRIER_CYCLES = 40.0
N_BARRIERS = {"svm": 2, "lr": 2, "gnb": 2, "knn": 2, "kmeans_iter": 2, "rf": 1}
ICACHE_WARMUP = {"libgcc": 600.0, "rvfplib": 400.0, "fpu": 60.0,
                 "cortex-m4": 0.0}
# PULP-OPEN shares 4 FPnew instances among 8 cores (paper §3.3): with all 8
# cores issuing FP, APU arbitration stalls inflate the parallel section in
# proportion to the kernel's FP-cycle fraction — the paper's own "FLOP
# intensity" explanation of why GNB scales to 6.56x but RF to 6.82x.
FPU_CONTENTION_SLOPE = 0.25


def _fp_cycle_fraction(census: Census, backend: BackendCosts) -> float:
    v = census.vector("parallel")
    c = backend.vector()
    fp = float(v[:5] @ c[:5])          # add/mul/div/cmp/exp
    total = float(v @ c)
    return fp / total if total > 0 else 0.0


def analyze_parallel(census: Census, backend: BackendCosts, n_cores: int = 8,
                     kernel: str = "", iters: float = 1.0) -> ParallelModel:
    seq = predicted_cycles(census, backend, "sequential") * iters
    par = predicted_cycles(census, backend, "parallel") * iters
    total1 = seq + par
    p = par / total1
    theor = amdahl_speedup(p, n_cores)
    overhead = (N_BARRIERS.get(kernel or census.name, 2) * BARRIER_CYCLES
                + ICACHE_WARMUP.get(backend.name.replace("-fit", ""), 300.0)
                ) * iters
    contention = 1.0
    if backend.name.startswith("fpu") and n_cores > 4:
        contention = 1.0 + FPU_CONTENTION_SLOPE * _fp_cycle_fraction(
            census, backend)
    cycles_n = seq + par / n_cores * contention + overhead
    return ParallelModel(
        kernel=kernel or census.name,
        backend=backend.name,
        seq_cycles_1=seq,
        par_cycles_1=par,
        p=p,
        theoretical_speedup=theor,
        predicted_speedup=total1 / cycles_n,
        predicted_cycles_n=cycles_n,
    )


def speedup_table(censuses: Dict[str, Census], backends: Dict[str, BackendCosts],
                  n_cores: int = 8, iters: Dict[str, float] | None = None):
    """Cross-product table for benchmarks/parallel_speedup.py."""
    iters = iters or {}
    rows = []
    for kname, census in censuses.items():
        for bname, backend in backends.items():
            rows.append(analyze_parallel(census, backend, n_cores,
                                         kernel=kname,
                                         iters=iters.get(kname, 1.0)))
    return rows
