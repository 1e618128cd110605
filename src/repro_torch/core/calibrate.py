"""Calibration: refit the analytic cost model against measured rows.

The port's copy of the fitting half of the JAX package's
``core/calibrate.py`` (plain numpy, the same arithmetic).  The paper's
method is profile-then-optimize: measured per-query serve times are
joined to their ``serve_census`` op counts and bucket, one us-per-op
vector PER TIER (fp32-ref / fused / bf16 / int8 / grouped) is refit with
a per-launch overhead term amortised over the bucket, and the result is
a calibration entry (``results``, ``vectors``, ``summary``) that
``precision.CostModel.from_calibration`` turns into the model the path
selector consults (``dispatch.set_cost_model``, or ``REPRO_CALIBRATION``
naming a file that holds ``{"entries": [entry, ...]}``).

A row is a dict ``{"tier", "algorithm", "op", "bucket", "path",
"measured_us", "shape"}``: ``measured_us`` is microseconds a query,
``shape`` the estimator's ``serve_cost_shape()``.  The rows come from
measurements on the port's own device (``chip_smoke.py`` builds them
from its autotune timings); reading them from the port's benchmark
files, and writing a calibration file from them, come with those
benchmarks.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import precision


def fit_tier(rows: List[dict], iters: int = 2000
             ) -> Tuple[precision.BackendCosts, float, np.ndarray]:
    """Refit one us-per-op vector PLUS a per-launch overhead term to a
    tier's measured rows.

    The design matrix is the serve censuses augmented with a ``1/bucket``
    column: measured us/query amortises a fixed dispatch/launch cost over
    the batch, and a pure per-op model cannot express it.  Stage 1 solves
    the relative-error least squares directly (rows divided by their
    measurement so kernels spanning decades weigh equally); if the
    min-norm solution needs negative coefficients, stage 2 polishes the
    clipped solution with the same multiplicative log-space descent
    ``precision.fit_backend`` runs against paper Table 2, which keeps
    every coefficient nonnegative.  Returns (fitted us-per-op
    BackendCosts, launch_us, predictions)."""
    censuses = [precision.serve_census(r["algorithm"], r["shape"])
                for r in rows]
    y = np.array([r["measured_us"] for r in rows], dtype=np.float64)
    A = np.stack([c.vector() for c in censuses])
    if len(rows) == 1:
        # one row cannot constrain seven op costs plus an overhead: keep
        # the fpu seed scaled to reproduce the single measurement
        seed_vec = precision.BACKENDS["fpu"].vector()
        alpha = y[0] / max(float(A[0] @ seed_vec), 1e-12)
        fitted = precision.BackendCosts("us", *(seed_vec * max(alpha, 1e-12)))
        return fitted, 0.0, A @ fitted.vector()
    inv_b = np.array([1.0 / max(int(r["bucket"]), 1) for r in rows])
    A_aug = np.concatenate([A, inv_b[:, None]], axis=1)
    w, *_ = np.linalg.lstsq(A_aug / y[:, None], np.ones_like(y), rcond=None)
    c = np.clip(w, 0.0, None)
    rel = np.abs(A_aug @ c - y) / y
    if np.any(w < 0) and np.median(rel) > 0.05:
        logc = np.log(np.clip(c, 1e-12, None))
        for _ in range(iters):
            cc = np.exp(logc)
            resid = (A_aug @ cc - y) / y
            grad = (A_aug * cc[None, :]).T @ (resid / y)
            logc -= 0.05 * grad / (np.linalg.norm(grad) + 1e-12)
        c = np.exp(logc)
    fitted = precision.BackendCosts("us", *c[:-1])
    return fitted, float(c[-1]), A_aug @ c


def fit_calibration(rows: List[dict], iters: int = 2000) -> dict:
    """Per-tier refit over measured rows -> one calibration entry body:
    ``results`` (predicted-vs-measured per row), ``vectors`` (us-per-op
    per tier, plus its ``launch_us``), ``summary`` (fit errors and the
    us_per_cycle scale ``CostModel`` uses to convert the Eq. 15 overhead
    constants)."""
    results, vectors, tier_summary = [], {}, {}
    for tier in precision.CALIBRATION_TIERS:
        trows = [r for r in rows if r["tier"] == tier]
        if not trows:
            continue
        fitted, launch_us, pred = fit_tier(trows, iters=iters)
        errs = []
        for r, p in zip(trows, pred):
            rel = (float(p) - r["measured_us"]) / r["measured_us"]
            errs.append(abs(rel))
            results.append({"tier": tier, "algorithm": r["algorithm"],
                            "op": r["op"], "bucket": r["bucket"],
                            "path": r["path"],
                            "measured_us": r["measured_us"],
                            "predicted_us": float(p), "rel_err": rel})
        vectors[tier] = {op: float(v) for op, v in
                         zip(precision.OPS, fitted.vector())}
        # beside the OPS entries: the per-launch overhead in us, amortised
        # over the bucket (CostModel.from_calibration reads it)
        vectors[tier]["launch_us"] = float(launch_us)
        tier_summary[tier] = {"median_abs_rel_err": float(np.median(errs)),
                              "n": len(trows)}
    # us per analytic cycle from the fp32 hot rows: what rescales the
    # SHARD_LAUNCH / COLLECTIVE constants into measured-us units
    scales = [r["measured_us"] / precision.predicted_cycles(
                  precision.serve_census(r["algorithm"], r["shape"]),
                  precision.BACKENDS["fpu"])
              for r in rows if r["tier"] == "fused"]
    summary = {"tiers": tier_summary,
               "us_per_cycle": float(np.median(scales)) if scales else None,
               "n_rows": len(results)}
    return {"results": results, "vectors": vectors, "summary": summary}
