"""Straggler detection: a copy of the JAX package's
``runtime/straggler.py`` (plain Python).

``StepTimer`` keeps an EWMA of step wall-times per host and flags hosts
whose EWMA exceeds ``ratio_threshold`` x the fleet median for ``patience``
consecutive records.  With ONE host the fleet median is that host's own
EWMA, so the ratio would be identically 1.0: a lone host is compared with
a warmup-calibrated baseline instead, the mean of its first ``warmup``
step times, frozen once warmup completes.  A second host switches the
comparison back to the fleet median.  The advised action escalates:
watch -> checkpoint -> evict.

On the card the serving scheduler times each launch to a synchronize, and
its buckets differ in size, so a stream that starts on small buckets and
grows to large ones can raise ``watch`` verdicts that a CPU run does not.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List


@dataclass
class HostStats:
    ewma: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged_streak: int = 0
    warmup_sum: float = 0.0      # sum of the first ``warmup`` step times
    baseline: float = 0.0        # frozen warmup mean (single-host denom)


@dataclass
class StragglerVerdict:
    host: int
    ratio: float         # host EWMA / fleet median EWMA (or baseline)
    action: str          # "ok" | "watch" | "checkpoint" | "evict"


class StepTimer:
    def __init__(self, alpha: float = 0.2, ratio_threshold: float = 1.5,
                 patience: int = 5, warmup: int = 5):
        self.alpha = alpha
        self.threshold = ratio_threshold
        self.patience = patience
        self.warmup = warmup
        self.hosts: Dict[int, HostStats] = {}

    def _fleet_median(self) -> float:
        vals = sorted(s.ewma for s in self.hosts.values() if s.n > 0)
        if not vals:
            return 0.0
        mid = len(vals) // 2
        return vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    def record(self, host: int, step_time: float) -> StragglerVerdict:
        st = self.hosts.setdefault(host, HostStats())
        if st.n == 0:
            st.ewma = step_time
        st.ewma += self.alpha * (step_time - st.ewma)
        st.n += 1
        if st.n <= self.warmup:
            st.warmup_sum += step_time
            if st.n == self.warmup:
                st.baseline = st.warmup_sum / self.warmup
        if len(self.hosts) == 1:
            # one host: the fleet median is this host's own EWMA, so
            # compare with the frozen warmup baseline instead
            ratio = st.ewma / st.baseline if st.baseline > 0 else 1.0
        else:
            med = self._fleet_median()
            ratio = st.ewma / med if med > 0 else 1.0
        if ratio > self.threshold and st.n > self.warmup:
            st.flagged_streak += 1
        else:
            st.flagged_streak = 0
        if st.flagged_streak >= 2 * self.patience:
            action = "evict"
        elif st.flagged_streak >= self.patience:
            action = "checkpoint"
        elif st.flagged_streak > 0:
            action = "watch"
        else:
            action = "ok"
        return StragglerVerdict(host=host, ratio=ratio, action=action)

    def slowest_hosts(self, k: int = 3) -> List[int]:
        return sorted(self.hosts, key=lambda h: -self.hosts[h].ewma)[:k]
