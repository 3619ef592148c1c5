"""Straggler detection and mitigation policy: a copy of
``repro.runtime.straggler``, which the serving scheduler's lane health
rides.

At 1000+ nodes, synchronous SPMD steps run at the pace of the slowest
host. The monitor keeps an EMA of per-host step durations and flags hosts
exceeding ``threshold`` x the fleet median; the mitigation policy is
(1) re-fetch input shards from a backup loader for flagged hosts (data
stalls dominate in practice), then (2) evict-and-replace through the
elastic replan path if a host stays flagged for ``evict_after`` checks.
"""
from __future__ import annotations

import dataclasses
import statistics


@dataclasses.dataclass
class HostStat:
    ema: float = 0.0
    n: int = 0
    flagged_streak: int = 0


class StragglerDetector:
    def __init__(self, decay: float = 0.9, threshold: float = 1.5,
                 evict_after: int = 3):
        self.decay = decay
        self.threshold = threshold
        self.evict_after = evict_after
        self.hosts: dict = {}

    def record(self, host: str, step_seconds: float):
        st = self.hosts.setdefault(host, HostStat())
        if st.n == 0:
            st.ema = step_seconds
        else:
            st.ema = self.decay * st.ema + (1 - self.decay) * step_seconds
        st.n += 1

    def forget(self, host: str):
        """Drop a host's accumulated state. Call when a lane is retired
        or quarantined: a lane out of the pool must stop contributing to
        the fleet median and must not be re-flagged by ``check()`` on
        stale EMAs — and when it probes back in, its record restarts
        from the first fresh sample (tests/test_runtime.py pins this)."""
        self.hosts.pop(host, None)

    def median_ema(self) -> float:
        vals = [s.ema for s in self.hosts.values() if s.n > 0]
        return statistics.median(vals) if vals else 0.0

    def check(self) -> dict:
        """Returns {host: action} where action is 'reshard_input' or
        'evict'. Updates flag streaks."""
        med = self.median_ema()
        actions = {}
        if med <= 0:
            return actions
        for host, st in self.hosts.items():
            if st.ema > self.threshold * med:
                st.flagged_streak += 1
                actions[host] = ("evict" if st.flagged_streak
                                 >= self.evict_after else "reshard_input")
            else:
                st.flagged_streak = 0
        return actions
