"""Performance monitor (reference: icl_core_performance_monitor).

Static registry of named timers and data series with prefix-based
enable/disable and summaries (PerformanceMonitor.h:95-106,
PerformanceMonitorMacros.h:47-112). The reference's PERF_MON_* macros map to:

    PERF_MON_INITIALIZE           -> initialize()
    PERF_MON_ENABLE(prefix)       -> enable(prefix)
    PERF_MON_START(timer)         -> start(timer)
    PERF_MON_PRINT_INFO_P         -> measure(timer, description, prefix)
    PERF_MON_SILENT_MEASURE_...   -> measure(..., silent=True) + start()
    PERF_MON_ADD_DATA_P           -> add_data(description, value, prefix)
    PERF_MON_SUMMARY_PREFIX_INFO  -> summary(prefix)

Device caveat: a measurement only covers completed device work if the caller
synchronizes; pass a jax array as `block_on` to block before reading the
clock.
"""
from __future__ import annotations

import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional


class PerformanceMonitor:
    _instance: Optional["PerformanceMonitor"] = None

    def __init__(self):
        self.enabled_prefixes = set()
        self.all_enabled = False
        self.timers: Dict[str, float] = {}
        self.data: Dict[str, List[float]] = defaultdict(list)
        self.events: List[str] = []

    @classmethod
    def instance(cls) -> "PerformanceMonitor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- control ---------------------------------------------------------
    @classmethod
    def initialize(cls, num_names: int = 0, num_events: int = 0) -> None:
        cls._instance = cls()

    def enable(self, prefix: str) -> None:
        self.enabled_prefixes.add(prefix)

    def disable(self, prefix: str) -> None:
        self.enabled_prefixes.discard(prefix)

    def enable_all(self, enabled: bool = True) -> None:
        self.all_enabled = enabled

    def _on(self, prefix: str) -> bool:
        return self.all_enabled or prefix in self.enabled_prefixes

    # -- timers ------------------------------------------------------------
    def start(self, timer_name: str) -> None:
        self.timers[timer_name] = time.perf_counter()

    def measure(
        self,
        timer_name: str,
        description: str,
        prefix: str = "",
        silent: bool = True,
        block_on=None,
        reset: bool = True,
    ) -> float:
        """Record elapsed ms under prefix::description; optionally restart."""
        if block_on is not None:
            import jax

            jax.block_until_ready(block_on)
        t0 = self.timers.get(timer_name)
        if t0 is None:
            return 0.0
        ms = (time.perf_counter() - t0) * 1e3
        if self._on(prefix):
            self.data[f"{prefix}::{description}"].append(ms)
            if not silent:
                self.events.append(f"{prefix}::{description}: {ms:.3f} ms")
        if reset:
            self.start(timer_name)
        return ms

    def add_data(self, description: str, value: float, prefix: str = "") -> None:
        if self._on(prefix):
            self.data[f"{prefix}::{description}"].append(float(value))

    # -- summaries -----------------------------------------------------------
    def summary(self, prefix: str = "") -> str:
        lines = []
        for key in sorted(self.data):
            if prefix and not key.startswith(prefix + "::"):
                continue
            vals = self.data[key]
            lines.append(
                f"{key}: n={len(vals)} avg={statistics.fmean(vals):.3f} "
                f"median={statistics.median(vals):.3f} "
                f"min={min(vals):.3f} max={max(vals):.3f}"
            )
        return "\n".join(lines)

    def series(self, description: str, prefix: str = "") -> List[float]:
        return list(self.data[f"{prefix}::{description}"])
