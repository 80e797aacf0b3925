"""Lightweight metrics + profiling hooks.

The reference's observability is logs + a per-response `time` field only
(SURVEY.md §5: no metrics export, no profiler). Here:

  - process-wide counters/timers exposed at GET /api/stats;
  - `profile_trace()` wraps a block in a jax.profiler trace when
    MEMEX_PROFILE=<dir> is set (XLA device timeline).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = defaultdict(int)
        self._timings: dict[str, list[float]] = defaultdict(list)
        self._started = time.time()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                window = self._timings[name]
                window.append(dt)
                if len(window) > 1024:  # bounded ring
                    del window[: len(window) - 1024]

    def snapshot(self) -> dict:
        with self._lock:
            timings = {}
            for name, window in self._timings.items():
                if not window:
                    continue
                s = sorted(window)
                timings[name] = {
                    "count": len(s),
                    "p50_ms": round(s[len(s) // 2] * 1e3, 3),
                    "p99_ms": round(s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3, 3),
                    "mean_ms": round(sum(s) / len(s) * 1e3, 3),
                }
            return {
                "uptime_s": round(time.time() - self._started, 1),
                "counters": dict(self._counters),
                "timings": timings,
            }


METRICS = Metrics()


@contextlib.contextmanager
def profile_trace(name: str = "memex"):
    """jax.profiler trace when MEMEX_PROFILE=<dir> is set; no-op otherwise."""
    trace_dir = os.environ.get("MEMEX_PROFILE")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(trace_dir, name)):
        yield
