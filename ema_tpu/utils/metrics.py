"""Stage timing / throughput counters + optional device profiling.

The reference's observability is wall-clock banners on stderr
(cpp/common.h:48-49 timers around every preproc stage; align.c:182,260).
Here every pipeline stage reports into a structured ``Metrics`` registry
(counts, wall seconds, derived rates) that the CLI prints as a summary
table, plus an opt-in ``jax.profiler`` trace for device-level analysis
(SURVEY.md §5.1).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, Optional


class Metrics:
    """Accumulates per-stage wall time and item counts."""

    def __init__(self) -> None:
        import threading
        self.wall: Dict[str, float] = {}
        self.items: Dict[str, int] = {}
        self._t0 = time.time()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0):
        t = time.time()
        try:
            yield
        finally:
            dt = time.time() - t
            with self._lock:
                self.wall[name] = self.wall.get(name, 0.0) + dt
                if n_items:
                    self.items[name] = self.items.get(name, 0) + n_items

    def add(self, name: str, n_items: int) -> None:
        with self._lock:
            self.items[name] = self.items.get(name, 0) + n_items

    def summary(self) -> str:
        total = time.time() - self._t0
        lines = [f":: total wall time: {total:.2f}s"]
        for name in sorted(self.wall):
            w = self.wall[name]
            n = self.items.get(name, 0)
            rate = f" ({n / w:.0f}/s)" if n and w > 0 else ""
            cnt = f" n={n}" if n else ""
            lines.append(f"::   {name}: {w:.2f}s{cnt}{rate}")
        return "\n".join(lines)

    def report(self, stream=None) -> None:
        (stream or sys.stderr).write(self.summary() + "\n")


GLOBAL = Metrics()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace around a region when ``log_dir`` is set."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
