"""Wall-clock stage timing for host orchestration loops.

A copy of ``StageTimer`` from ``whisper_mlx_tpu/runtime/profiling.py``:
per-stage totals (mel / detect_language / encode / decode) that
``transcribe()`` returns under ``"stages"``. On CUDA a stage's time is the
host's view: work still queued on the device when a stage ends is counted
in the stage that waits for it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Iterator


class StageTimer:
    """Accumulates wall-clock per named stage; reentrant-safe via with()."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, Any]:
        return {
            name: {
                "total_ms": round(self.totals[name] * 1000, 2),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / max(self.counts[name], 1) * 1000, 2),
            }
            for name in sorted(self.totals)
        }
