"""Per-run performance counters and optional device tracing.

The reference has no instrumentation (SURVEY.md §5: tracing/profiling —
none); this subsystem is the device build's observability for throughput:
per-stage wall-clock accounting (host read/decode, device dispatch, result
collection + emission) and an optional ``jax.profiler`` trace directory
for XLA-level analysis.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Iterator


@dataclass
class RunStats:
    """Wall-clock accounting for one detector run."""

    chunks: int = 0
    audio_seconds: float = 0.0
    read_seconds: float = 0.0  # host I/O + PCM decode + resample
    dispatch_seconds: float = 0.0  # section assembly + device enqueue
    collect_seconds: float = 0.0  # blocking on device results + emission
    wall_seconds: float = 0.0
    detections: int = 0

    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds > 0 else 0.0

    def as_dict(self) -> dict[str, Any]:
        return {
            "chunks": self.chunks,
            "audio_seconds": round(self.audio_seconds, 6),
            "read_seconds": round(self.read_seconds, 6),
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "collect_seconds": round(self.collect_seconds, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "detections": self.detections,
            "realtime_factor": round(self.realtime_factor(), 2),
        }


class Stopwatch:
    """Accumulates named wall-clock segments onto a RunStats."""

    def __init__(self, stats: RunStats) -> None:
        self.stats = stats
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        try:
            yield
        finally:
            setattr(
                self.stats,
                f"{name}_seconds",
                getattr(self.stats, f"{name}_seconds") + time.perf_counter() - t,
            )

    def finish(self) -> None:
        self.stats.wall_seconds = time.perf_counter() - self._t0


@contextlib.contextmanager
def device_trace(trace_dir: "str | None") -> Iterator[None]:
    """Optional jax.profiler trace around a run (no-op when dir is None)."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
