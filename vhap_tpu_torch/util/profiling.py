"""Lightweight step timing + optional device tracing.

Counterpart of vhap_tpu/util/profiling.py:
  * StepTimer: rolling steps/sec + per-stage wall-time accounting and the
    per-step wall times of each stage (for medians), surfaced in the
    tracker's scalar logs,
  * `device_trace(...)`: context manager around torch.profiler, writing a
    Chrome/Perfetto trace of the host and CUDA activity inside it.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional


class StepTimer:
    """Rolling throughput and cumulative per-stage wall time."""

    def __init__(self, window: int = 50):
        self.window = window
        self._last: Optional[float] = None
        self._deltas = []
        self.stage_seconds: Dict[str, float] = defaultdict(float)
        self.stage_steps: Dict[str, int] = defaultdict(int)
        self.stage_deltas: Dict[str, List[float]] = defaultdict(list)

    def tick(self, stage: str = "") -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._deltas.append(dt)
            if len(self._deltas) > self.window:
                self._deltas.pop(0)
            self.stage_seconds[stage] += dt
            self.stage_steps[stage] += 1
            self.stage_deltas[stage].append(dt)
        self._last = now

    def reset_clock(self) -> None:
        """Call when entering a stage so compile time isn't attributed."""
        self._last = None

    @property
    def steps_per_sec(self) -> float:
        if not self._deltas:
            return 0.0
        return len(self._deltas) / sum(self._deltas)

    def median_ms(self, stage: str) -> Optional[float]:
        """Median wall time of one of the stage's steps, in ms (the first
        step after each reset_clock is not timed)."""
        d = self.stage_deltas.get(stage)
        return statistics.median(d) * 1e3 if d else None

    def summary(self) -> Dict[str, float]:
        out = {"steps_per_sec": round(self.steps_per_sec, 3)}
        for k in self.stage_seconds:
            out[f"seconds/{k}"] = round(self.stage_seconds[k], 2)
        return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a host + CUDA trace (Chrome trace JSON, viewable in Perfetto)
    of the block into log_dir/trace.json."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
