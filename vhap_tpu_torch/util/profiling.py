"""Step timing and layer spans.

Counterpart of vhap_tpu/util/profiling.py:
  * StepTimer: rolling steps/sec and the per-step times of each stage
    (for medians), surfaced in the tracker's scalar logs; on a card they
    are the device's times between steps;
  * span(name): a named host interval around one layer of the loop (the
    step and its forward, backward and Adam, FLAME, the render and its
    parts, the loop's batch wait, copy, checkpoint, warm start and logs).
    A step replayed from a CUDA graph (tracker/step_graph.py) opens `step`
    and `step.replay` only; the call that captures it, `step.capture`
    around the recording, whose ops open the layers' spans once.

Spans are off by default, and then `span` costs one check of a module flag
and returns a shared null context. `enable_spans(True)` turns them on for
the calling thread (the thread that launches the step's work; a span opened
on another thread is the null context); each span then records
(name, start, end, parent) on `time.perf_counter()`, the clock of StepTimer,
into a bounded buffer that `take_spans()` empties. While torch.profiler
records, each span also enters `torch.profiler.record_function(name)`, so
it shows among the profiler's events as a user annotation around the ops
it launched, on the clock of the device activity.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

import torch

SPAN_CAPACITY = 1 << 16      # records kept; the oldest go first

_on = False
_thread: Optional[int] = None
_NULL = contextlib.nullcontext()
_records: deque = deque(maxlen=SPAN_CAPACITY)
_open: List[int] = []        # numbers of the open spans, innermost last
_opened = 0                  # spans opened so far (their numbers)


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int              # index of the enclosing span in the list, or -1


class _Span:
    __slots__ = ("name", "n", "parent", "start", "ranged")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _opened
        self.n, _opened = _opened, _opened + 1
        self.parent = _open[-1] if _open else -1
        _open.append(self.n)
        self.ranged = None
        if torch.autograd._profiler_enabled():
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        _open.pop()
        _records.append((self.n, self.name, self.start, end, self.parent))
        return False


def span(name: str):
    """Context manager timing one layer of the loop (module docstring)."""
    if not _on or threading.get_ident() != _thread:
        return _NULL
    return _Span(name)


def enable_spans(on: bool = True) -> None:
    """Turn spans on (for the calling thread) or off. Records are kept."""
    global _on, _thread
    _thread = threading.get_ident() if on else None
    _on = bool(on)


def take_spans() -> List[Span]:
    """The closed spans recorded since the last call, in the order they
    were opened, and clears them. A parent index points into the returned
    list; -1 for a top-level span, or one whose parent is still open or
    was dropped from the full buffer."""
    recs = sorted(_records)
    _records.clear()
    index = {r[0]: i for i, r in enumerate(recs)}
    return [Span(name, start, end, index.get(parent, -1))
            for _, name, start, end, parent in recs]


class StepTimer:
    """Rolling throughput and the per-step times of each stage.

    `stage_deltas` holds the host's intervals between ticks. On a CUDA
    `device` each tick also records an event on the current stream, and
    `steps_per_sec` and `median_ms` read the intervals between the events
    instead: the device's time per step. The host's intervals stop timing a
    step once the host queues steps ahead of the device (a step replayed
    from a CUDA graph takes the host about a millisecond). A tick reads the
    events the device has passed and never waits; `median_ms` waits for the
    last one."""

    def __init__(self, window: int = 50, device=None):
        self.window = window
        self._last: Optional[float] = None
        self._deltas = []
        self.stage_deltas: Dict[str, List[float]] = defaultdict(list)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._event = None            # the last tick's event
        self._pending = deque()       # (stage, start event, end event) unread
        self._device_window = deque(maxlen=window)
        self.device_deltas: Dict[str, List[float]] = defaultdict(list)

    def tick(self, stage: str = "") -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._deltas.append(dt)
            if len(self._deltas) > self.window:
                self._deltas.pop(0)
            self.stage_deltas[stage].append(dt)
        self._last = now
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            if self._event is not None:
                self._pending.append((stage, self._event, event))
            self._event = event
            self._read_device(wait=False)

    def reset_clock(self) -> None:
        """Call when entering a stage so compile time isn't attributed."""
        self._last = None
        self._event = None

    def _read_device(self, wait: bool) -> None:
        """Move the intervals whose end the device has passed into
        device_deltas (with wait: all of them, after the last ends)."""
        if wait and self._pending:
            self._pending[-1][2].synchronize()
        while self._pending and self._pending[0][2].query():
            stage, start, end = self._pending.popleft()
            dt = start.elapsed_time(end) * 1e-3
            self.device_deltas[stage].append(dt)
            self._device_window.append(dt)

    @property
    def steps_per_sec(self) -> float:
        deltas = self._deltas
        if self._cuda:
            self._read_device(wait=False)
            deltas = self._device_window
        if not deltas:
            return 0.0
        return len(deltas) / sum(deltas)

    def median_ms(self, stage: str) -> Optional[float]:
        """Median time of one of the stage's steps, in ms (the first step
        after each reset_clock is not timed)."""
        if self._cuda:
            self._read_device(wait=True)
            d = self.device_deltas.get(stage)
        else:
            d = self.stage_deltas.get(stage)
        return statistics.median(d) * 1e3 if d else None
