"""Stage timing — the reference's TimerStart/TimerStopAndLog discipline
(src/utils/timer.hpp:11-12), kept as structured spans for benchmarking."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

from .zklog import zklog


class TimerLog:
    """Spans on the host clock.  With `peak_memory`, also the most bytes the
    caching allocator held on the card during each span (`peaks`; the
    allocator's peak is reset as a span starts)."""

    def __init__(self, name: str = "", quiet: bool = False,
                 peak_memory: bool = False):
        self.name = name
        self.quiet = quiet
        self.peak_memory = peak_memory
        self.spans: List[tuple] = []  # (label, seconds)
        self.peaks: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, label: str):
        if self.peak_memory:
            import torch
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.spans.append((label, dt))
            if self.peak_memory:
                self.peaks[label] = max(self.peaks.get(label, 0),
                                        torch.cuda.max_memory_allocated())
            if not self.quiet:
                zklog.info(f"{label}: {dt:.3f} s")

    def total(self) -> float:
        return sum(dt for _, dt in self.spans)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, v in self.spans:
            out[k] = out.get(k, 0.0) + v
        return out


# ~0.5 ms of GPU spin ahead of a timed call: the host enqueues the call's
# launches (tens of microseconds of python and ctypes each) while the card is
# still busy, so the events time the card's work and not the host's.
PREFILL_CYCLES = 1_000_000


def device_time_ms(fn, runs: int, prefill: bool = True) -> float:
    """Median over `runs` single calls of `fn`, CUDA events, after one
    warm-up.  With `prefill` off the card is idle when the call starts, so
    the time includes the host's cost of issuing it.  Needs a CUDA card."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if prefill:
            torch.cuda._sleep(PREFILL_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
