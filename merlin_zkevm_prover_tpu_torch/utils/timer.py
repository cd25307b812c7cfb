"""Stage timing — the reference's TimerStart/TimerStopAndLog discipline
(src/utils/timer.hpp:11-12), kept as structured spans for benchmarking."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

from .zklog import zklog


class TimerLog:
    def __init__(self, name: str = "", quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.spans: List[tuple] = []  # (label, seconds)

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.spans.append((label, dt))
            if not self.quiet:
                zklog.info(f"{label}: {dt:.3f} s")

    def total(self) -> float:
        return sum(dt for _, dt in self.spans)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for k, v in self.spans:
            out[k] = out.get(k, 0.0) + v
        return out
