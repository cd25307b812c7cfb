"""Thread-safe logger with a per-process prover-ID prefix (reference
src/utils/zklog.cpp semantics)."""

from __future__ import annotations

import sys
import threading
import time


class ZkLog:
    def __init__(self):
        self._lock = threading.Lock()
        self.prefix = ""
        self.enabled = True

    def set_prefix(self, prefix: str) -> None:
        self.prefix = prefix

    def _emit(self, level: str, msg: str) -> None:
        if not self.enabled:
            return
        ts = time.strftime("%Y%m%d_%H%M%S")
        with self._lock:
            sys.stderr.write(f"{ts} {level} {self.prefix}{msg}\n")

    def info(self, msg: str) -> None:
        self._emit("I", msg)

    def warning(self, msg: str) -> None:
        self._emit("W", msg)

    def error(self, msg: str) -> None:
        self._emit("E", msg)


zklog = ZkLog()
