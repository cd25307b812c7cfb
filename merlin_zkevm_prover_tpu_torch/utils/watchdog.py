"""Watchdog: kills/flags a stage that exceeds its timeout (reference
src/utils/watchdog.cpp:7-40)."""

from __future__ import annotations

import threading
from typing import Callable, Optional


class Watchdog:
    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self):
        self.fired = True
        if self.on_timeout:
            self.on_timeout()
        else:
            from .zklog import zklog

            zklog.error(f"Watchdog timeout after {self.timeout_s}s")

    def start(self):
        self.stop()
        self.fired = False
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def kick(self):
        self.start()

    def stop(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
