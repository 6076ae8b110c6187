"""Build progress reporting (port of ``granne_tpu/utils/progress.py``).

Reference parity: ``pbr::ProgressBar`` usage gated by
``BuildConfig::show_progress`` (the reference's ``src/index/mod.rs:734-753``):
approximate progress with rate and ETA, one bar per layer pass.  The bar
renders the JAX package's bytes; ``stream`` defaults to ``sys.stderr`` as
it is when the bar is made.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, total: int, prefix: str = "", stream=None, width: int = 30):
        self.total = max(total, 1)
        self.prefix = prefix
        self.stream = sys.stderr if stream is None else stream
        self.width = width
        self.start = time.time()
        self.current = 0
        self._last_render = 0.0

    def set(self, value: int) -> None:
        self.current = min(value, self.total)
        now = time.time()
        if now - self._last_render >= 0.25 or self.current >= self.total:
            self._render(now)
            self._last_render = now

    def add(self, delta: int) -> None:
        self.set(self.current + delta)

    def _render(self, now: float) -> None:
        frac = self.current / self.total
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        elapsed = now - self.start
        rate = self.current / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.current) / rate if rate > 0 else float("inf")
        eta_s = f"{eta:.0f}s" if eta != float("inf") else "?"
        self.stream.write(
            f"\r{self.prefix}[{bar}] {self.current}/{self.total} "
            f"{rate:.0f}/s eta {eta_s}   "
        )
        self.stream.flush()

    def finish(self) -> None:
        self.set(self.total)
        self.stream.write("\n")
        self.stream.flush()
