"""Wall-clock timing context manager."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.tstart = time.perf_counter()
        return self

    def __exit__(self, _type, _value, _tb):
        self.elapsed = time.perf_counter() - self.tstart
        if self.verbose:
            print(f"[{self.name}] Elapsed: {self.elapsed}")
