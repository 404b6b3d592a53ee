"""Category-based wall-clock profiler.

Re-implementation of the reference TimerManager singleton
(src/Utils/Timer.hpp:17-266) with the same seven categories and
summary/detailed reporting, plus a context-manager interface (copy of
mops_tpu.utils.timer).  Work on the card is asynchronous: a timed region
measures it only when the region ends by reading a result back to the host
(the API's regions do) or by torch.cuda.synchronize().
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

CATEGORIES = ("IO_Read", "IO_Write", "Preprocessing", "MemoryCopy",
              "GPUKernel", "CPUCompute", "Other")


class TimerManager:
    _instance = None
    _lock = threading.Lock()

    def __init__(self):
        self._records: List[Tuple[str, str, float]] = []  # (name, category, ms)
        self._active: Dict[str, Tuple[str, float]] = {}
        self._mu = threading.Lock()

    @classmethod
    def instance(cls) -> "TimerManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
        return cls._instance

    def start(self, name: str, category: str = "Other") -> None:
        with self._mu:
            self._active[name] = (category, time.perf_counter())

    def stop(self, name: str) -> None:
        with self._mu:
            if name not in self._active:
                return
            category, t0 = self._active.pop(name)
            self._records.append((name, category, (time.perf_counter() - t0) * 1e3))

    def record(self, name: str, category: str, ms: float) -> None:
        with self._mu:
            self._records.append((name, category, ms))

    def reset(self) -> None:
        with self._mu:
            self._records.clear()
            self._active.clear()

    def category_time(self, category: str) -> float:
        with self._mu:
            return sum(ms for _, c, ms in self._records if c == category)

    def total_time(self) -> float:
        with self._mu:
            return sum(ms for _, _, ms in self._records)

    def summary(self) -> Dict[str, float]:
        out = defaultdict(float)
        with self._mu:
            for _, c, ms in self._records:
                out[c] += ms
        return dict(out)

    def print_summary(self) -> None:
        print("=" * 52)
        print(f"{'Category':<20}{'Total (ms)':>14}{'Share':>10}")
        print("-" * 52)
        total = self.total_time()
        for cat in CATEGORIES:
            t = self.category_time(cat)
            if t > 0:
                share = 100.0 * t / total if total else 0.0
                print(f"{cat:<20}{t:>14.3f}{share:>9.1f}%")
        print("-" * 52)
        print(f"{'Total':<20}{total:>14.3f}")
        print("=" * 52)

    def print_detailed(self) -> None:
        print("=" * 64)
        print(f"{'Operation':<36}{'Category':<16}{'ms':>10}")
        print("-" * 64)
        with self._mu:
            for name, cat, ms in self._records:
                print(f"{name:<36}{cat:<16}{ms:>10.3f}")
        print("=" * 64)


@contextlib.contextmanager
def timer(name: str, category: str = "Other"):
    mgr = TimerManager.instance()
    mgr.start(name, category)
    try:
        yield
    finally:
        mgr.stop(name)
