"""Per-stage wall-clock timers and a device trace (the JAX package's
utils/profiling.py ``StageTimer`` and ``device_trace``).  Device time
per stage comes from torch.profiler over the record_function ranges of
pipelines/infer.py (chip_smoke.py --profile)."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the enclosed block (host, and CUDA when a
    card is present), written into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, for Perfetto or chrome://tracing).
    Yields the profiler; its ``trace_path`` is set once the block ends."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class StageTimer:
    """Accumulating per-stage wall timers.  Stages are timed from the
    prefetch worker and the consumer thread at once, so updates take a
    lock."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def reset(self) -> None:
        """Drop accumulated stats (e.g. after warm-up passes, so a report
        covers only the timed region)."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(
                f"{name:24s} {t:8.3f}s total  {t / max(n, 1) * 1e3:8.2f}ms/call"
                f"  x{n}"
            )
        return "\n".join(lines)
