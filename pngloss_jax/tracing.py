"""Lightweight stage tracing for the pipeline.

The reference's only observability is a verbose spinner and stderr stats
(SURVEY.md §5). The batched pipeline has real stages worth timing — host decode,
device dispatch per bucket, host encode — so this provides:

  * `stage(name)` — context manager accumulating wall time per stage into a
    process-wide trace (lock-protected: the pipeline's feed/drain pools run
    decode/encode stages on worker threads), retrievable with `snapshot()`;
  * `device_trace(path)` — wraps `jax.profiler.trace` when a profile dump is
    requested (PNGLOSS_PROFILE_DIR env or explicit path), a no-op otherwise.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_times: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _times[name] += dt
            _counts[name] += 1


def snapshot(reset: bool = False) -> dict[str, dict[str, float]]:
    """Per-stage {'seconds', 'calls'} accumulated across all threads.
    Stage seconds are summed per thread, so pooled stages (host_encode on N
    workers) can total more than wall time — that is the intended reading:
    total CPU-seconds spent in the stage."""
    with _lock:
        out = {k: {"seconds": round(v, 6), "calls": _counts[k]}
               for k, v in _times.items()}
        if reset:
            _times.clear()
            _counts.clear()
    return out


@contextlib.contextmanager
def device_trace(path: str | None = None):
    """jax.profiler.trace wrapper; no-op unless a dump dir is configured."""
    path = path or os.environ.get("PNGLOSS_PROFILE_DIR")
    if not path:
        yield
        return
    import jax

    with jax.profiler.trace(path):
        yield
