"""Tracing / profiling — the observability gap the reference leaves open
(SURVEY.md section 5.1: per-solve wall clocks only, no tracer).

- `Stopwatch`: wall-clock stage timers with mean/p50/p99 summaries (the
  `solve_time` channel of `main_parallel.py:39-43` and more).
- `trace(...)`: context manager around `jax.profiler` emitting a TensorBoard
  trace directory for kernel-level inspection on the device.
- `timed_call`: block-until-ready timing of a jitted callable (compile time
  and steady-state separated).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List

import jax
import numpy as np


class Stopwatch:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[stage].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage, xs in self.samples.items():
            a = np.asarray(xs)
            out[stage] = {
                "n": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "total_s": float(a.sum()),
            }
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """XLA-level profiler trace (view with TensorBoard's profile plugin)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_call(fn: Callable, *args, reps: int = 3):
    """Returns (result, compile_seconds, steady_seconds_per_call)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, compile_s, (time.perf_counter() - t0) / reps
