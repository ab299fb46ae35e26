"""Wall-clock timing of jitted JAX work on one device.

JAX dispatch is asynchronous, so every window below ends in
`jax.block_until_ready` on the last output: the host clock then spans the
device work, not just the enqueue.

Protocol:
  1. warm up (compile + one run, synchronised).
  2. time windows of `reps` back-to-back executions (the device queue
     stays full; dispatch overlaps execution), each ending in one
     `block_until_ready`.
  3. report the best window's per-execution time.
"""

from __future__ import annotations

import time

import jax


def measure(fn, *args, reps: int = 8, inner: int = 1, windows: int = 3) -> float:
    """Per-execution seconds of `fn(*args)` (best of `windows` windows).

    `inner` is a divisor for fns that already iterate internally."""
    jax.block_until_ready(fn(*args))  # compile + first run

    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    return best / inner


def measure_compile_and_first(fn, *args) -> tuple[float, object]:
    """Wall seconds for compile + first execution (cold), synchronised."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out
