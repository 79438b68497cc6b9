"""Phase timing + device timing helpers.

The reference's only instrumentation is a dead rdtsc macro (bench.h, included
but never called -- SURVEY.md §5.1). Here timing is a real subsystem:

- ``phase(name)``: wall-clock context manager that also opens a
  ``jax.profiler.TraceAnnotation`` so phases show up on device traces;
- ``PhaseTimer``: accumulates named phase durations (init/upload/render/
  readback -- "ms/viewpoint" being the framework's north-star metric);
- ``device_time(fn, *args)``: median wall seconds per call, each call ended
  by ``jax.block_until_ready`` (JAX returns before the device finishes);
- ``require_gpu()`` / ``card_line()``: the measurement paths' device
  contract -- they run on the GPU or not at all, and every number they
  print is tagged with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        import jax
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot * 1e3:9.2f} ms total "
                         f"({n}x, {tot / n * 1e3:.2f} ms avg)")
        return "\n".join(lines)


_global_timer = PhaseTimer()


def phase(name: str):
    """Module-level phase context: ``with profiling.phase("render"): ...``"""
    return _global_timer.phase(name)


def report() -> str:
    return _global_timer.report()


def device_time(fn, *args, iters: int = 5):
    """Median wall seconds per call of ``fn(*args)``. One untimed call
    first (compilation); every timed call ends in jax.block_until_ready,
    so the time covers the device work and the dispatch, not the enqueue."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def require_gpu():
    """The default backend's devices, or SystemExit when the backend is not
    the GPU: a measurement taken elsewhere is not a device number."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is {backend!r}")
    return jax.devices()


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them
    (``name, power.limit`` of the first card)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]
