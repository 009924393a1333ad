"""Runtime tracing / profiling.

The reference's whole observability story is a per-frame wall-clock
running average printed from the camera callback plus ad-hoc
``ros::Time::now()`` deltas in tests (reference: EKFVIO.cpp:119-135,
test/test_ekf.cpp:88-141); an ``ANALYZE_RUNTIME`` flag exists but gates
nothing (Params.h:31).  The equivalents here:

* ``FrameTimer`` — the same running-average frames/s meter, host-side.
* ``trace`` — a context manager around ``jax.profiler`` that writes an
  XPlane trace viewable in TensorBoard/Perfetto (the real device-side
  story: per-kernel device timings and memory traffic).
* ``device_timer`` — median device latency of a compiled callable, the
  measurement recipe every micro-benchmark here uses.
"""
from __future__ import annotations

import contextlib
import time


class FrameTimer:
    """Running-average per-frame wall-clock meter (EKFVIO.cpp:119-135).

    >>> ft = FrameTimer(log_every=60)
    >>> with ft.frame(): ...   # per frame
    >>> ft.fps
    """

    def __init__(self, log_every: int = 0, log_fn=print):
        self.count = 0
        self.total_s = 0.0
        self.last_s = 0.0
        self.log_every = log_every
        self.log_fn = log_fn

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        self.last_s = time.perf_counter() - t0
        self.total_s += self.last_s
        self.count += 1
        if self.log_every and self.count % self.log_every == 0:
            self.log_fn(
                f"[frame {self.count}] average dt {self.average_dt_ms:.3f} ms"
                f" ({self.fps:.1f} fps)"
            )

    @property
    def average_dt_ms(self) -> float:
        return 1e3 * self.total_s / max(self.count, 1)

    @property
    def fps(self) -> float:
        return self.count / self.total_s if self.total_s > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile (TensorBoard XPlane) for the enclosed ops."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_timer(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall-clock seconds of ``fn(*args)`` with device sync."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]
