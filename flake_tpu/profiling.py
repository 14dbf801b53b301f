"""Tracing and observability.

The reference's only profiling hooks are a disabled rdtsc cycle timer
(common.h:83-116) and shell-script wall clocks (util/flake-test.sh:25).
The device-side equivalents here:

- :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard/XProf trace of the device pipeline;
- :func:`annotate` — named-scope annotation so encoder stages are
  legible inside traces;
- :class:`StageTimer` — host-side wall-clock counters per stage with a
  samples/sec report (the Encoder's ``stats`` dict is the always-on
  subset of this);
- :func:`device_memory_stats` — live HBM usage of each device.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device+host profiler trace into ``logdir`` (view with
    TensorBoard's profile plugin / XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope for trace legibility: with annotate("rice-search"):
    ... (nests; visible in XProf timelines)."""
    return jax.named_scope(name)


class StageTimer:
    """Wall-clock accumulation per pipeline stage.

    >>> t = StageTimer()
    >>> with t.stage("analyze"):
    ...     ...
    >>> t.report(samples=n)
    """

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def report(self, samples: int | None = None,
               sample_rate: int = 44100) -> str:
        lines = []
        total = sum(self.seconds.values())
        for name, sec in sorted(self.seconds.items(),
                                key=lambda kv: -kv[1]):
            line = (f"{name:24s} {sec:9.4f}s  x{self.calls[name]:<6d}"
                    f" {sec / total * 100:5.1f}%")
            if samples:
                line += f"  {samples / max(sec, 1e-12):,.0f} smp/s"
            lines.append(line)
        if samples:
            xrt = (samples / sample_rate) / max(total, 1e-12)
            lines.append(f"{'TOTAL':24s} {total:9.4f}s"
                         f"  {xrt:,.1f}x realtime")
        return "\n".join(lines)


def device_memory_stats() -> list[dict]:
    """Per-device live HBM numbers (bytes_in_use / limit), when the
    backend exposes them (the GPU does; the CPU returns empty)."""
    out = []
    for d in jax.devices():
        stats = getattr(d, "memory_stats", lambda: None)()
        if stats:
            out.append({
                "device": str(d),
                "bytes_in_use": stats.get("bytes_in_use"),
                "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                "bytes_limit": stats.get("bytes_limit"),
            })
    return out
