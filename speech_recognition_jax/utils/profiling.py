"""Profiling / timing harness.

The reference's only observability is ``print`` with carriage-return
progress meters (``/root/reference/sr/core.py:49``,
``continuous_speech.py:107`` — SURVEY.md §5).  This module provides:

* :func:`timed` — wall-clock timing fenced by ``jax.block_until_ready``,
* :class:`Meter` — audio-seconds/s and utterances/s counters,
* :func:`trace` — a ``jax.profiler`` trace context for TensorBoard
  dumps.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

__all__ = ["timed", "Meter", "trace"]


def timed(fn: Callable, *args, warmup: int = 2, iters: int = 5, **kw):
    """Time a jitted function returning an array tree; each call is
    fenced by ``jax.block_until_ready``.

    Returns ``(seconds_per_call, last_result)``."""
    import jax

    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args, **kw))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args, **kw))
    return (time.perf_counter() - t0) / iters, out


@dataclass
class Meter:
    """Throughput accounting for audio pipelines."""

    frame_step_s: float = 0.01
    totals: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, seconds: float, n_frames: int = 0, n_utts: int = 0):
        t = self.totals
        t[f"{name}.seconds"] = t.get(f"{name}.seconds", 0.0) + seconds
        t[f"{name}.frames"] = t.get(f"{name}.frames", 0) + n_frames
        t[f"{name}.utts"] = t.get(f"{name}.utts", 0) + n_utts

    def report(self) -> Dict[str, float]:
        out = {}
        stages = {k.split(".")[0] for k in self.totals}
        for s in stages:
            sec = self.totals.get(f"{s}.seconds", 0.0)
            if sec <= 0:
                continue
            frames = self.totals.get(f"{s}.frames", 0)
            utts = self.totals.get(f"{s}.utts", 0)
            if frames:
                out[f"{s}.audio_s_per_s"] = frames * self.frame_step_s / sec
            if utts:
                out[f"{s}.utts_per_s"] = utts / sec
            out[f"{s}.seconds"] = sec
        return out


@contextlib.contextmanager
def trace(log_dir: str = None):
    """``jax.profiler`` trace context (view with TensorBoard); the trace
    goes to ``log_dir``, or a fresh temporary directory."""
    import tempfile

    import jax

    log_dir = log_dir or tempfile.mkdtemp(prefix="jax-trace-")

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
