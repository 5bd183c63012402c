"""Observability: throughput meters, a timing helper, profiler hooks.

The reference's observability is stderr progress lines (scanline countdown
``in_one_weekend/camera.rs:64,80-84``; GPU ``pass/total (%) elapsed eta``
``gpu/mod.rs:469-480``).  Here: structured per-pass records (also emitted by
the CLI), a paths/s meter, and a ``jax.profiler`` trace context for real
kernel-level profiling (SURVEY.md §5).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional


def time_best(go, repeats: int = 2, on_rep=None) -> float:
    """Best-of-``repeats`` wall time of ``go()``, each rep ending in
    ``jax.block_until_ready`` (JAX returns before the device finishes, so
    an unfenced timing measures the enqueue) — the one timing idiom every
    bench script shares.  ``go`` must have been run once already (warmup/
    compile).  ``on_rep(i, seconds)`` fires after each rep."""
    import jax

    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(go())
        dt = time.perf_counter() - t0
        if on_rep is not None:
            on_rep(i, dt)
        best = min(best, dt)
    return best


@dataclass
class PassRecord:
    spp: int
    paths: int
    seconds: float

    @property
    def paths_per_sec(self) -> float:
        return self.paths / max(self.seconds, 1e-12)


@dataclass
class RenderMeter:
    """Accumulates per-pass throughput; emits JSON lines (the structured
    analog of the reference's stderr progress)."""

    n_pixels: int
    records: List[PassRecord] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def lap(self, spp: int) -> PassRecord:
        now = time.perf_counter()
        rec = PassRecord(spp=spp, paths=spp * self.n_pixels,
                         seconds=now - (self._t0 or now))
        self._t0 = now
        self.records.append(rec)
        return rec

    @property
    def total_paths(self) -> int:
        return sum(r.paths for r in self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    @property
    def paths_per_sec(self) -> float:
        return self.total_paths / max(self.total_seconds, 1e-12)

    def json_line(self, **extra) -> str:
        return json.dumps(dict(
            passes=len(self.records), total_paths=self.total_paths,
            elapsed_s=round(self.total_seconds, 3),
            paths_per_sec=round(self.paths_per_sec, 1), **extra,
        ))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
