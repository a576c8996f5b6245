"""Timers, GCUPS accounting, and structured bench records.

The reference reports wall-clock phase timers via printf
(omp_smithW.c:199-228) and its experiments are harvested by grepping
"Elapsed time" lines into .log.data files (readme.liao:10-12). Here the same
telemetry is a structured record: phase timings, derived GCUPS (cell updates
per second — the metric BASELINE.md derives by hand), and JSONL emission.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional

import jax


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates named phase durations (the omp_get_wtime pair analog)."""

    phases: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)


def block(x):
    """Synchronize device work before reading a timer (the
    cudaDeviceSynchronize analog for fair phase timing)."""
    return jax.block_until_ready(x)


def gcups(cells: int, seconds: float) -> float:
    """Giga cell updates per second — m*n / time / 1e9 (BASELINE.md)."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")


@dataclasses.dataclass
class BenchRecord:
    """One benchmark observation, JSONL-serializable."""

    name: str
    m: int
    n: int
    batch: int = 1
    repeats: int = 1
    fill_s: float = 0.0
    traceback_s: float = 0.0
    compile_s: float = 0.0
    plan: str = "scan"
    backend: str = ""
    devices: int = 1
    extra: Optional[dict] = None

    @property
    def cells(self) -> int:
        return self.m * self.n * self.batch

    @property
    def gcups(self) -> float:
        return gcups(self.cells, self.fill_s)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["cells"] = self.cells
        d["gcups"] = self.gcups
        return json.dumps(d)


def memory_footprint_bytes(m: int, n: int, traceback: bool = True,
                           affine: bool = False) -> int:
    """Estimated working-set bytes (the v1 startup print analog,
    omp_smithW-v1-refinedOrig.cpp:138-142). The device plans never materialize
    H — only rolling wavefronts O(n) plus P when traceback is kept."""
    wavefronts = 4 * n * (5 if affine else 3)          # int32 rolling buffers
    p_matrix = (n + m - 1) * n if traceback else 0     # int8 diag-major P
    seqs = m + n
    return wavefronts + p_matrix + seqs
