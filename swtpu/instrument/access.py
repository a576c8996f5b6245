"""Memory-traffic accounting — the shadow-memory profiler's question,
answered analytically + from the compiler.

The reference instruments every device load/store with shadow bytes
(cuda_shared_instrumented_smithW.cu:171-353) to measure which data actually
moves between memory spaces — the experiment that motivated its rolling
wavefronts. Under XLA the equivalent facts come from (a) an analytic model
of each execution plan's device-memory traffic and (b) the compiled
executable's own cost and memory analysis
(`jit(...).lower().compile().cost_analysis()` / `.memory_analysis()`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.config import EngineConfig, Scoring


@dataclasses.dataclass
class TrafficReport:
    plan: str
    cells: int
    hbm_read_bytes: int          # analytic: bytes read from device memory
    hbm_write_bytes: int         # analytic: bytes written to device memory
    resident_bytes: int          # peak register/shared working set
    bytes_per_cell: float
    notes: str

    def summary(self) -> str:
        return (f"[{self.plan}] {self.cells/1e9:.2f} Gcells: "
                f"read {self.hbm_read_bytes/1e6:.1f} MB, "
                f"write {self.hbm_write_bytes/1e6:.1f} MB, "
                f"resident {self.resident_bytes/1e3:.0f} KB, "
                f"{self.bytes_per_cell:.4f} B/cell — {self.notes}")


def wavefront_traffic(m: int, n: int,
                      scoring: Scoring = Scoring()) -> TrafficReport:
    """Analytic device-memory traffic of the GPU wavefront kernel
    (csrc/sw_gpu.cu): per cell nothing leaves the registers. Each stripe
    of 32*R rows reads the query once and the row above it once (int32 H,
    plus F when affine) and writes its own bottom row; the boundary ring
    is small enough to stay in L2."""
    from ..kernels.gpu_fill import geometry
    g = geometry(m, n)
    row = 4 * g.mpad * (2 if scoring.is_affine else 1)
    reads = g.stripes * (g.mpad + row) + g.rows_pad
    writes = g.stripes * row + 4 * g.rows_pad + 12 * g.stripes
    per_lane = 4 * (5 * g.R + 12)         # h/e/best/col/code per row + state
    return TrafficReport(
        plan=f"wavefront(R={g.R},stripes={g.stripes})",
        cells=m * n, hbm_read_bytes=reads, hbm_write_bytes=writes,
        resident_bytes=per_lane * 32 * g.stripes,
        bytes_per_cell=(reads + writes) / (m * n),
        notes="H/E/F in registers; one boundary row per stripe in L2",
    )


def scan_traffic(m: int, n: int, traceback: bool = False) -> TrafficReport:
    """Analytic traffic of the XLA scan plan (carries live on-chip; stacked
    outputs go to HBM)."""
    steps = m + n - 1
    cells = m * n
    reads = m + n + 4 * (m + 2 * n)
    writes = 4 * steps                                # bottom-row stream
    if traceback:
        writes += steps * n                           # P diag-major int8
    resident = 4 * 5 * n
    return TrafficReport(
        plan=f"scan({'P' if traceback else 'score'})",
        cells=cells, hbm_read_bytes=reads, hbm_write_bytes=writes,
        resident_bytes=resident, bytes_per_cell=(reads + writes) / cells,
        notes="rolling diagonal carries; diag-major P when traced",
    )


def reference_v61_traffic(m: int, n: int) -> TrafficReport:
    """What the reference's v6.1 pathology moves: the FULL H and P matrices
    cross the device boundary on EVERY anti-diagonal
    (omp_smithW-v6.1-target-inlined.cpp:271 — measured 260 s at 4128^2,
    experiments-lassen/v6.1.log). Kept as the cautionary comparison."""
    diags = m + n - 3
    bytes_moved = diags * 2 * 4 * (m + 1) * (n + 1) * 2   # H+P, to+from
    return TrafficReport(
        plan="reference-v6.1 (per-diagonal full map)",
        cells=m * n, hbm_read_bytes=bytes_moved // 2,
        hbm_write_bytes=bytes_moved // 2,
        resident_bytes=8 * (m + 1) * (n + 1),
        bytes_per_cell=bytes_moved / (m * n),
        notes="the transfer pathology the device-resident plans avoid",
    )


def compiled_cost(fn, *example_args) -> Optional[dict]:
    """XLA's own cost analysis for a jitted callable (flops, bytes accessed,
    memory) — the measured complement to the analytic model."""
    import jax
    try:
        compiled = jax.jit(fn).lower(*example_args).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return dict(ca) if ca else None
    except Exception:
        return None


@dataclasses.dataclass
class MeasuredMemory:
    """Compiler-reported memory facts of ONE compiled executable — the
    C18 shadow-profiler's question answered by XLA itself
    (cuda_shared_instrumented_smithW.cu:328-353 measures per-element
    access kinds to find what must cross the device boundary; here the
    executable's argument/output sizes ARE the boundary-crossing bytes
    and temp_size the device working set)."""

    argument_bytes: int       # input buffers (stream in once)
    output_bytes: int         # result buffers (stream out once)
    temp_bytes: int           # XLA temp allocations (working set)
    code_bytes: int

    def bytes_per_cell(self, cells: int) -> float:
        return (self.argument_bytes + self.output_bytes) / cells


def measured_memory(fn, *example_args) -> Optional[MeasuredMemory]:
    """Compile ``fn`` and return its measured memory profile, or None when
    the backend exposes no memory_analysis."""
    import jax
    try:
        compiled = jax.jit(fn).lower(*example_args).compile()
        ma = compiled.memory_analysis()
        if ma is None:
            return None
        return MeasuredMemory(
            argument_bytes=int(ma.argument_size_in_bytes),
            output_bytes=int(ma.output_size_in_bytes),
            temp_bytes=int(ma.temp_size_in_bytes),
            code_bytes=int(ma.generated_code_size_in_bytes),
        )
    except Exception:
        return None


def validate_model(m: int, n: int, scoring: Scoring = Scoring()) -> dict:
    """Measure the scan plan's compiled memory profiles and compare them
    with the analytic model. Returns {plan: (analytic TrafficReport,
    MeasuredMemory)} for every plan that compiled — the model-vs-measured
    agreement check."""
    import jax.numpy as jnp
    from ..core.encode import random_pair
    from ..kernels.scan_fill import scan_fill

    a, b = random_pair(m, n, seed=0)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    out = {}

    meas = measured_memory(
        lambda x, y: scan_fill(x, y, scoring=scoring, return_p=True).p_diag,
        aj, bj)
    if meas is not None:
        out["scan+P"] = (scan_traffic(m, n, traceback=True), meas)
    meas = measured_memory(
        lambda x, y: scan_fill(x, y, scoring=scoring).max_score, aj, bj)
    if meas is not None:
        out["scan"] = (scan_traffic(m, n), meas)
    return out


def report(m: int, n: int, config: EngineConfig = EngineConfig()) -> str:
    """Human-readable traffic comparison for a problem size."""
    lines = [
        scan_traffic(m, n).summary(),
        scan_traffic(m, n, traceback=True).summary(),
        wavefront_traffic(m, n).summary(),
        reference_v61_traffic(m, n).summary(),
    ]
    return "\n".join(lines)
