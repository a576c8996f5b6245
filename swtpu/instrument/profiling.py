"""jax.profiler integration — this framework's form of the reference's
tracing story (SURVEY.md §5a): wall-clock phase timers exist in
instrument.metrics; this module adds (a) real device traces viewable in
TensorBoard/Perfetto and (b) a per-phase device-time report for the
benchmark CLI.

The reference's Apollo runs dump CSV traces via APOLLO_TRACE_CSV_FOLDER_SUFFIX
(run-v8.sh:15); the analog here is SWTPU_BENCH_TRACE=<dir> consumed by
bench.py, which wraps one timed dispatch batch in `trace()`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace into ``logdir`` (inspect with
    TensorBoard's profile plugin or Perfetto). No-op if the profiler is
    unavailable on this backend."""
    import jax
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def phase_report(prep: Callable, run: Callable, fetch: Callable,
                 repeats: int = 3) -> dict:
    """Time the three phases of a device computation separately: host-side
    input prep, device execution (run() must block or chain enough work to
    dominate), and device->host result fetch. Returns seconds per phase —
    the structured form of the reference's phase printf pairs
    (omp_smithW.c:199-228)."""
    t0 = time.perf_counter()
    state = prep()
    prep_s = time.perf_counter() - t0

    run_s = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(state)
        run_s = min(run_s, time.perf_counter() - t0)

    t0 = time.perf_counter()
    fetch(out)
    fetch_s = time.perf_counter() - t0
    return {"input_prep_s": round(prep_s, 5),
            "device_run_s": round(run_s, 5),
            "result_fetch_s": round(fetch_s, 5)}
