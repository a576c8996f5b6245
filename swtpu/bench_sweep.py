"""Benchmark sweep harness — the run-v*.sh analog with structured output.

The reference sweeps sizes with shell loops (square {32..26000..512} in
run-v1.sh, rectangular 2000 x {2..150000..5000} in run-v0.sh/run-v6.3.sh),
3 repeats each, grepping "Elapsed time" lines into .log.data files
(readme.liao:10-12). Here the sweep is a module emitting JSONL records
(instrument.metrics.BenchRecord) ready for analysis — no grep.

    python -m swtpu.bench_sweep --grid square --quick --out sweep.jsonl
    python -m swtpu.bench_sweep --grid rect --plan wavefront
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _grid(name: str, quick: bool):
    if name == "square":
        # reference: {32..26000..512} (run-v1.sh); quick subsamples
        sizes = list(range(32, 26001, 512))
        if quick:
            sizes = [32, 1056, 4128, 10272, 25632]
        return [(s, s) for s in sizes]
    if name == "rect":
        # reference: 2000 x {2..150000..5000} (run-v0.sh, run-v6.3.sh)
        widths = list(range(2, 150001, 5000))
        if quick:
            widths = [2, 25002, 75002, 145002]
        return [(w, 2000) for w in widths]
    raise ValueError(name)


def _time_plan(plan, m, n, repeats, k=5):
    from .core.encode import random_pair
    a, b = random_pair(m, n, seed=0)
    if plan == "host":
        # native serial tier: time the actual dispatched backend, not a
        # device plan wearing its label
        from . import runtime_native as rn
        t0 = time.perf_counter()
        out = rn.fill(a, b)                  # first call loads the lib
        compile_s = time.perf_counter() - t0
        score = int(out.max_score)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(k):
                rn.fill(a, b)
            best = min(best, (time.perf_counter() - t0) / k)
        return best, compile_s, score
    if plan == "host-simd":
        # striped AVX2 score-only tier — what score() dispatches for
        # sub-cap mid-size problems
        from . import runtime_native as rn
        t0 = time.perf_counter()
        score = rn.score_simd(a, b)          # first call loads the lib
        compile_s = time.perf_counter() - t0
        assert score is not None
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(k):
                rn.score_simd(a, b)
            best = min(best, (time.perf_counter() - t0) / k)
        return best, compile_s, score
    if plan == "wavefront":
        from .kernels import gpu_fill
        fn = gpu_fill.score_fn(m, n)
        aj, bj = jnp.asarray(a), jnp.asarray(b)
        t0 = time.perf_counter()
        score = int(fn(aj, bj)[0])
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(k - 1):
                fn(aj, bj)
            int(fn(aj, bj)[0])
            best = min(best, (time.perf_counter() - t0) / k)
        return best, compile_s, score
    # scan
    from .kernels.scan_fill import scan_fill
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    t0 = time.perf_counter()
    score = int(scan_fill(aj, bj).max_score)
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(k - 1):
            scan_fill(aj, bj)
        score = int(scan_fill(aj, bj).max_score)
        best = min(best, (time.perf_counter() - t0) / k)
    return best, compile_s, score


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="swtpu.bench_sweep")
    ap.add_argument("--grid", choices=["square", "rect"], default="square")
    ap.add_argument("--plan",
                    choices=["wavefront", "scan", "host", "host-simd",
                             "auto"],
                    default="auto")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="subsample the reference grid")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)

    from .instrument.metrics import BenchRecord

    sink = open(args.out, "a") if args.out else sys.stdout
    # Backend warm-up OUTSIDE any row's timing: the first device dispatch
    # of a process pays backend init, which would poison the first row. A
    # trivial dispatch eats it here and the time is reported as its own
    # record so logs stay honest.
    from .core.runtime import enable_compile_cache
    enable_compile_cache()
    t0 = time.perf_counter()
    backend = jax.default_backend()
    np.asarray(jnp.zeros((8,), jnp.int32) + 1)
    init_s = time.perf_counter() - t0
    print(BenchRecord(name=f"backend-init-{args.grid}", m=0, n=0,
                      fill_s=init_s, plan="-", backend=backend,
                      extra={"init_s": round(init_s, 3)}).to_json(),
          file=sink, flush=True)
    for m, n in _grid(args.grid, args.quick):
        plan = args.plan
        if plan == "auto":
            from .core.config import EngineConfig
            from .dispatch.plan import choose_plan
            from .runtime_native import available
            plan = choose_plan(m, n)
            # the sweep measures score-only fills (-DSKIP_BACKTRACK mode):
            # follow score()'s mid-size routing to the SIMD host tier
            cfg = EngineConfig()
            if plan != "host" and available() \
                    and cfg.host_max_cells < m * n <= cfg.simd_cells_cap():
                from .runtime_native import simd_eligible
                if simd_eligible(m, n):
                    plan = "host-simd"
        fill_s, compile_s, score = _time_plan(plan, m, n, args.repeats)
        rec = BenchRecord(name=f"sweep-{args.grid}", m=m, n=n,
                          repeats=args.repeats, fill_s=fill_s,
                          compile_s=compile_s, plan=plan, backend=backend,
                          extra={"score": score})
        print(rec.to_json(), file=sink, flush=True)
    if args.out:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
