#!/usr/bin/env python
"""Headline benchmark — prints ONE JSON line.

Metric: GCUPS (giga DP-cell updates per second) for a single-pair
score-only fill on one device at the reference's largest standard sweep
size (25632^2; "Elapsed time for scoring matrix computation" with
-DSKIP_BACKTRACK=1, makefile:9), through the plan dispatch picks (the
wavefront kernel on a Hopper GPU). Baseline: the reference's best-ever
0.54 GCUPS (44-core Power9, SMT — BASELINE.md).

The extras time public entry points: `score` with BLOSUM62 + affine gaps,
`batch_score`, `search` + `align_hits`, and `align(traceback=True)`.
`batch_score` and `search` are also timed with plan='host-simd' (the
striped SIMD scorer on the host's cores) beside their device route, the
comparison that says whether the device route pays on this machine. The
benchmark measures an accelerator: on the CPU platform it exits with an
error instead of timing the host, and a failing extra fails the run.
Every result carries the device's platform, kind and count and the card's
nvidia-smi name and power limit.

    python bench.py
"""

import json
import sys
import time

import jax
import numpy as np

BASELINE_GCUPS = 0.54
M = N = 25632          # the reference's largest standard sweep size
REPS = 5               # warm samples per timing (min taken)


def _time_min(call, reps=REPS):
    """Min wall time of ``reps`` warm calls, each ended by
    block_until_ready (the first call compiles and is not timed)."""
    jax.block_until_ready(call())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_headline():
    import jax.numpy as jnp
    from swtpu.core.encode import random_pair
    from swtpu.engine.align import _fill_fn_for_bench

    a, b = random_pair(M, N, seed=0)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    fn, plan = _fill_fn_for_bench(M, N)
    fn = jax.jit(fn)
    t0 = time.perf_counter()
    score = int(fn(aj, bj)[0])
    compile_s = time.perf_counter() - t0
    return _time_min(lambda: fn(aj, bj)), score, compile_s, plan


def bench_protein():
    """BLOSUM62 + affine -11/-1 at the headline size through score()."""
    from swtpu import Scoring, score
    from swtpu.core.substitution import BLOSUM62

    rng = np.random.default_rng(0)
    a = rng.integers(0, 20, M).astype(np.int8)
    b = rng.integers(0, 20, N).astype(np.int8)
    sc = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    best = _time_min(lambda: score(a, b, sc, substitution=BLOSUM62), reps=3)
    return round(M * N / best / 1e9, 3)


def bench_pairs_small(B=64, mp=1056, plan="auto"):
    """Effective GCUPS of batch_score on B same-shape mp^2 pairs."""
    from swtpu import batch_score
    from swtpu.core.encode import random_batch

    a, b = random_batch(B, mp, mp, seed=0)
    best = _time_min(lambda: batch_score(a, b, plan=plan).scores, reps=3)
    return round(B * mp * mp / best / 1e9, 3)


def _search_case(B=2048, qlen=152, L=1_000_000):
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 4, L).astype(np.int8)
    queries = rng.integers(0, 4, (B, qlen)).astype(np.int8)
    for i in range(0, B, 4):       # plant a quarter of the reads
        p = int(rng.integers(0, L - qlen))
        queries[i] = ref[p: p + qlen]
    return queries, ref


def bench_db_search():
    """Database-search effective GCUPS (2048 reads x a 1 Mb reference)
    through search(), and align_hits(top=512) records per second."""
    from swtpu import align_hits, search

    queries, ref = _search_case()
    best = _time_min(lambda: search(queries, ref).scores, reps=2)
    hits = jax.block_until_ready(search(queries, ref))
    t0 = time.perf_counter()
    recs = align_hits(hits, queries, ref, top=512)
    tb_s = time.perf_counter() - t0
    return (round(queries.size * len(ref) / best / 1e9, 3),
            round(len(recs) / tb_s, 1))


def bench_db_search_host_simd():
    """The same search forced onto the host SIMD scorer."""
    from swtpu import search

    queries, ref = _search_case()
    best = _time_min(lambda: search(queries, ref, plan="host-simd").scores,
                     reps=1)
    return round(queries.size * len(ref) / best / 1e9, 3)


def bench_full_align():
    """align()+traceback wall time at the headline size — the phase the
    reference compiles OUT of its benches (-DSKIP_BACKTRACK=1)."""
    from swtpu import align
    from swtpu.core.encode import random_pair

    a, b = random_pair(M, N, seed=0)
    r = align(a, b, traceback=True)               # warm / compile
    if not r.aligned_a:
        raise RuntimeError("traceback produced no alignment")
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        align(a, b, traceback=True)
        best = min(best, time.perf_counter() - t0)
    return round(best, 3)


def main() -> int:
    from swtpu.core.runtime import enable_compile_cache
    from swtpu.instrument.device import device_identity

    enable_compile_cache()
    device = device_identity()
    if device["platform"] == "cpu":
        print("bench.py measures an accelerator; JAX found only the CPU "
              f"({device})", file=sys.stderr)
        return 2
    fill_s, score, compile_s, plan = bench_headline()
    gcups = M * N / fill_s / 1e9
    details = {
        "m": M, "n": N, "plan": plan, "fill_s": fill_s,
        "compile_s": round(compile_s, 2), "score": score,
        "device": device,
        "baseline": "reference v1 OpenMP 44T lassen, 0.54 GCUPS @25632^2",
    }
    extras = {
        "gcups_protein_blosum62_affine": bench_protein,
        "gcups_pairs64_1056sq_effective": bench_pairs_small,
        "gcups_pairs64_1056sq_effective_host_simd":
            lambda: bench_pairs_small(plan="host-simd"),
        "gcups_db_search_2048x1Mb_effective__aln_per_s_top512":
            bench_db_search,
        "gcups_db_search_2048x1Mb_effective_host_simd":
            bench_db_search_host_simd,
        "align_traceback_25632sq_s": bench_full_align,
    }
    for name, fn in extras.items():
        details[name] = fn()            # a failing extra fails the run
    print(json.dumps({
        "metric": "single_device_fill_GCUPS",
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / BASELINE_GCUPS,
        "details": details,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
