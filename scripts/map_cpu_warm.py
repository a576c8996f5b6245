#!/usr/bin/env python
"""CPU mapping benchmark, cold + warm. Same shape as map_cpu_r4.json;
writes bench_results/map_cpu_r5.json:

    JAX_PLATFORMS=cpu python scripts/map_cpu_warm.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swtpu.core.runtime import enable_compile_cache  # noqa: E402
from swtpu.dist.mapping import map_reads  # noqa: E402


def synth_mapping_workload(L=1_000_000, B=2000, qlen=100, seed=7,
                           err=0.02):
    """The mapping benchmark's workload: B reads of qlen bases planted in
    a random L-base reference with 2% substitution errors."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.int8)
    reads = []
    for _ in range(B):
        s = int(rng.integers(0, L - qlen))
        r = ref[s:s + qlen].copy()
        errs = rng.random(qlen) < err
        r[errs] = (r[errs] + rng.integers(1, 4, errs.sum())) % 4
        reads.append(r)
    return ref, reads


OUT = os.path.join(os.path.dirname(__file__), "..", "bench_results",
                   "map_cpu_r5.json")


def main():
    enable_compile_cache()
    L, B, qlen = 1_000_000, 2000, 100
    ref, reads = synth_mapping_workload(L, B, qlen)
    t0 = time.perf_counter()
    res = map_reads(ref, reads)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = map_reads(ref, reads)
    warm = time.perf_counter() - t0
    mapped = sum(1 for r in res.records if not r.is_unmapped)
    out = {"name": "map-cpu-r5", "B": B, "qlen": qlen, "L": L,
           "mapped": mapped,
           "cold_s": round(cold, 2), "cold_reads_per_s": round(B / cold, 1),
           "warm_s": round(warm, 2), "warm_reads_per_s": round(B / warm, 1),
           "note": "host-simd both-strand top-2 search + native hit "
                   "alignment, single CPU host, warm = second call in "
                   "the same process (compiles + memos hot)"}
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
