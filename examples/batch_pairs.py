#!/usr/bin/env python
"""Batched pair scoring: one dispatch for many small alignments.

The reference processes ONE pair per process (omp_smithW.c:87-96);
below ~4k^2 a single device call is dominated by the dispatch floor, so
the answer to many small problems is batching. `batch_score`'s auto plan
picks the fastest backend for the platform:

- GPU (or any accelerator)         -> vmapped XLA scan on the device
- CPU platform (eager calls)       -> striped AVX2/AVX-512 host fill,
  OpenMP across pairs (exact scores AND positions)
- banded, or inside jit/shard_map  -> vmapped XLA scan

Run on the CPU: JAX_PLATFORMS=cpu python examples/batch_pairs.py [B] [size]
On a GPU machine: python examples/batch_pairs.py [B] [size]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from swtpu.core.encode import random_batch       # noqa: E402
from swtpu.dist.batch import batch_score         # noqa: E402


def main() -> int:
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 1056
    a, b = random_batch(B, size, size, seed=0)
    # plant a strong alignment in pair 3 so the output is non-trivial
    b[3, 10: 10 + size // 2] = a[3, 5: 5 + size // 2]

    t0 = time.perf_counter()
    hits = batch_score(a, b)
    scores = np.asarray(hits.scores)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(batch_score(a, b).scores)           # warm: steady state
    warm = time.perf_counter() - t0

    print(f"{B} pairs of {size}x{size}: cold {cold * 1e3:.1f} ms "
          f"(backend init + compile), warm {warm * 1e3:.1f} ms "
          f"= {B * size * size / warm / 1e9:.2f} effective GCUPS")
    top = np.argsort(-scores)[:5]
    for g in top:
        print(f"  pair {g:3d}: score {scores[g]:6d} at "
              f"(i={int(hits.max_i[g])}, j={int(hits.max_j[g])})")
    assert int(np.argmax(scores)) == 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
