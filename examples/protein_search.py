"""End-to-end protein search example: BLOSUM62 + affine gaps.

    python examples/protein_search.py

Capability extension over the reference (DNA match/mismatch only,
serial_smithW.c:251-256): a batch of peptide queries is scored against a
protein database with the embedded substitution table on device (the
vmapped scan window sweep), and the best hit gets an exact Gotoh alignment
via the affine-aware traceback.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import swtpu                                          # noqa: E402
from swtpu.core.encode import PROTEIN_ALPHABET        # noqa: E402
from swtpu.core.substitution import BLOSUM62          # noqa: E402
from swtpu.dist.database import pad_queries, search   # noqa: E402


def main():
    rng = np.random.default_rng(1)
    scoring = swtpu.Scoring(mode="affine", gap_open=-11, gap_extend=-1)

    # demo database: one long concatenated protein sequence
    db = rng.integers(0, 20, 100_000).astype(np.int8)

    # queries: mutated fragments of the database + one random decoy
    queries = []
    for _ in range(200):
        pos = int(rng.integers(0, len(db) - 64))
        q = db[pos:pos + 64].copy()
        muts = rng.integers(0, 64, 6)
        q[muts] = (q[muts] + rng.integers(1, 20, 6)) % 20
        queries.append(q)
    queries.append(rng.integers(0, 20, 64).astype(np.int8))
    padded = pad_queries(queries, 64)

    t0 = time.perf_counter()
    hits = search(padded, db, scoring=scoring, substitution=BLOSUM62)
    scores = np.asarray(hits.scores)
    pos = np.asarray(hits.ref_pos)
    dt = time.perf_counter() - t0
    cells = padded.shape[0] * 64 * len(db)
    print(f"searched {padded.shape[0]} peptides x {len(db)/1e3:.0f} kaa "
          f"in {dt:.1f}s incl. compile ({cells/dt/1e9:.2f} GCUPS)")

    best = int(np.argmax(scores))
    end = int(pos[best])
    lo = max(0, end - 100)
    window = db[lo:end + 1]
    aln = swtpu.align(window, queries[best], scoring=scoring,
                      substitution=BLOSUM62, alphabet=PROTEIN_ALPHABET)
    print(f"best hit: query{best} score {int(scores[best])} "
          f"ending at database position {end}")
    print(f"  query: {aln.aligned_b}")
    print(f"  db   : {aln.aligned_a}")
    assert int(scores[best]) == aln.max_score, (int(scores[best]),
                                                aln.max_score)
    print("traceback re-score: OK")


if __name__ == "__main__":
    main()
