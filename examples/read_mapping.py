"""End-to-end read-mapping example: FASTA in (native C++ reader), sharded
database search on the device, exact alignment strings out.

    python examples/read_mapping.py          # generates demo data, runs

The reference's workflow is one pair per process with printf output
(omp_smithW.c:99-101); this is the production shape its design points at:
many reads vs a long reference, batched on the device, exact tracebacks
for the hits you care about.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import swtpu                                       # noqa: E402
from swtpu.core.encode import DNA_ALPHABET         # noqa: E402
from swtpu.dist.database import (make_searcher, pad_queries,  # noqa: E402
                                 shard_reference)
from swtpu.runtime_native import read_seqfile      # noqa: E402


def write_fasta(path, named):
    with open(path, "w") as f:
        for name, codes in named.items():
            f.write(f">{name}\n")
            f.write("".join(DNA_ALPHABET[c] for c in codes) + "\n")


def main():
    rng = np.random.default_rng(0)

    # --- make a demo reference + reads (with mutations), via FASTA files
    # (sizes overridable for a quick smoke run on CPU:
    #  SWTPU_DEMO_REF=20000 SWTPU_DEMO_READS=50 python examples/read_mapping.py)
    ref_len = int(os.environ.get("SWTPU_DEMO_REF", 200_000))
    n_reads = int(os.environ.get("SWTPU_DEMO_READS", 2000))
    ref_codes = rng.integers(0, 4, ref_len).astype(np.int8)
    reads = []
    for k in range(n_reads):
        pos = int(rng.integers(0, len(ref_codes) - 150))
        r = ref_codes[pos:pos + 150].copy()
        muts = rng.integers(0, 150, 5)
        r[muts] = (r[muts] + rng.integers(1, 4, 5)) % 4   # 5 SNPs per read
        reads.append(r)
    reads.append(rng.integers(0, 4, 150).astype(np.int8))  # one random read

    with tempfile.TemporaryDirectory() as d:
        ref_fa = os.path.join(d, "ref.fa")
        reads_fa = os.path.join(d, "reads.fa")
        write_fasta(ref_fa, {"chr_demo": ref_codes})
        write_fasta(reads_fa, {f"read{k}": r for k, r in enumerate(reads)})

        # --- ingest through the native runtime (csrc FASTA reader)
        ref = read_seqfile(ref_fa)[0]
        qlist = read_seqfile(reads_fa)
        queries = pad_queries(qlist, 152)         # pad reads to 8k rows

        # --- device search: every read vs every reference window.
        # Build the searcher once (jitted); reuse it for every batch.
        import jax.numpy as jnp
        shards, shard_len = shard_reference(ref, 1, 152)
        searcher = make_searcher(None, qlen=152, shard_len=shard_len)
        q, sh = jnp.asarray(queries), jnp.asarray(shards)
        t0 = time.perf_counter()
        hits = searcher(q, sh)
        np.asarray(hits.scores)
        print(f"(first call incl. jit compile: "
              f"{time.perf_counter() - t0:.1f}s)")
        t0 = time.perf_counter()
        hits = searcher(q, sh)
        scores = np.asarray(hits.scores)
        dt = time.perf_counter() - t0
        cells = queries.shape[0] * 152 * len(ref)
        print(f"searched {queries.shape[0]} reads x {len(ref)/1e3:.0f} kb "
              f"in {dt:.2f}s ({cells/dt/1e9:.1f} GCUPS effective)")

        # --- exact alignments (coords + CIGAR) for the top hits
        recs = swtpu.align_hits(hits, queries, ref, top=3)
        for r in recs:
            print(f"read{r.read}: score {r.score} at "
                  f"ref[{r.ref_start}:{r.ref_end + 1}]  {r.cigar}")
            print(f"  read: {r.aligned_read}")
            print(f"  ref : {r.aligned_ref}")
        assert recs[0].score == int(scores.max())

        # --- and as SAM
        print(swtpu.to_sam(recs, queries, ref_name="chr_demo",
                           ref_len=len(ref)), end="")

    # --- or: the WHOLE pipeline (search -> pairing -> MAPQ -> records)
    # as one library call — paired-end, with proper-pair flags and mate
    # fields (python -m swtpu map is a file-IO wrapper around this)
    from swtpu.core.encode import revcomp
    r1 = [ref_codes[5000:5150].copy(), ref_codes[9000:9150].copy()]
    r2 = [revcomp(ref_codes[5300:5450]), revcomp(ref_codes[9350:9500])]
    res = swtpu.map_reads([ref_codes], r1, reads2=r2,
                          ref_names=["chr_demo"], sort=True)
    mapped = [r for r in res.records if not r.is_unmapped]
    print(f"\npaired-end map_reads: {len(mapped)} records, proper flags "
          f"{[hex(r.flag_extra) for r in mapped]}, "
          f"TLENs {[r.tlen for r in mapped]}")


if __name__ == "__main__":
    main()
