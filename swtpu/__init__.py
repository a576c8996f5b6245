"""swtpu — Smith-Waterman local alignment framework in JAX.

Built from scratch in JAX/XLA with a CUDA wavefront kernel for Hopper GPUs,
with the capabilities of the reference C/OpenMP/CUDA codebase
(chunhualiao/Smith-Waterman): exact int32 wavefront DP fill, max-score
tracking, traceback, multiple execution plans behind one API, adaptive
dispatch, banded and affine-gap modes, batched and multi-device
(shard_map) scaling.
"""

from .core.config import (
    BUILTIN_A,
    BUILTIN_B,
    BUILTIN_LAST_CELL,
    BUILTIN_MAX_POS,
    BUILTIN_MAX_SCORE,
    DIAGONAL,
    LEFT,
    NONE,
    PATH,
    UP,
    EngineConfig,
    Scoring,
)
from .core.encode import decode, encode, random_batch, random_pair, revcomp
from .engine.align import Alignment, align, score
from .engine.traceback import AnchoredReverseMismatch

__version__ = "0.3.0"


def search(queries, reference, **kw):
    """Database search: a batch of reads vs a (sharded) reference —
    see `swtpu.dist.database.search`."""
    from .dist.database import search as _search
    return _search(queries, reference, **kw)


def align_hits(hits, queries, reference, **kw):
    """Alignment records (coords + CIGAR + strings) for search hits —
    see `swtpu.dist.database.align_hits`."""
    from .dist.database import align_hits as _align_hits
    return _align_hits(hits, queries, reference, **kw)


def to_sam(records, queries, **kw):
    """Render `align_hits` records as minimal SAM —
    see `swtpu.dist.database.to_sam`."""
    from .dist.database import to_sam as _to_sam
    return _to_sam(records, queries, **kw)


def pair_hits(hits1, hits2, **kw):
    """Proper-pair mate selection for paired-end reads from each end's
    `search(strand="both", n_best=2)` — see
    `swtpu.dist.database.pair_hits`."""
    from .dist.database import pair_hits as _pair_hits
    return _pair_hits(hits1, hits2, **kw)


def map_reads(ref_seqs, reads, **kw):
    """The whole read-mapping pipeline as one call (search -> pairing ->
    host-tier hit alignment -> SAM-ready records) —
    see `swtpu.dist.mapping.map_reads`."""
    from .dist.mapping import map_reads as _map_reads
    return _map_reads(ref_seqs, reads, **kw)


def batch_score(a_batch, b_batch, **kw):
    """Score B independent pairs in one dispatch (vmapped scan on a
    device, host SIMD on the CPU platform) —
    see `swtpu.dist.batch.batch_score`."""
    from .dist.batch import batch_score as _batch_score
    return _batch_score(a_batch, b_batch, **kw)


def score_many(a_list, b_list, **kw):
    """Exact batched scoring of heterogeneous-shape pairs (power-of-two
    shape bucketing, one dispatch per bucket);
    see `swtpu.dist.batch.score_many`."""
    from .dist.batch import score_many as _score_many
    return _score_many(a_list, b_list, **kw)


def batch_align(a_batch, b_batch, **kw):
    """Batched scoring + per-pair alignment records, best-first —
    see `swtpu.dist.batch.batch_align`."""
    from .dist.batch import batch_align as _batch_align
    return _batch_align(a_batch, b_batch, **kw)


def align_many(a_list, b_list, **kw):
    """batch_align for heterogeneous-shape pairs (bucketed score_many +
    best-first host tracebacks) — see `swtpu.dist.batch.align_many`."""
    from .dist.batch import align_many as _align_many
    return _align_many(a_list, b_list, **kw)


__all__ = [
    "align", "score", "search", "align_hits", "to_sam",
    "pair_hits", "map_reads", "batch_score", "batch_align", "score_many",
    "align_many",
    "Alignment", "Scoring", "EngineConfig",
    "AnchoredReverseMismatch",
    "encode", "decode", "random_pair", "random_batch", "revcomp",
    "NONE", "UP", "LEFT", "DIAGONAL", "PATH",
    "BUILTIN_A", "BUILTIN_B", "BUILTIN_MAX_SCORE", "BUILTIN_MAX_POS",
    "BUILTIN_LAST_CELL",
]
