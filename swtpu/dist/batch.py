"""Data-parallel batched alignment over a device mesh.

The reference processes one pair per process (SURVEY.md §2.6: data
parallelism is absent). Here a batch of pairs shards across chips with
`shard_map`; each device vmaps the scan fill over its shard, and the
global best hit merges with a deterministic lexicographic reduction —
replacing the reference's `omp critical` (omp_smithW.c:384-387) and
atomicCAS retry loops (cuda_global_mem_smithW.cu:246-260) with a
race-free-by-construction collective.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import EngineConfig, Scoring
from ..kernels.scan_fill import scan_fill


class BatchHits(NamedTuple):
    scores: jax.Array      # (B,) int32 max score per pair
    max_i: jax.Array       # (B,) int32 padded row of each pair's first max
    max_j: jax.Array       # (B,) int32


class BestHit(NamedTuple):
    score: jax.Array       # () int32 best score over the whole batch
    pair: jax.Array        # () int32 index of the first best pair
    max_i: jax.Array       # () int32
    max_j: jax.Array       # () int32


def _sub_to_table(substitution):
    """Embedded (A+3, A+3) device table for the scan plan, or None."""
    if substitution is None:
        return None
    import numpy as np
    from ..core.substitution import embed_sentinels
    return jnp.asarray(embed_sentinels(np.asarray(substitution)))


def _pair_fill(a, b, scoring, band, sub_table=None):
    out = scan_fill(a, b, scoring=scoring, band=band, sub_table=sub_table)
    return out.max_score, out.max_i, out.max_j


BATCH_PLANS = ("auto", "scan", "host-simd", "pipeline")


def batch_score(a_batch, b_batch, scoring: Scoring = Scoring(),
                band: Optional[int] = None, plan: str = "auto",
                mesh: Optional[Mesh] = None,
                substitution=None) -> BatchHits:
    """Single-device batched scoring (or, with ``mesh`` and
    plan='pipeline', the bubble-filled multi-device pipeline).

    'auto' runs the vmapped XLA scan on an accelerator, and the striped
    SIMD host scorer (csrc sw_score_simd_batch) for eager calls on the CPU
    platform, where it is the faster way to use the same cores.
    plan='scan' / 'host-simd' force a path; plan='pipeline' with a mesh
    streams the pairs through dist.pipeline.pipeline_align_batch — the
    wavefront ramp bubble amortizes over the whole batch."""
    if plan not in BATCH_PLANS:
        raise ValueError(
            f"unknown batch plan {plan!r}; expected one of {BATCH_PLANS}")
    B, m = a_batch.shape
    n = b_batch.shape[1]
    if plan == "host-simd":
        # a forced host tier must either run or fail loudly — silently
        # ignoring the mesh / falling through to the vmapped scan would
        # hide that the requested backend was not used (ADVICE r4;
        # matches database._searcher_plan's contract)
        if mesh is not None:
            raise ValueError(
                "plan='host-simd' batch scoring runs on the host — it "
                "cannot be combined with a device mesh")
        if band is not None:
            raise ValueError(
                "plan='host-simd' batch scoring does not support band; "
                "use plan='auto'/'scan' (vmapped scan) for banded batches")
        if isinstance(a_batch, jax.core.Tracer) \
                or isinstance(b_batch, jax.core.Tracer):
            raise ValueError(
                "plan='host-simd' needs concrete (eager) inputs — inside "
                "jit/shard_map use plan='auto' instead")
    if mesh is not None and band is None and plan == "pipeline":
        # host-level routing (never under a trace: mesh dispatch happens
        # before any shard_map)
        import numpy as np
        from ..dispatch.plan import pipeline_block_rows
        from .pipeline import pipeline_align_batch
        axis = list(mesh.shape.keys())[0]
        br = pipeline_block_rows(m, n, mesh.shape[axis])
        res = pipeline_align_batch(np.asarray(a_batch),
                                   np.asarray(b_batch), mesh,
                                   block_rows=br, scoring=scoring,
                                   axis=axis, substitution=substitution)
        return BatchHits(res.scores, res.max_i, res.max_j)
    # host striped-SIMD route (CPU platform, eager calls only — inside
    # shard_map/jit the inputs are tracers and the device plans apply):
    # exact scores AND first-occurrence positions at multi-GCUPS per core
    # (csrc sw_score_simd_batch, OpenMP across pairs) instead of the
    # vmapped-scan rate. Self-gating: int16 score caps, sentinel codes,
    # degenerate scorings all fall through.
    if plan in ("auto", "host-simd") and band is None \
            and not isinstance(a_batch, jax.core.Tracer) \
            and not isinstance(b_batch, jax.core.Tracer):
        from ..dispatch.plan import capability
        if plan == "host-simd" or capability().platform == "cpu":
            import numpy as np
            from ..runtime_native import score_simd_batch
            got = score_simd_batch(np.asarray(a_batch),
                                   np.asarray(b_batch),
                                   scoring, substitution)
            if got is not None:
                s, i, j = got
                return BatchHits(jnp.asarray(s), jnp.asarray(i),
                                 jnp.asarray(j))
            if plan == "host-simd":
                from ..runtime_native import simd_reject_reason
                raise ValueError(
                    "plan='host-simd' was forced but the host SIMD tier "
                    "is ineligible for this problem: "
                    f"{simd_reject_reason(m, n, scoring, substitution)}")
    a_batch = jnp.asarray(a_batch)
    b_batch = jnp.asarray(b_batch)
    s, i, j = jax.vmap(
        functools.partial(_pair_fill, scoring=scoring, band=band,
                          sub_table=_sub_to_table(substitution))
    )(a_batch, b_batch)
    return BatchHits(s, i, j)


def _bucket_len(x: int) -> int:
    """Next power of two (min 16): heterogeneous pairs land in ~log2
    shape buckets, so compiled programs are reused across calls and K
    problems pay one dispatch per BUCKET, not one per problem."""
    return max(16, 1 << (x - 1).bit_length())


def _pad_exact(scoring: Scoring, substitution) -> bool:
    """Is trailing sentinel padding provably score- and
    position-preserving? a pads with -3, b with -2, so sentinel never
    meets an equal sentinel: every pad-involving cell scores a mismatch
    (raw-compare parity) or a strongly negative substitution sentinel
    row — with negative gaps the padded region can never rise above the
    zero floor, and pad cells come AFTER every real cell of their row in
    row-major order, so the first-occurrence argmax is unchanged."""
    if scoring.is_affine:
        gaps = scoring.gap_open < 0 and scoring.gap_extend < 0
    else:
        gaps = scoring.gap < 0
    if substitution is not None:
        return gaps           # sentinel rows embed strongly negative
    return gaps and scoring.mismatch < 0


def score_many(a_list, b_list, scoring: Scoring = Scoring(),
               substitution=None, plan: str = "auto",
               mesh: Optional[Mesh] = None) -> BatchHits:
    """Exact batched scoring of HETEROGENEOUS-shape pairs.

    `batch_score` needs same-shape batches; real workloads (candidate
    re-scoring, all-vs-all sweeps) rarely have them, and scoring K
    mid-size pairs one `score()` at a time pays K device round-trips
    (the flat per-call dispatch floor). Here pairs are padded
    into power-of-two shape buckets (exact — see `_pad_exact`) and each
    bucket runs ONE `batch_score` sweep, so K problems cost one dispatch
    per bucket (~log² distinct shapes) and compiled programs are reused
    across calls. Scorings where padding cannot be proven exact
    (non-negative mismatch or gaps) fall back to per-pair `align`.

    Returns `BatchHits` aligned with the input order; positions are
    1-based padded coordinates of each pair's own matrix, bit-equal to
    the oracle's row-major first-occurrence rule."""
    import numpy as np

    B = len(a_list)
    if len(b_list) != B:
        raise ValueError(
            f"{B} a-sequences vs {len(b_list)} b-sequences")
    scores = np.zeros(B, np.int32)
    mi = np.zeros(B, np.int32)
    mj = np.zeros(B, np.int32)
    if not _pad_exact(scoring, substitution):
        from ..engine.align import align as _align
        for k in range(B):
            res = _align(np.asarray(a_list[k], np.int8),
                         np.asarray(b_list[k], np.int8), scoring,
                         traceback=False, substitution=substitution)
            scores[k], mi[k], mj[k] = res.max_score, res.max_i, res.max_j
        return BatchHits(jnp.asarray(scores), jnp.asarray(mi),
                         jnp.asarray(mj))
    buckets: dict = {}
    for k in range(B):
        m, n = len(a_list[k]), len(b_list[k])
        if m == 0 or n == 0:
            continue          # empty operand: all-zero matrix
        buckets.setdefault((_bucket_len(m), _bucket_len(n)),
                           []).append(k)
    for (mb, nb), idx in sorted(buckets.items()):
        aa = np.full((len(idx), mb), -3, np.int8)
        bb = np.full((len(idx), nb), -2, np.int8)
        for r, k in enumerate(idx):
            aa[r, :len(a_list[k])] = a_list[k]
            bb[r, :len(b_list[k])] = b_list[k]
        hits = batch_score(aa, bb, scoring, plan=plan, mesh=mesh,
                           substitution=substitution)
        s = np.asarray(hits.scores)
        i_ = np.asarray(hits.max_i)
        j_ = np.asarray(hits.max_j)
        for r, k in enumerate(idx):
            scores[k], mi[k], mj[k] = s[r], i_[r], j_[r]
    return BatchHits(jnp.asarray(scores), jnp.asarray(mi),
                     jnp.asarray(mj))


def batch_align(a_batch, b_batch, scoring: Scoring = Scoring(),
                band: Optional[int] = None, plan: str = "auto",
                mesh: Optional[Mesh] = None, substitution=None,
                alphabet: Optional[str] = None, top: Optional[int] = None):
    """Batched scoring + alignment strings: scores every pair in one
    device sweep (`batch_score`), then tracebacks the selected pairs on
    the host — per-pair `engine.align` calls ride the normal dispatch
    (tiny pairs hit the native host tier). Returns a list of
    (pair index, Alignment) sorted best-first; ``top`` limits how many
    pairs get tracebacks (scores are computed for all)."""
    import numpy as np

    from ..engine.align import align as _align

    hits = batch_score(a_batch, b_batch, scoring, band=band, plan=plan,
                       mesh=mesh, substitution=substitution)
    scores = np.asarray(hits.scores)
    order = sorted((i for i in range(len(scores)) if scores[i] > 0),
                   key=lambda i: (-scores[i], i))
    if top is not None:
        order = order[:top]
    a_np, b_np = np.asarray(a_batch, np.int8), np.asarray(b_batch, np.int8)
    kw = {} if alphabet is None else {"alphabet": alphabet}
    out = []
    # raised host-tier cap: pairs small enough run the native C fill
    # with a free host traceback instead of a per-pair device dispatch
    # (same routing as dist.database.align_hits)
    cfg = EngineConfig(band=band, host_max_cells=1 << 20)
    for i in order:
        res = _align(a_np[i], b_np[i], scoring, cfg, traceback=True,
                     substitution=substitution, **kw)
        if res.max_score != int(scores[i]):   # pragma: no cover - guard
            raise AssertionError(
                f"pair {i}: batch score {int(scores[i])} != "
                f"re-aligned {res.max_score}")
        out.append((i, res))
    return out


def align_many(a_list, b_list, scoring: Scoring = Scoring(),
               substitution=None, plan: str = "auto",
               mesh: Optional[Mesh] = None,
               alphabet: Optional[str] = None, top: Optional[int] = None):
    """`batch_align` for HETEROGENEOUS-shape pairs: one bucketed
    `score_many` sweep for all scores, then host tracebacks of the
    selected pairs (best-first; ``top`` limits tracebacks, scores are
    computed for all). Returns a list of (pair index, Alignment) sorted
    best-first, exactly `batch_align`'s contract."""
    import numpy as np

    from ..engine.align import align as _align

    hits = score_many(a_list, b_list, scoring, plan=plan, mesh=mesh,
                      substitution=substitution)
    scores = np.asarray(hits.scores)
    order = sorted((i for i in range(len(scores)) if scores[i] > 0),
                   key=lambda i: (-scores[i], i))
    if top is not None:
        order = order[:top]
    kw = {} if alphabet is None else {"alphabet": alphabet}
    out = []
    cfg = EngineConfig(host_max_cells=1 << 20)
    for i in order:
        res = _align(np.asarray(a_list[i], np.int8),
                     np.asarray(b_list[i], np.int8), scoring, cfg,
                     traceback=True, substitution=substitution, **kw)
        if res.max_score != int(scores[i]):   # pragma: no cover - guard
            raise AssertionError(
                f"pair {i}: bucketed score {int(scores[i])} != "
                f"re-aligned {res.max_score}")
        out.append((i, res))
    return out


def make_sharded_batch_scorer(mesh: Mesh, scoring: Scoring = Scoring(),
                              band: Optional[int] = None, axis: str = "data",
                              substitution=None):
    """Build a jitted scorer: (B, m) x (B, n) -> BatchHits, batch sharded
    over `axis`. B must divide evenly by the axis size (pad the batch)."""

    def local(a_shard, b_shard):
        return batch_score(a_shard, b_shard, scoring, band,
                           substitution=substitution)

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=BatchHits(P(axis), P(axis), P(axis)),
        check_vma=False,   # scan carry inits are replicated constants
    )
    return jax.jit(sharded)


def make_best_hit_reducer(mesh: Mesh, scoring: Scoring = Scoring(),
                          band: Optional[int] = None, axis: str = "data",
                          substitution=None):
    """Build a jitted database-search reducer: returns only the global best
    hit (score, pair index, position), merged across devices with a packed
    lexicographic pmax — deterministic first-occurrence semantics matching
    the oracle's row-major rule extended to batch order."""

    def local(a_shard, b_shard):
        hits = batch_score(a_shard, b_shard, scoring, band,
                           substitution=substitution)
        local_b = hits.scores.shape[0]
        base = lax.axis_index(axis) * local_b
        pair_ids = base + jnp.arange(local_b, dtype=jnp.int32)
        # local argmax with first-pair-wins tie rule
        k = jnp.argmax(hits.scores)
        s, i, j, pid = hits.scores[k], hits.max_i[k], hits.max_j[k], pair_ids[k]
        # deterministic global merge (int32 throughout — no x64 needed):
        # 1) pmax the score; 2) pmin the pair id among score-winners
        # (first-pair-wins tie rule); 3) the unique winner broadcasts its
        # coordinates via psum of masked values.
        best_score = lax.pmax(s, axis)
        cand = jnp.where(s == best_score, pid, jnp.int32(2**31 - 1))
        best_pair = lax.pmin(cand, axis)
        mine = (best_pair == pid) & (s == best_score)
        bi = lax.psum(jnp.where(mine, i, 0), axis)
        bj = lax.psum(jnp.where(mine, j, 0), axis)
        return BestHit(best_score, best_pair, bi, bj)

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=BestHit(P(), P(), P(), P()),
        check_vma=False,   # scan carry inits are replicated constants
    )
    return jax.jit(sharded)
