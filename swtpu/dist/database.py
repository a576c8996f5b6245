"""Database search: a batch of short reads vs a long (sharded) reference.

The reference codebase aligns exactly one pair per process; this driver is
the production workload its design points at (BASELINE.json config 5: 1M
reads vs a sharded 100Mb reference on a multi-host slice):

* the reference sequence shards across the mesh axis, each shard extended
  by a read-length overlap halo so alignments crossing shard boundaries are
  not lost (an alignment of a read spans < qlen reference bases beyond any
  boundary);
* each device streams its shard through fixed-size windows (again halo-
  overlapped) and scores the whole replicated read batch against each
  window with the vmapped wavefront fill — reads sit in vector lanes, so
  one device step computes batch x window cells;
* per-read bests merge locally across windows in the scan carry, then
  across devices with elementwise pmax + deterministic winner-broadcast
  (lowest reference position wins ties), all over device collectives —
  no atomics, unlike the reference's omp critical / atomicCAS
  (omp_smithW.c:384-387, simple-cuda/cuda_global_mem_smithW.cu:246-260).

Multi-host: identical code; build the mesh over all hosts' devices after
`jax.distributed.initialize` (dist/mesh.py) and feed each host its
process-local shard of the reference via `jax.make_array_from_process_...`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..core.config import Scoring
from ..kernels.scan_fill import scan_fill


class SearchHits(NamedTuple):
    scores: jax.Array     # (B,) int32 best score per read
    ref_pos: jax.Array    # (B,) int32 global 0-based ref index of the
    #                       alignment end column (-1 if score 0)
    read_end: jax.Array   # (B,) int32 1-based padded row of the read end


def _window_scorer(scoring: Scoring, substitution=None):
    sub_table = None
    if substitution is not None:
        from ..core.substitution import embed_sentinels
        sub_table = jnp.asarray(embed_sentinels(np.asarray(substitution)))

    def one(query, window):
        out = scan_fill(window, query, scoring=scoring,
                        sub_table=sub_table)
        return out.max_score, out.max_i, out.max_j
    return jax.vmap(one, in_axes=(0, None))


class SearchHits2(NamedTuple):
    """Best two hits per read at DISTINCT loci — end positions more than
    a read length apart, so the two window views of one boundary-
    straddling alignment never count as two loci (multi-mapping /
    chimera detection; see `make_searcher(n_best=2)`). Secondary fields
    are 0 / -1 / 0 when no second locus scored > 0."""

    scores: jax.Array
    ref_pos: jax.Array
    read_end: jax.Array
    scores2: jax.Array
    ref_pos2: jax.Array
    read_end2: jax.Array

    @property
    def primary(self) -> SearchHits:
        return SearchHits(self.scores, self.ref_pos, self.read_end)

    @property
    def secondary(self) -> SearchHits:
        return SearchHits(self.scores2, self.ref_pos2, self.read_end2)


class StrandedHits2(NamedTuple):
    """Best two hits per read across both strands and distinct loci
    (see `search(strand="both", n_best=2)`)."""

    scores: jax.Array
    ref_pos: jax.Array
    read_end: jax.Array
    strand: jax.Array
    scores2: jax.Array
    ref_pos2: jax.Array
    read_end2: jax.Array
    strand2: jax.Array

    @property
    def primary(self) -> StrandedHits:
        return StrandedHits(self.scores, self.ref_pos, self.read_end,
                            self.strand)

    @property
    def secondary(self) -> StrandedHits:
        return StrandedHits(self.scores2, self.ref_pos2, self.read_end2,
                            self.strand2)


def _read_lengths(queries) -> jax.Array:
    """(B,) int32 unpadded read lengths of a `pad_queries` batch (count of
    non ``-3`` codes per row) — the per-read locus-dedup distance."""
    return jnp.sum(queries != -3, axis=1).astype(jnp.int32)


def _upd2(carry, s, pos, qi, min_dist=0):
    """Fold one candidate (score s, global end col pos, read end qi) into
    a top-2-distinct-loci carry. Two slots hold DISTINCT loci: end
    positions more than ``min_dist`` apart. Pass the read length — a
    scalar, or a (B,) vector of per-read lengths so a short read's dedup
    radius in a mixed-length batch is its OWN length rather than the
    padded batch length. Why the read length: a
    boundary-straddling alignment is seen twice by overlapping windows,
    once end-truncated at the boundary with a shifted end position, so
    exact-position dedup is not enough; any candidate within a read
    length of the primary is a view of the same alignment, while real
    extra loci of the same read necessarily end further away). A
    same-position (or near-position, better-scoring) candidate refreshes
    its slot. Ties prefer the lower position, matching the single-best
    searcher."""
    s1, p1, e1, s2, p2, e2 = carry
    near1 = jnp.abs(pos - p1) <= min_dist
    near2 = jnp.abs(pos - p2) <= min_dist
    # same-locus refresh (the untruncated view of a known alignment)
    r1 = near1 & (s > s1)
    s1_, e1_ = jnp.where(r1, s, s1), jnp.where(r1, qi, e1)
    p1_ = jnp.where(r1, pos, p1)
    r2 = near2 & (s > s2) & ~near1
    s2_, e2_ = jnp.where(r2, s, s2), jnp.where(r2, qi, e2)
    p2_ = jnp.where(r2, pos, p2)
    # distinct-locus competition
    fresh = (s > 0) & ~near1
    new1 = fresh & ((s > s1_) | ((s == s1_) & (pos < p1_)))
    new2 = fresh & ~new1 & ~near2 \
        & ((s > s2_) | ((s == s2_) & (pos < p2_)))
    # on promotion the old slot-1 (necessarily > min_dist away, since a
    # near candidate takes the refresh path instead) drops to slot 2
    s2n = jnp.where(new1, s1_, jnp.where(new2, s, s2_))
    p2n = jnp.where(new1, p1_, jnp.where(new2, pos, p2_))
    e2n = jnp.where(new1, e1_, jnp.where(new2, qi, e2_))
    # a new primary can also invalidate a slot 2 that sits within
    # min_dist of it (e.g. an earlier truncated view of the new winner)
    kill2 = jnp.abs(p2n - jnp.where(new1, pos, p1_)) <= min_dist
    s2n = jnp.where(kill2, 0, s2n)
    p2n = jnp.where(kill2, 2**31 - 1, p2n)
    e2n = jnp.where(kill2, 0, e2n)
    return (jnp.where(new1, s, s1_), jnp.where(new1, pos, p1_),
            jnp.where(new1, qi, e1_), s2n, p2n, e2n)


def _merge2(c, other, min_dist: int = 0):
    """Merge another top-2 carry (e.g. a neighbour device's) into c."""
    c = _upd2(c, other[0], other[1], other[2], min_dist)
    return _upd2(c, other[3], other[4], other[5], min_dist)


def _searcher_plan(mesh: Optional[Mesh], qlen: int, window: int,
                   scoring: Scoring, plan: str, substitution=None) -> str:
    if plan != "auto":
        if plan == "host-simd":
            # validate a FORCED host tier upfront: without this, an
            # ineligible config surfaces as a RuntimeError from inside
            # the jitted window sweep's pure_callback — an opaque
            # mid-run failure (ADVICE r4)
            from ..runtime_native import simd_eligible, simd_reject_reason
            if mesh is not None:
                raise ValueError(
                    "plan='host-simd' searches run on the host — it "
                    "cannot be combined with a device mesh")
            w16 = min(window, 32767)
            if qlen > 32767 or not simd_eligible(w16, qlen, scoring,
                                                 substitution):
                raise ValueError(
                    "plan='host-simd' was forced but the host SIMD tier "
                    "is ineligible for this search: "
                    f"{simd_reject_reason(w16, qlen, scoring, substitution)}")
        if plan not in ("scan", "host-simd"):
            raise ValueError(
                f"unknown search plan {plan!r}; expected 'auto', 'scan' "
                "or 'host-simd'")
        return plan
    from ..dispatch.plan import capability
    if mesh is None and capability().platform == "cpu":
        # CPU deployments: the striped AVX host scorer inside the same
        # window-sweep machinery (via pure_callback) — multi-GCUPS per
        # core instead of the vmapped-scan rate on the same cores. On an
        # accelerator the window sweep stays on the device.
        from ..runtime_native import simd_eligible
        if qlen <= 32767 and simd_eligible(min(window, 32767), qlen,
                                           scoring, substitution):
            return "host-simd"
    return "scan"


def _window_plan(qlen: int, shard_len: int, window: int, n_best: int = 1,
                 sec_resolution: int = 2048, plan: str = "scan"):
    """(window, step, nwin) of one shard's sweep: windows of ``window``
    reference columns, ``step = window - qlen`` apart (consecutive windows
    overlap by qlen), over the shard plus its qlen halo."""
    if n_best == 2:
        window = min(window, max(2 * qlen, sec_resolution))
    ext = shard_len + qlen                 # shard + boundary halo
    window = min(window, ext)              # a window never exceeds a shard
    if plan == "host-simd":
        # window coordinates ride the host scorer's int16 lanes
        window = min(window, 32767)
    if window <= qlen:
        raise ValueError(
            f"window ({window}) must exceed the padded read length "
            f"({qlen}): windows overlap by qlen, so the stride would "
            "be non-positive")
    step = window - qlen                   # window stride (qlen overlap)
    nwin = max(1, -(-max(1, ext - qlen) // step))
    return window, step, nwin


def window_spans(ref_len: int, qlen: int, n_shards: int = 1,
                 window: int = 32768, n_best: int = 1,
                 sec_resolution: int = 2048, plan: str = "scan"):
    """Global start columns of every window `search` scores, and the
    window length: window k covers reference columns
    [starts[k], starts[k] + window). This is the search's one
    approximation: each window is scored on its own, so an alignment is
    reported at full score when some window holds its whole reference
    span. Any span of at most qlen columns lies in a window (windows
    overlap by qlen); a gapped alignment spanning more columns that
    crosses every window holding its ends is reported with the best score
    of its parts. How the reference is cut (shard count, window, n_best)
    decides which such alignments are cut, so two searches that differ
    only there can report different scores for such reads; `align_hits`
    re-aligns a hit without windows."""
    shard_len = -(-ref_len // n_shards)
    ext = shard_len + qlen
    window, step, nwin = _window_plan(qlen, shard_len, min(window, ext),
                                      n_best, sec_resolution, plan)
    local = np.minimum(np.arange(nwin) * step, ext - window)
    starts = (np.arange(n_shards)[:, None] * shard_len + local[None, :])
    return starts.reshape(-1), window


def make_searcher(mesh: Optional[Mesh], qlen: int, shard_len: int,
                  window: int = 32768, scoring: Scoring = Scoring(),
                  axis: str = "data", plan: str = "auto", substitution=None,
                  n_best: int = 1, sec_resolution: int = 2048):
    """Build a jitted searcher.

    queries: (B, qlen) int8 (pad reads with -3 sentinel), replicated.
    ref_sharded: (D, shard_len + qlen) int8 — each row is a device's shard
    plus a qlen halo from the next shard (build with `shard_reference`).
    Returns SearchHits with global reference positions — or, with
    ``n_best=2``, SearchHits2 carrying the best two hits at distinct end
    positions per read (multi-mapping detection; the same top-2 carry
    rides the window scan, and devices merge their carries with one
    all_gather).

    Secondary-locus RESOLUTION is the window size: each window
    contributes its single best candidate to the top-2 carry, so two
    loci inside one window collapse to the better one. With n_best=2
    the window is therefore clamped to ``max(2*qlen, sec_resolution)``
    — distinct loci at least that far apart are always separated (the
    extra qlen-overlap cost is ~qlen/window); loci nearer than the
    clamped window (but farther than the read-length dedup distance)
    can still be missed, as in other heuristic-XS mappers.

    The per-window scorer is the vmapped XLA scan on devices and, for
    single-device searches on the CPU platform, the striped SIMD host
    scorer. `window_spans` lists the windows and what they can cut.
    """
    if n_best not in (1, 2):
        raise ValueError(f"n_best must be 1 or 2, got {n_best}")
    ext = shard_len + qlen                 # shard + boundary halo
    window, _, _ = _window_plan(qlen, shard_len, window, n_best,
                                sec_resolution)
    plan = _searcher_plan(mesh, qlen, window, scoring, plan, substitution)
    window, step, nwin = _window_plan(qlen, shard_len, window, n_best,
                                      sec_resolution, plan)
    if plan == "host-simd":
        # striped AVX host scorer inside the same jitted window sweep:
        # a pure_callback per window hands (window, reads) to
        # csrc sw_score_simd_batch1 (OpenMP across reads) and returns
        # the exact (score, read_i, win_j) triple the fold expects —
        # identical carry semantics to the device plans
        from ..runtime_native import score_simd_window

        def _host_cb(win, reads):
            got = score_simd_window(win, reads, scoring, substitution)
            if got is None:                   # gated upfront; belt+braces
                raise RuntimeError("host-simd scorer became ineligible")
            return got

        def prepare_reads(queries):
            return queries

        def score_batch(prepared, win, B):
            shp = jax.ShapeDtypeStruct((B,), jnp.int32)
            return jax.pure_callback(_host_cb, (shp, shp, shp),
                                     win, prepared)
    else:
        _scan_scorer = _window_scorer(scoring, substitution)

        def prepare_reads(queries):
            return queries

        def score_batch(prepared, win, B):
            return _scan_scorer(prepared, win)

    def local(queries, ref_shard, d):
        # ref_shard: (ext,) int8
        B = queries.shape[0]
        prepared = prepare_reads(queries)

        def scan_windows(w, carry):
            bs, bp, be = carry
            off = w * step
            off = jnp.minimum(off, ext - window)
            win = lax.dynamic_slice(ref_shard, (off,), (window,))
            s, qi, wj = score_batch(prepared, win, B)
            pos = d * shard_len + off + wj - 1       # global 0-based end col
            # prefer higher score; tie -> lower global position
            better = (s > bs) | ((s == bs) & (pos < bp) & (s > 0))
            bs = jnp.where(better, s, bs)
            bp = jnp.where(better, pos, bp)
            be = jnp.where(better, qi, be)
            return bs, bp, be

        init = (jnp.zeros((B,), jnp.int32),
                jnp.full((B,), 2**31 - 1, jnp.int32),
                jnp.zeros((B,), jnp.int32))
        bs, bp, be = lax.fori_loop(0, nwin, scan_windows, init)
        bp = jnp.where(bs > 0, bp, -1)
        return bs, bp, be

    def local2(queries, ref_shard, d):
        # top-2-distinct-loci variant: same window sweep, _upd2 carry.
        # Dedup radius is each read's OWN length (not the padded batch
        # qlen): in a mixed-length batch a short read's genuinely
        # distinct nearby loci must not collapse into one candidate.
        B = queries.shape[0]
        prepared = prepare_reads(queries)
        mind = _read_lengths(queries)

        def scan_windows(w, carry):
            off = jnp.minimum(w * step, ext - window)
            win = lax.dynamic_slice(ref_shard, (off,), (window,))
            s, qi, wj = score_batch(prepared, win, B)
            pos = d * shard_len + off + wj - 1
            return _upd2(carry, s, pos, qi, min_dist=mind)

        z = jnp.zeros((B,), jnp.int32)
        sent = jnp.full((B,), 2**31 - 1, jnp.int32)
        return lax.fori_loop(0, nwin, scan_windows,
                             (z, sent, z, z, sent, z))

    def _finish2(c):
        s1, p1, e1, s2, p2, e2 = c
        return SearchHits2(s1, jnp.where(s1 > 0, p1, -1), e1,
                           s2, jnp.where(s2 > 0, p2, -1), e2)

    if mesh is None:
        if n_best == 2:
            def run2(queries, ref_sharded):
                return _finish2(local2(queries, ref_sharded[0], 0))
            return jax.jit(run2)

        def run(queries, ref_sharded):
            return SearchHits(*local(queries, ref_sharded[0], 0))
        return jax.jit(run)

    if n_best == 2:
        D = mesh.shape[axis]

        def sharded2(queries, ref_sharded):
            d = lax.axis_index(axis)
            c = local2(queries, ref_sharded[0], d)
            # one all_gather of the six (B,) carries, then every device
            # folds all D top-2 sets identically (replicated result)
            g = lax.all_gather(jnp.stack(c), axis)      # (D, 6, B)
            z = jnp.zeros_like(c[0])
            sent = jnp.full_like(c[0], 2**31 - 1)
            merged = (z, sent, z, z, sent, z)
            mind = _read_lengths(queries)
            for i in range(D):
                merged = _merge2(merged, tuple(g[i]), min_dist=mind)
            return _finish2(merged)

        fn2 = jax.shard_map(
            sharded2, mesh=mesh,
            in_specs=(P(), P(axis)),
            out_specs=SearchHits2(P(), P(), P(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(fn2)

    def sharded(queries, ref_sharded):
        d = lax.axis_index(axis)
        bs, bp, be = local(queries, ref_sharded[0], d)
        # elementwise merge across devices: max score, then min position
        gbs = lax.pmax(bs, axis)
        cand = jnp.where((bs == gbs) & (gbs > 0), bp, jnp.int32(2**31 - 1))
        gbp = lax.pmin(cand, axis)
        mine = (bs == gbs) & (bp == gbp)
        gbe = lax.pmax(jnp.where(mine, be, 0), axis)
        gbp = jnp.where(gbs > 0, gbp, -1)
        return SearchHits(gbs, gbp, gbe)

    fn = jax.shard_map(
        sharded, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=SearchHits(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_reference(ref: np.ndarray, n_shards: int, qlen: int
                    ) -> tuple[np.ndarray, int]:
    """Split the reference into (D, shard_len + qlen) rows with halo overlap.
    Pads the tail with the -2 sentinel (never matches)."""
    L = len(ref)
    shard_len = -(-L // n_shards)
    ext = shard_len + qlen
    out = np.full((n_shards, ext), -2, np.int8)
    for d in range(n_shards):
        lo = d * shard_len
        hi = min(L, lo + ext)
        if lo < L:
            out[d, : hi - lo] = ref[lo:hi]
    return out, shard_len


def concat_references(seqs: list[np.ndarray], qlen: int,
                      scoring: Scoring = Scoring(), substitution=None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate reference records (chromosomes) into one searchable
    array with never-matching ``-2`` spacers sized so that NO local
    alignment can profitably span two records: spacer cells score the
    NEG_SUB sentinel (substitution) or a mismatch, so the cheapest way
    across a spacer of length L is gaps, costing L x |cheapest per-base
    gap|, while the read can contribute at most max_per_base x qlen
    more; L > max_per_base*qlen/|gap| + 1 makes any spanning alignment
    strictly worse than its best side alone (plus a qlen pad so windows
    land cleanly). ``max_per_base`` is ``scoring.match`` for DNA but the
    TABLE MAX under a substitution matrix (BLOSUM62: 11 for W-W — sizing
    by match=3 would let tryptophan-rich spans pay the crossing).
    Returns (cat, starts) where starts[i] is record i's offset into
    cat. Pass the same ``substitution`` given to ``search``."""
    ge = abs(scoring.gap_extend if scoring.is_affine else scoring.gap)
    per_base = (int(np.max(np.asarray(substitution)))
                if substitution is not None else int(scoring.match))
    spacer = per_base * qlen // max(1, ge) + qlen + 1
    starts = []
    parts = []
    off = 0
    gap = np.full(spacer, -2, np.int8)
    for i, s in enumerate(seqs):
        s = np.asarray(s, np.int8)
        starts.append(off)
        parts.append(s)
        off += len(s)
        if i != len(seqs) - 1:
            parts.append(gap)
            off += spacer
    return np.concatenate(parts), np.asarray(starts, np.int64)


def locate_record(starts: np.ndarray, seqs: list[np.ndarray],
                  global_pos: int) -> tuple[int, int]:
    """(record index, local position) for a `concat_references` global
    position. Raises if the position falls in a spacer or is negative
    (e.g. the -1 no-hit sentinel from SearchHits.ref_pos)."""
    i = int(np.searchsorted(starts, global_pos, side="right")) - 1
    if i < 0:
        raise ValueError(f"position {global_pos} is before the first "
                         "record (no-hit sentinel?)")
    local = global_pos - int(starts[i])
    if local >= len(seqs[i]):
        raise ValueError(f"position {global_pos} falls in the spacer "
                         f"after record {i}")
    return i, local


def pad_queries(queries: list[np.ndarray], qlen: int) -> np.ndarray:
    """Stack variable-length reads into (B, qlen) with the -3 sentinel
    (distinct from the reference pad so padding never matches anything)."""
    B = len(queries)
    out = np.full((B, qlen), -3, np.int8)
    for i, q in enumerate(queries):
        ln = min(len(q), qlen)
        out[i, :ln] = q[:ln]
    return out


class StrandedHits(NamedTuple):
    """Per-read best hit over both DNA strands (see `search(strand=)`).
    ``read_end`` refers to the read in its reported orientation (the
    reverse complement for ``strand == -1``), matching the convention of
    storing minus-strand reads reverse-complemented."""

    scores: jax.Array
    ref_pos: jax.Array
    read_end: jax.Array
    strand: jax.Array     # (B,) int8: +1 forward, -1 reverse, 0 no hit


def revcomp_padded(queries: np.ndarray) -> np.ndarray:
    """Reverse-complement each row of a `pad_queries` batch, keeping the
    ``-3`` padding at the END of every row (a plain reversal would move it
    to the front and shift read coordinates)."""
    q = np.asarray(queries, np.int8)
    B, qlen = q.shape
    lens = (q != -3).sum(axis=1)
    idx = lens[:, None] - 1 - np.arange(qlen)[None, :]
    valid = idx >= 0
    gathered = q[np.arange(B)[:, None], np.clip(idx, 0, qlen - 1)]
    comp = np.where(gathered >= 0, 3 - gathered, gathered)
    return np.where(valid, comp, -3).astype(np.int8)


class HitAlignment(NamedTuple):
    """Full alignment record for one search hit (the reference stops at
    printing the score/position, omp_smithW.c:230-234; producing the
    aligned strings for ranked hits is the end of the database-search
    pipeline its design points at)."""

    read: int            # batch index into queries
    score: int
    ref_start: int       # global 0-based reference col of the first pair
    ref_end: int         # global 0-based reference col of the last pair
    read_start: int      # 0-based offset within the (unpadded) read
    read_end: int
    aligned_read: str    # with '-' gaps
    aligned_ref: str
    cigar: str           # SAM-style M/I/D runs (read as the query)
    strand: str = "+"    # '-' = the read aligned reverse-complemented;
    #                      read coords/strings are in that orientation
    is_secondary: bool = False   # SAM flag 0x100 when rendered
    xs: Optional[int] = None     # suboptimal (second locus) score:
    #                              0 = searched, no competitor (MAPQ 60);
    #                              None = never searched (MAPQ 255)
    rname: Optional[str] = None  # per-record reference name (multi-chrom)
    flag_extra: int = 0          # extra SAM flag bits OR'd in (pairing:
    #                              0x1/0x2/0x8/0x20/0x40/0x80)
    is_unmapped: bool = False    # flag 0x4 record: CIGAR '*', MAPQ 0;
    #                              rname/ref_start = the mapped mate's
    #                              placement when paired, else unplaced
    rnext: Optional[str] = None  # mate reference name ('=' = same) —
    #                              None = unpaired (RNEXT '*', PNEXT 0)
    pnext: int = 0               # mate ref_start, 0-based (like ref_start)
    tlen: int = 0                # signed observed template length


def _strip_queries(queries) -> list[np.ndarray]:
    """(B, qlen) `pad_queries` array (``-3`` pad stripped) or a list of
    unpadded reads -> list of unpadded int8 code arrays."""
    if isinstance(queries, np.ndarray):
        return [q[q != -3] for q in np.asarray(queries, np.int8)]
    return [np.asarray(q, np.int8) for q in queries]


def _cigar(aligned_read: str, aligned_ref: str) -> str:
    runs: list[list] = []
    for cr, cf in zip(aligned_read, aligned_ref):
        op = "D" if cr == "-" else ("I" if cf == "-" else "M")
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return "".join(f"{n}{op}" for op, n in runs)


def align_hits(hits: Union[SearchHits, StrandedHits], queries, reference,
               scoring: Scoring = Scoring(), *, top: Optional[int] = None,
               reads=None, substitution=None, alphabet: Optional[str] = None
               ) -> list[HitAlignment]:
    """Alignment strings for selected hits of a `search`.

    Re-aligns each selected read against a reference window ending at the
    hit's reported end column, growing the window until the full hit score
    is reached (the alignment's reference span is unknown a priori, but
    the window that ends at the hit's end and reaches score parity provably
    contains it). Small windows ride the host tier; larger ones the device
    plans — the same dispatch as any `align()` call.

    The record's score is the RE-ALIGNED score, which can exceed the
    search's: the searcher scores each window fragment independently
    (halo = qlen), so a gapped alignment whose reference span exceeds
    qlen and straddles a window boundary is under-reported there, and the
    un-truncated re-alignment recovers the full-score alignment.

    queries: the (B, qlen) padded int8 array given to `search` (``-3`` pad
    stripped), or a list of unpadded reads. Select hits with ``reads``
    (explicit batch indices) or ``top`` (best-K by score, ties by lower
    reference position); default: every read with a positive score.

    `StrandedHits` (from ``search(strand="both")``) orient each read by
    its winning strand; the record's read coords and strings then refer
    to the reverse complement for ``strand == '-'``.
    """
    from ..engine.align import align as _align
    from ..core.encode import DNA_ALPHABET, PROTEIN_ALPHABET

    if alphabet is None:
        alphabet = DNA_ALPHABET if substitution is None else PROTEIN_ALPHABET
    reference = np.asarray(reference, np.int8)
    scores = np.asarray(hits.scores)
    pos = np.asarray(hits.ref_pos)
    strands = (np.asarray(hits.strand)
               if hasattr(hits, "strand") else None)   # StrandedHits[2]
    qlist = _strip_queries(queries)
    if strands is not None:
        from ..core.encode import revcomp
        qlist = [revcomp(q) if strands[i] < 0 else q
                 for i, q in enumerate(qlist)]
    if reads is None:
        reads = sorted((i for i in range(len(qlist)) if scores[i] > 0),
                       key=lambda i: (-scores[i], pos[i], i))
        if top is not None:
            reads = reads[:top]
    # hit windows are tiny DP problems (a short read x ~2 read lengths
    # of reference) — raise the host-tier cap so they run the native C
    # fill (~1 ms/Mcell, traceback free on host) instead of paying the
    # multi-ms device dispatch floor PER HIT; beyond ~1 Mcells the
    # device plans win again
    from ..core.config import EngineConfig
    cfg = EngineConfig(host_max_cells=1 << 20)
    out: list[HitAlignment] = []
    for i in reads:
        s = int(scores[i])
        if s <= 0:
            continue
        q = qlist[i]
        end = int(pos[i])                  # global 0-based end col
        W = len(q) + 32
        while True:
            start = max(0, end + 1 - W)
            res = _align(reference[start:end + 1], q, scoring, cfg,
                         traceback=True, substitution=substitution,
                         alphabet=alphabet)
            if res.max_score >= s or start == 0:
                break
            W *= 2
        if res.max_score < s:              # pragma: no cover - defensive
            raise ValueError(
                f"read {i}: window [0, {end}] reproduces score "
                f"{res.max_score}, search reported {s} — scoring/"
                "substitution mismatch between search() and align_hits()?")
        # start coords from the consumed-char counts (works on the full-P
        # AND the memory-lean traceback paths, which return no .path)
        ref_used = sum(c != "-" for c in res.aligned_a)
        read_used = sum(c != "-" for c in res.aligned_b)
        out.append(HitAlignment(
            read=i, score=int(res.max_score),
            ref_start=start + res.max_j - ref_used,
            ref_end=start + res.max_j - 1,
            read_start=res.max_i - read_used, read_end=res.max_i - 1,
            aligned_read=res.aligned_b, aligned_ref=res.aligned_a,
            cigar=_cigar(res.aligned_b, res.aligned_a),
            strand="-" if strands is not None and strands[i] < 0 else "+"))
    return out


_searcher_memo: dict = {}    # search()'s builder cache (retrace saver)


@functools.partial(jax.jit, static_argnums=(1,))
def _merge_stranded2(hits: SearchHits2, Bh: int) -> StrandedHits2:
    """Top-2 over both strands: rank the four labeled candidates per read
    (forward/reverse x primary/secondary) by score desc, then
    forward-first (the single-best merge's tie rule), then position asc.
    Same-position hits on opposite strands are distinct alignments and
    may occupy both slots. Stays on device — a host round-trip here
    would cost twelve fetches plus eight re-uploads per search."""
    # candidate columns in PREFERENCE order: forward slot1, forward
    # slot2, reverse slot1, reverse slot2. Within a strand, slot1 already
    # dominates slot2 (higher score, or equal score at lower position),
    # so across the ordered columns only a STRICTLY higher score may
    # displace an earlier candidate — which encodes exactly "score desc,
    # then forward-first, then position asc" with plain int32 compares.
    cols = [(hits.scores[:Bh], hits.ref_pos[:Bh], hits.read_end[:Bh], 1),
            (hits.scores2[:Bh], hits.ref_pos2[:Bh], hits.read_end2[:Bh], 1),
            (hits.scores[Bh:], hits.ref_pos[Bh:], hits.read_end[Bh:], -1),
            (hits.scores2[Bh:], hits.ref_pos2[Bh:], hits.read_end2[Bh:],
             -1)]

    def top(excl_idx):
        zb = jnp.zeros_like(cols[0][0])
        best = (zb - 1, zb - 1, zb, zb.astype(jnp.int8), zb - 1)
        for i, (s, p, e, st) in enumerate(cols):
            s = jnp.where(excl_idx == i, -1, s) if excl_idx is not None \
                else s
            take = s > best[0]
            best = (jnp.where(take, s, best[0]),
                    jnp.where(take, p, best[1]),
                    jnp.where(take, e, best[2]),
                    jnp.where(take, st, best[3]).astype(jnp.int8),
                    jnp.where(take, i, best[4]))
        return best

    s1, p1, e1, st1, i1 = top(None)
    s2, p2, e2, st2, _ = top(i1)
    return StrandedHits2(
        jnp.maximum(s1, 0), jnp.where(s1 > 0, p1, -1), e1,
        jnp.where(s1 > 0, st1, 0).astype(jnp.int8),
        jnp.maximum(s2, 0), jnp.where(s2 > 0, p2, -1), e2,
        jnp.where(s2 > 0, st2, 0).astype(jnp.int8))


class PairSelection(NamedTuple):
    """Per-pair mate placements chosen by `pair_hits`."""

    mate1: StrandedHits      # selected candidate for each first mate
    mate2: StrandedHits      # selected candidate for each second mate
    proper: np.ndarray       # (B,) bool — FR orientation within bounds
    alt_scores1: np.ndarray  # the NOT-chosen candidate's score (XS tag)
    alt_scores2: np.ndarray


def pair_hits(h1: StrandedHits2, h2: StrandedHits2, *,
              min_insert: int = 0, max_insert: int = 1000,
              record_starts=None) -> PairSelection:
    """Select mate placements for paired-end reads from the two ends'
    top-2 both-strand candidates (`search(strand="both", n_best=2)` per
    end): among the 4 candidate combinations per pair, take the
    highest-scoring PROPER one — mates on opposite strands in FR
    orientation (the forward mate upstream of the reverse mate) with an
    estimated template length inside [min_insert, max_insert] — and
    fall back to the two independent best placements (improper pair)
    when no combination qualifies. Template length is estimated from
    the search's end positions (pos − read_end for the forward mate's
    start); the exact TLEN comes from the re-alignment downstream.

    With a `concat_references` reference, pass its ``starts`` as
    ``record_starts``: positions are then global concat coordinates, and
    without the record gate two mates straddling a (short) inter-record
    spacer would satisfy the FR/insert check and be selected as a
    proper cross-chromosome pair."""
    def cands(h):
        return (np.stack([np.asarray(h.scores), np.asarray(h.scores2)]),
                np.stack([np.asarray(h.ref_pos), np.asarray(h.ref_pos2)]),
                np.stack([np.asarray(h.read_end), np.asarray(h.read_end2)]),
                np.stack([np.asarray(h.strand), np.asarray(h.strand2)]))

    s1, p1, e1, st1 = cands(h1)
    s2, p2, e2, st2 = cands(h2)
    B = s1.shape[1]
    if record_starts is not None:
        starts = np.asarray(record_starts)
        rec1 = np.searchsorted(starts, p1, side="right") - 1
        rec2 = np.searchsorted(starts, p2, side="right") - 1
    best = np.full(B, -1, np.int64)
    a_i = np.zeros(B, np.int64)
    b_i = np.zeros(B, np.int64)
    for a in (0, 1):
        for b in (0, 1):
            ok = (s1[a] > 0) & (s2[b] > 0) & (st1[a] * st2[b] == -1)
            if record_starts is not None:
                ok &= rec1[a] == rec2[b]     # proper = same chromosome
            a_fwd = st1[a] == 1
            fwd_start = np.where(a_fwd, p1[a] - e1[a], p2[b] - e2[b])
            rev_end = np.where(a_fwd, p2[b], p1[a])
            ins = rev_end - fwd_start + 1
            ok &= (ins >= max(1, min_insert)) & (ins <= max_insert)
            sc = s1[a] + s2[b]
            take = ok & (sc > best)
            best = np.where(take, sc, best)
            a_i = np.where(take, a, a_i)
            b_i = np.where(take, b, b_i)
    ar = np.arange(B)

    def pick(s, p, e, st, idx):
        return StrandedHits(s[idx, ar], p[idx, ar], e[idx, ar],
                            st[idx, ar])

    return PairSelection(pick(s1, p1, e1, st1, a_i),
                         pick(s2, p2, e2, st2, b_i),
                         best >= 0,
                         s1[1 - a_i, ar], s2[1 - b_i, ar])


def mapq(primary: int, secondary: Optional[int], scale: int = 60) -> int:
    """Heuristic mapping quality from the best/second-best score gap
    (the widely used AS−XS form): 0 when the two loci tie (placement is
    ambiguous), `scale` when no competing locus exists, linear in the
    relative gap between."""
    if primary <= 0:
        return 0
    if secondary is None or secondary <= 0:
        return scale
    return max(0, min(scale, round(scale * (primary - secondary) / primary)))


def to_sam(records: list[HitAlignment], queries, *, ref_name: str = "ref",
           ref_len: Optional[int] = None, read_names=None,
           alphabet: Optional[str] = None, sq=None, quals=None,
           pg: Optional[str] = None, so: str = "unknown") -> str:
    """Render `align_hits` records as minimal SAM (header + one line per
    record): local alignments get soft-clip runs for the unaligned read
    ends, minus-strand records the 0x10 flag with the stored (already
    reverse-complemented) sequence, and the score as the AS:i tag.
    MAPQ is `mapq(score, xs)` when the record carries a second-best
    score, 0 for secondary records, else 255 (unavailable).
    ``quals`` (per-read Phred strings from `runtime_native.seq_quals`,
    None entries allowed) fills the QUAL column, reversed on the minus
    strand to match the reverse-complemented SEQ. `queries` as given to
    `align_hits` (pass ``alphabet=PROTEIN_ALPHABET`` for protein
    records)."""
    from ..core.encode import DNA_ALPHABET, decode

    if alphabet is None:
        alphabet = DNA_ALPHABET
    qlist = _strip_queries(queries)
    lines = [f"@HD\tVN:1.6\tSO:{so}"]
    if sq is not None:                 # multi-reference: (name, len) pairs
        for name, ln in sq:
            lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
    elif ref_len is not None:
        lines.append(f"@SQ\tSN:{ref_name}\tLN:{ref_len}")
    if pg is not None:                 # command line for provenance
        from .. import __version__
        lines.append(f"@PG\tID:swtpu\tPN:swtpu\tVN:{__version__}"
                     f"\tCL:{pg}")
    for r in records:
        q = qlist[r.read]
        name = (read_names[r.read] if read_names is not None
                else f"read{r.read}")
        if r.is_unmapped:
            # flag-4 record: CIGAR/MAPQ '*'/0, SEQ as read; placed at
            # the mapped mate's coordinate when the caller set one (the
            # SAM convention that keeps pairs together under sorting)
            qual = quals[r.read] if quals is not None else None
            placed = r.ref_start >= 0
            fields = [
                name, str(4 | r.flag_extra),
                (r.rname or ref_name) if placed else "*",
                str(r.ref_start + 1) if placed else "0",
                "0", "*",
                r.rnext or "*",
                str(r.pnext + 1) if r.rnext else "0",
                "0", decode(q, alphabet) or "*",    # empty read: '*' SEQ
                qual or "*"]
            lines.append("\t".join(fields))
            continue
        if r.strand == "-":
            from ..core.encode import revcomp
            q = revcomp(q)
        flag = (16 if r.strand == "-" else 0) \
            | (256 if r.is_secondary else 0) | r.flag_extra
        head = f"{r.read_start}S" if r.read_start else ""
        tail_n = len(q) - 1 - r.read_end
        tail = f"{tail_n}S" if tail_n else ""
        if r.is_secondary:
            mq = "0"
        elif r.xs is not None:
            mq = str(mapq(r.score, r.xs))
        else:
            mq = "255"
        qual = quals[r.read] if quals is not None else None
        if qual is not None and r.strand == "-":
            qual = qual[::-1]
        fields = [
            name, str(flag), r.rname or ref_name, str(r.ref_start + 1),
            mq,
            head + r.cigar + tail,
            r.rnext or "*",
            str(r.pnext + 1) if r.rnext else "0",
            str(r.tlen),
            decode(q, alphabet), qual or "*", f"AS:i:{r.score}"]
        if r.xs:                       # xs == 0 means "no competitor":
            fields.append(f"XS:i:{r.xs}")  # it feeds MAPQ, not a tag
        lines.append("\t".join(fields))
    return "\n".join(lines) + "\n"


def search(queries, reference, mesh: Optional[Mesh] = None,
           window: int = 32768, scoring: Scoring = Scoring(),
           axis: str = "data", substitution=None,
           strand: str = "forward", n_best: int = 1,
           sec_resolution: int = 2048, plan: str = "auto"
           ) -> Union[SearchHits, StrandedHits, SearchHits2]:
    """Convenience one-shot search (builds shards + searcher).

    ``n_best=2`` returns SearchHits2 — the best two hits per read at
    distinct end positions; combined with ``strand="both"`` it returns
    StrandedHits2, the top two over all four strand/locus candidates.
    ``sec_resolution`` is the secondary-locus window clamp under
    n_best=2 (see `make_searcher`): larger = faster sweep but nearer
    same-window loci collapse to the better one.

    ``strand="both"`` (DNA only) also searches every read's reverse
    complement in the same device sweep — the doubled batch rides the
    same batched kernel — and returns `StrandedHits` with the winning
    strand per read (higher score wins; ties prefer forward).

    Each window is scored on its own (see `window_spans`): a gapped hit
    whose reference span exceeds the read length and crosses a window edge
    is reported with the best score of its parts, and which hits are cut
    depends on the shard count; `align_hits` re-aligns hits without
    windows.

    Searchers are memoized on (shapes, scoring, mesh, resolved plan), so
    repeated same-shape calls skip the retrace; for full control build one
    with `make_searcher` and reuse it (see examples/read_mapping.py)."""
    queries = np.asarray(queries, np.int8)
    if strand not in ("forward", "both"):
        raise ValueError(f"strand must be 'forward' or 'both', got {strand!r}")
    if strand == "both":
        if substitution is not None:
            raise ValueError("strand='both' is DNA-only (reverse "
                             "complement is undefined for protein codes)")
        queries = np.concatenate([queries, revcomp_padded(queries)])
    B, qlen = queries.shape
    D = mesh.shape[axis] if mesh is not None else 1
    shards, shard_len = shard_reference(np.asarray(reference, np.int8),
                                        D, qlen)
    window = min(window, shards.shape[1])
    sub_key = (None if substitution is None
               else np.asarray(substitution).tobytes())
    try:
        mesh_key = hash(mesh)
    except TypeError:                  # pragma: no cover - unhashable mesh
        mesh_key = id(mesh)
    # resolve the plan NOW so a jax_default_device flip never serves a
    # searcher compiled for the other backend
    plan = _searcher_plan(mesh, qlen, window, scoring, plan, substitution)
    key = (qlen, shard_len, window, scoring, axis, sub_key, mesh_key,
           n_best, sec_resolution, plan)
    fn = _searcher_memo.get(key)
    if fn is not None:
        _searcher_memo[key] = _searcher_memo.pop(key)   # LRU touch
    else:
        fn = make_searcher(mesh, qlen, shard_len, window, scoring, axis,
                           plan=plan, substitution=substitution,
                           n_best=n_best, sec_resolution=sec_resolution)
        if len(_searcher_memo) >= 16:
            _searcher_memo.pop(next(iter(_searcher_memo)))
        _searcher_memo[key] = fn
    # host arrays go straight to the shardings the searcher compiled for
    # (no staging copy of the whole reference on the first device)
    hits = fn(queries, shards)
    if strand == "forward":
        return hits
    if n_best == 2:
        return _merge_stranded2(hits, B // 2)
    # strand merge stays on device (jnp.where) — a host round-trip here
    # would cost six fetches plus four re-uploads per search
    Bh = B // 2
    fs, rs = hits.scores[:Bh], hits.scores[Bh:]
    rev = rs > fs                                 # ties prefer forward
    sc = jnp.where(rev, rs, fs)
    return StrandedHits(
        scores=sc,
        ref_pos=jnp.where(rev, hits.ref_pos[Bh:], hits.ref_pos[:Bh]),
        read_end=jnp.where(rev, hits.read_end[Bh:], hits.read_end[:Bh]),
        strand=jnp.where(sc > 0, jnp.where(rev, -1, 1), 0
                         ).astype(jnp.int8))
