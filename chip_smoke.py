#!/usr/bin/env python
"""On-card smoke test of swtpu's main path, through its public entry points.

    python chip_smoke.py               # one GPU: every single-card phase
    python chip_smoke.py --four-cards  # four GPUs: the multi-device phase only

One card: builds the wavefront kernel, compiles it at 25632^2 in the three
scorings (linear DNA, affine, BLOSUM62 + affine -11/-1), checks it against
the oracle on a few hundred random shapes up to 2048^2 and against the XLA
scan at 25632^2, runs ``python -m swtpu``'s golden example, times the fill
through ``align`` on the kernel and on the scan, aligns 25632^2 with
traceback, scores a 64 x 1056^2 batch and searches 2048 x 152 reads against
a 1 Mb reference. Four cards: the pipeline over a 4-device mesh and the
sharded search and batch scorers, each compared with one card.

The DP is int32 throughout, so every comparison is exact integer equality
(no float tolerance or summation order applies). The script needs a GPU:
with only the CPU, or outside a checkout of the repository, it exits
non-zero and prints no result. It runs in one process. Every number is
printed beside the card's name and power limit. A failing phase makes the
exit code non-zero; on success the last line is the JSON device record.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N = 25632            # the reference's largest standard sweep size
CARD = "?"           # nvidia-smi "name, power.limit", set in main()


def say(msg: str) -> None:
    print(msg, flush=True)


def num(msg: str) -> None:
    """A line that carries a measured number: tagged with the card."""
    say(f"{msg}  [{CARD}]")


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args, **kw):
        say(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn(*args, **kw)
        except Exception:
            self.failed.append(name)
            say(f"FAIL {name}:\n{traceback.format_exc()}")
            return
        num(f"ok {name} ({time.perf_counter() - t0:.1f} s)")


def scorings():
    from swtpu import Scoring
    from swtpu.core.substitution import BLOSUM62
    return {
        "linear": (Scoring(), None, 4),
        "affine": (Scoring(mode="affine", gap_open=-4, gap_extend=-1),
                   None, 4),
        "blosum62+affine": (Scoring(mode="affine", gap_open=-11,
                                    gap_extend=-1), BLOSUM62, 20),
    }


def _pair(rng, m, n, alpha):
    return (rng.integers(0, alpha, m).astype(np.int8),
            rng.integers(0, alpha, n).astype(np.int8))


def _expect(a, b, sc, sub):
    """(max_score, max_i, max_j, last_cell) from core/oracle.py."""
    from swtpu.core import oracle
    o = oracle.fill(a, b, sc, sub)
    i, j = o.max_ij
    return (o.max_score, i, j, int(o.H[len(b), len(a)]))


def _kernel(a, b, sc, sub):
    import jax.numpy as jnp
    from swtpu.kernels import gpu_fill
    fn = gpu_fill.score_fn(len(a), len(b), sc, sub)
    return tuple(int(x) for x in fn(jnp.asarray(a), jnp.asarray(b)))


def _scan(a, b, sc, sub):
    import jax.numpy as jnp
    from swtpu.core.substitution import embed_sentinels
    from swtpu.kernels.scan_fill import scan_fill
    table = None if sub is None else jnp.asarray(embed_sentinels(sub))
    out = scan_fill(jnp.asarray(a), jnp.asarray(b), scoring=sc,
                    sub_table=table)
    return (int(out.max_score), int(out.max_i), int(out.max_j),
            int(out.last_cell))


# --------------------------------------------------------------- one card


def phase_build():
    from swtpu.dispatch.plan import capability
    from swtpu.kernels import gpu_fill
    t0 = time.perf_counter()
    gpu_fill.ensure_registered()
    took = time.perf_counter() - t0
    built = gpu_fill.build_seconds()
    num(f"kernel library {gpu_fill.library_path().name}: "
        + (f"built in {built:.1f} s" if built is not None
           else "found built") + f", loaded+registered in {took:.1f} s")
    cap = capability()
    say(f"capability: {cap}")
    if not cap.gpu_kernel:
        raise RuntimeError("capability() reports no GPU kernel on this card")


def phase_compile(n=N):
    import jax
    from swtpu.kernels import gpu_fill
    a = jax.ShapeDtypeStruct((n,), np.int8)
    for name, (sc, sub, _) in scorings().items():
        fn = gpu_fill.score_fn(n, n, sc, sub)
        t0 = time.perf_counter()
        compiled = fn.lower(a, a).compile()
        dt = time.perf_counter() - t0
        ma = compiled.memory_analysis()
        g = gpu_fill.geometry(n, n)
        num(f"compile {name} {n}^2: {dt:.2f} s; R={g.R} stripes="
            f"{g.stripes}; memory_analysis: args "
            f"{ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")


def phase_oracle(cases=240, max_side=2048, seed=0):
    """Kernel == oracle on random shapes (linear up to max_side^2; affine
    and BLOSUM62 up to 400^2, the loop oracle's practical size), forced
    ties, and the builtin example."""
    from swtpu import BUILTIN_A, BUILTIN_B, Scoring
    from swtpu.core.encode import encode
    rng = np.random.default_rng(seed)
    sc_all = scorings()
    bad, done = [], 0

    def check(a, b, name, sc, sub):
        nonlocal done
        got, want = _kernel(a, b, sc, sub), _expect(a, b, sc, sub)
        done += 1
        if got != want:
            bad.append((name, len(a), len(b), got, want))

    for k in range(cases):
        name = ("linear", "affine", "blosum62+affine")[k % 3]
        sc, sub, alpha = sc_all[name]
        side = max_side if name == "linear" else 400
        # log-uniform sides: many small and ragged shapes, some large
        m, n = (int(np.exp(rng.uniform(0, np.log(side)))) for _ in "mn")
        check(*_pair(rng, m, n, alpha), name, sc, sub)
    for m, n in ((64, 64), (100, 37), (70, 300)):      # forced ties
        for name in ("linear", "affine"):
            sc, sub, _ = sc_all[name]
            check(np.zeros(m, np.int8), np.zeros(n, np.int8), name, sc, sub)
            check(np.tile(np.int8([0, 1]), m // 2),
                  np.tile(np.int8([0, 1]), n // 2), name, sc, sub)
    got = _kernel(encode(BUILTIN_A), encode(BUILTIN_B), Scoring(), None)
    pos = got[1] * (len(BUILTIN_A) + 1) + got[2]
    say(f"builtin via kernel: score {got[0]} pos {pos} last {got[3]}")
    if (got[0], pos, got[3]) != (13, 69, 7):
        bad.append(("builtin", got))
    say(f"kernel vs oracle: {done - len(bad)}/{done} exact")
    if bad:
        raise AssertionError(f"kernel != oracle: {bad[:5]}")


def phase_vs_scan(n=N, seed=1):
    rng = np.random.default_rng(seed)
    for name, (sc, sub, alpha) in scorings().items():
        a, b = _pair(rng, n, n, alpha)
        k, s = _kernel(a, b, sc, sub), _scan(a, b, sc, sub)
        say(f"{name} {n}^2: kernel {k} scan {s} (max, i, j, last)")
        if k != s:
            raise AssertionError(f"{name}: kernel {k} != scan {s}")


def phase_cli():
    from swtpu.__main__ import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli([])
    out = buf.getvalue()
    say(out.strip())
    if rc != 0 or "Verifying correctness using builtin data = 1" not in out \
            or "Max score 13" not in out or "index 69]" not in out:
        raise AssertionError(f"python -m swtpu golden failed (rc {rc})")


def _align_time(a, b, sc, sub, plan, reps):
    from swtpu import align
    r = align(a, b, sc, traceback=False, plan=plan, substitution=sub)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r = align(a, b, sc, traceback=False, plan=plan, substitution=sub)
        best = min(best, time.perf_counter() - t0)
    return best, r


def phase_gcups(n=N, seed=2):
    """Warm fill rate through align(traceback=False), dispatch's choice."""
    rng = np.random.default_rng(seed)
    for name in ("linear", "blosum62+affine"):
        sc, sub, alpha = scorings()[name]
        a, b = _pair(rng, n, n, alpha)
        dt, r = _align_time(a, b, sc, sub, None, 5)
        num(f"align(traceback=False) {name} {n}^2: plan {r.plan}, "
            f"{dt * 1e3:.3f} ms, {n * n / dt / 1e9:.2f} GCUPS")
        if r.plan != "wavefront":
            raise AssertionError(f"dispatch ran {r.plan!r}, not the kernel")


def phase_kernel_vs_xla(sizes=(8192, N), seed=3):
    """The keep-or-remove measurement: the kernel against what XLA makes
    of scan_fill, both warm through align(traceback=False)."""
    rng = np.random.default_rng(seed)
    for n in sizes:
        for name in ("linear", "blosum62+affine"):
            sc, sub, alpha = scorings()[name]
            a, b = _pair(rng, n, n, alpha)
            tk, rk = _align_time(a, b, sc, sub, "wavefront", 5)
            ts, rs = _align_time(a, b, sc, sub, "scan", 2)
            num(f"{name} {n}^2: wavefront {tk * 1e3:.3f} ms "
                f"({n * n / tk / 1e9:.2f} GCUPS) vs scan {ts * 1e3:.1f} ms "
                f"({n * n / ts / 1e9:.3f} GCUPS): {ts / tk:.1f}x")
            if (rk.max_score, rk.max_i, rk.max_j, rk.last_cell) != \
                    (rs.max_score, rs.max_i, rs.max_j, rs.last_cell):
                raise AssertionError(f"{name} {n}^2: plans disagree")


def _rescore(ra, rb, sc, alphabet="ACGT"):
    s = 0
    for x, y in zip(ra, rb):
        if x == "-" or y == "-":
            s += sc.gap
        else:
            s += sc.match if x == y else sc.mismatch
    return s


def phase_traceback(n=N, seed=4):
    from swtpu import Scoring, align
    from swtpu.core.encode import random_pair
    a, b = random_pair(n, n, seed=seed)
    t0 = time.perf_counter()
    r = align(a, b, traceback=True)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = align(a, b, traceback=True)
    warm = time.perf_counter() - t0
    s = _rescore(r.aligned_a, r.aligned_b, Scoring())
    num(f"align(traceback=True) {n}^2: route {r.plan}, cold {cold:.2f} s, "
        f"warm {warm:.2f} s; score {r.max_score}, alignment columns "
        f"{len(r.aligned_a)} re-score to {s}")
    if s != r.max_score:
        raise AssertionError(f"alignment re-scores to {s} != {r.max_score}")


def phase_batch(B=64, side=1056, seed=5):
    import jax
    from swtpu import batch_score, score
    from swtpu.core.encode import random_batch
    a, b = random_batch(B, side, side, seed=seed)
    hits = jax.block_until_ready(batch_score(a, b))
    t0 = time.perf_counter()
    hits = jax.block_until_ready(batch_score(a, b))
    dt = time.perf_counter() - t0
    num(f"batch_score {B}x{side}^2: {dt * 1e3:.1f} ms "
        f"({B * side * side / dt / 1e9:.2f} GCUPS effective)")
    for k in (0, B // 2, B - 1):
        want = score(a[k], b[k])
        if int(hits.scores[k]) != want:
            raise AssertionError(
                f"pair {k}: batch {int(hits.scores[k])} != score {want}")
    say("batch_score == score() on pairs 0, B/2, B-1")


def _reads(rng, ref, B, qlen):
    q = rng.integers(0, 4, (B, qlen)).astype(np.int8)
    planted = {}
    for i in range(0, B, 4):                 # plant a quarter of the reads
        p = int(rng.integers(0, len(ref) - qlen))
        q[i] = ref[p: p + qlen]
        planted[i] = p + qlen - 1
    return q, planted


def phase_search(B=2048, qlen=152, L=1_000_000, top=512, seed=6):
    import jax
    from swtpu import align_hits, search
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.int8)
    q, planted = _reads(rng, ref, B, qlen)
    t0 = time.perf_counter()
    hits = jax.block_until_ready(search(q, ref))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = jax.block_until_ready(search(q, ref))
    warm = time.perf_counter() - t0
    num(f"search {B}x{qlen} vs {L} bases: cold {cold:.2f} s, warm "
        f"{warm:.2f} s ({B * qlen * L / warm / 1e9:.2f} GCUPS effective)")
    scores, pos = np.asarray(hits.scores), np.asarray(hits.ref_pos)
    miss = [i for i, p in planted.items()
            if scores[i] != 3 * qlen or pos[i] != p]
    if miss:
        raise AssertionError(f"{len(miss)} planted reads not found exactly")
    t0 = time.perf_counter()
    recs = align_hits(hits, q, ref, top=top)
    dt = time.perf_counter() - t0
    num(f"align_hits(top={top}): {len(recs)} records in {dt:.2f} s")
    if len(recs) != top or any(r.score < scores[r.read] for r in recs):
        raise AssertionError("align_hits records disagree with the search")


# ------------------------------------------------------------- four cards


def _placement(label, arr):
    """Where the library put an array it returned: one line per shard."""
    shards = sorted((str(s.device), str(s.index)) for s in
                    arr.addressable_shards)
    say(f"{label}: {len(shards)} shard(s): "
        + ", ".join(f"{d}{i}" for d, i in shards))
    return {d for d, _ in shards}


def _card_peaks(label, devs):
    """Peak device memory per card (None where the backend keeps no
    statistics): a card the library never used stays near zero."""
    peaks = []
    for d in devs:
        st = d.memory_stats() or {}
        peaks.append(st.get("peak_bytes_in_use"))
    say(f"{label}: peak bytes in use per card "
        f"{dict(zip((str(d) for d in devs), peaks))}")
    if all(p is not None for p in peaks) and min(peaks) == 0:
        raise AssertionError(f"{label}: a card held no memory: {peaks}")


def _explain_differences(q, ref, h4, h1, D, **kw):
    """Every read whose primary score differs between the D-shard and the
    one-shard search must be a window-edge cut (dist.database.window_spans):
    the higher side equals the read's exact score against the whole
    reference, and no window of the lower side holds an optimal
    alignment. Any other difference raises. Returns one row per optimal
    alignment found (read, exact, D-shard score, one-shard score, strand,
    reference span)."""
    from swtpu import align, align_hits
    from swtpu.core.encode import revcomp
    from swtpu.dist.database import SearchHits, window_spans
    L, qlen = len(ref), q.shape[1]
    spans = {D: window_spans(L, qlen, D, **kw), 1: window_spans(L, qlen, 1,
                                                                 **kw)}

    def held(side, lo, hi):
        starts, w = spans[side]
        return bool(((starts <= lo) & (starts + w > hi)).any())

    s4, s1 = np.asarray(h4.scores), np.asarray(h1.scores)
    rows = []
    for i in np.flatnonzero(s4 != s1):
        best = {}
        for o, read in ((1, q[i]), (-1, revcomp(q[i]))):
            r = align(ref, read, traceback=False)      # whole reference
            best[o] = (r.max_score, r.max_j - 1, read)
        exact = max(v[0] for v in best.values())
        got = {D: int(s4[i]), 1: int(s1[i])}
        if max(got.values()) != exact:
            raise AssertionError(f"read {i}: searches {got}, exact {exact}")
        for o, (sc, end, read) in best.items():
            if sc != exact:
                continue
            hit = SearchHits(np.array([sc]), np.array([end]),
                             np.array([qlen]))
            rec = align_hits(hit, [read], ref)[0]
            lo, hi = rec.ref_start, rec.ref_end
            for side, v in got.items():
                # a window holding an optimal alignment scores it in full
                if v < exact and held(side, lo, hi):
                    raise AssertionError(
                        f"read {i} strand {o}: the {side}-shard search "
                        f"scored {v} < exact {exact} although one of its "
                        f"windows holds the alignment [{lo}, {hi}]")
            rows.append((int(i), exact, got[D], got[1], o, lo, hi,
                         hi - lo + 1))
    return rows


def phase_four_cards(m=65536, n=16384, B=2048, qlen=152, L=1_000_000,
                     pairs=64, side=1056, seed=7):
    """The multi-device paths users run across cards, each through its
    public entry point with host arrays and compared with one card: the
    pipeline (align with a mesh), the sharded search, and the sharded
    batch scorer + best-hit reducer. Placement is read from the arrays
    the library returns and from each card's memory statistics."""
    import jax
    from jax.sharding import Mesh
    from swtpu import align, search
    from swtpu.core.encode import random_batch, random_pair
    from swtpu.dispatch.plan import pipeline_block_rows
    from swtpu.dist.batch import (batch_score, make_best_hit_reducer,
                                  make_sharded_batch_scorer)
    from swtpu.dist.pipeline import pipeline_align

    devs = jax.devices()
    D = 4
    if len(devs) < D:
        raise RuntimeError(f"--four-cards needs {D} devices, JAX has {devs}")
    devs = devs[:D]
    say(f"devices: {devs}")

    # the pipeline: align(a, b, mesh=...) vs the single-card dispatch
    mesh = Mesh(np.array(devs), ("seq",))
    a, b = random_pair(m, n, seed=seed)
    r4 = align(a, b, traceback=False, mesh=mesh)        # compile
    t0 = time.perf_counter()
    r4 = align(a, b, traceback=False, mesh=mesh)
    dt = time.perf_counter() - t0
    br = pipeline_block_rows(m, n, D)
    res = pipeline_align(a, b, mesh, block_rows=br)
    where = _placement("pipeline_align result (max_score)", res.max_score)
    _card_peaks("after the pipeline", devs)
    r1 = align(a, b, traceback=False)
    got = (r4.max_score, r4.max_i, r4.max_j, r4.last_cell)
    one = (r1.max_score, r1.max_i, r1.max_j, r1.last_cell)
    num(f"align(mesh=4 cards) {n}x{m}: plan {r4.plan} (block_rows {br}), "
        f"{dt:.2f} s warm; result {got}; one card plan {r1.plan} {one}")
    if r4.plan != "pipeline" or len(where) != D:
        raise AssertionError(f"pipeline ran as {r4.plan} on {where}")
    if got != one or tuple(int(x) for x in res) != one:
        raise AssertionError(f"pipeline {got} != single card {one}")

    # sharded search, both strands, top-2 loci, on two data seeds
    dmesh = Mesh(np.array(devs), ("data",))
    kw = dict(strand="both", n_best=2)
    for k, s in enumerate((seed, seed + 100)):
        rng = np.random.default_rng(s)
        ref = rng.integers(0, 4, L).astype(np.int8)
        q, planted = _reads(rng, ref, B, qlen)
        if k == 0:
            jax.block_until_ready(search(q, ref, mesh=dmesh, **kw))
        t0 = time.perf_counter()
        h4 = jax.block_until_ready(search(q, ref, mesh=dmesh, **kw))
        t4 = time.perf_counter() - t0
        if k == 0:
            where = _placement("search scores", h4.scores)
            _card_peaks("after the sharded search", devs)
            if len(where) != D:
                raise AssertionError(f"search result only on {where}")
            jax.block_until_ready(search(q, ref, **kw))
        t0 = time.perf_counter()
        h1 = jax.block_until_ready(search(q, ref, **kw))
        t1 = time.perf_counter() - t0
        num(f"search seed {s}: {B}x{qlen} vs {L}, strand=both n_best=2: "
            f"{D} cards {t4:.2f} s, one card {t1:.2f} s")
        f4 = {f: np.asarray(getattr(h4, f)) for f in h1._fields}
        f1 = {f: np.asarray(getattr(h1, f)) for f in h1._fields}
        idx = np.array(sorted(planted))
        for f in h1._fields[:4]:
            if not np.array_equal(f4[f][idx], f1[f][idx]):
                raise AssertionError(f"planted reads: sharded {f} != one card")
        differ = {f: int((f4[f] != f1[f]).sum()) for f in h1._fields}
        say(f"reads differing per field (of {B}; the {len(idx)} planted "
            f"equal on every primary field): {differ}")
        rows = _explain_differences(q, ref, h4, h1, D, n_best=2)
        for row in rows:
            say("  read {} exact {} | {} cards {} | one card {} | strand "
                "{:+d} span [{}, {}] = {} columns".format(row[0], row[1], D,
                                                          *row[2:]))
        say(f"seed {s}: all {differ['scores']} primary-score differences "
            "are window-edge cuts: the higher side equals the exact "
            "whole-reference score, the lower side's windows split the "
            "optimal alignment")

    # sharded batch scorer + best-hit reducer, fed host arrays
    aa, bb = random_batch(pairs, side, side, seed=seed)
    scorer = make_sharded_batch_scorer(dmesh)
    hits = jax.block_until_ready(scorer(aa, bb))
    where = _placement("sharded batch scores", hits.scores)
    if len(where) != D:
        raise AssertionError(f"batch scores only on {where}")
    best = jax.block_until_ready(make_best_hit_reducer(dmesh)(aa, bb))
    ref_hits = batch_score(aa, bb, plan="scan")
    for name in ("scores", "max_i", "max_j"):
        if not np.array_equal(np.asarray(getattr(hits, name)),
                              np.asarray(getattr(ref_hits, name))):
            raise AssertionError(f"sharded batch {name} != one card")
    s1 = np.asarray(ref_hits.scores)
    k = int(np.argmax(s1))
    want = (int(s1[k]), k, int(ref_hits.max_i[k]), int(ref_hits.max_j[k]))
    got = tuple(int(x) for x in best)
    num(f"sharded batch {pairs}x{side}^2 == one card; best hit {got}")
    if got != want:
        raise AssertionError(f"best hit {got} != {want}")
    _card_peaks("after the sharded batch", devs)


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args(argv)
    if not (HERE / "swtpu" / "__init__.py").is_file():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no swtpu package beside {HERE})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import jax
    from swtpu.core.runtime import enable_compile_cache
    from swtpu.instrument.device import nvidia_smi_identity

    cache = enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform == "cpu":
        print(f"no accelerator: JAX found only {devs}", file=sys.stderr)
        return 2
    smi = nvidia_smi_identity()
    CARD = smi.splitlines()[0]
    say(f"jax {jax.__version__}: platform {devs[0].platform}, kind "
        f"{devs[0].device_kind}, count {len(devs)}; compile cache {cache}")
    say(smi)

    ph = Phases()
    if args.four_cards:
        ph.run("four cards: pipeline, sharded search, sharded batch",
               phase_four_cards)
    else:
        ph.run("build", phase_build)
        ph.run("compile at 25632^2", phase_compile)
        ph.run("kernel vs oracle", phase_oracle)
        ph.run("kernel vs scan at 25632^2", phase_vs_scan)
        ph.run("python -m swtpu golden", phase_cli)
        ph.run("fill rate through align", phase_gcups)
        ph.run("kernel vs XLA scan timings", phase_kernel_vs_xla)
        ph.run("align with traceback at 25632^2", phase_traceback)
        ph.run("batch_score 64 x 1056^2", phase_batch)
        ph.run("search 2048 x 152 vs 1 Mb + align_hits", phase_search)
    if ph.failed:
        say(f"FAILED phases: {ph.failed}")
        return 1
    say(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
