"""C++ host runtime tests: encoder, glibc-rand parity, traceback walker
parity vs oracle, FASTA/FASTQ parsing."""

import numpy as np
import pytest

from swtpu import runtime_native as rn
from swtpu.core import oracle
from swtpu.core.encode import GlibcRand, encode, random_pair

pytestmark = pytest.mark.skipif(not rn.available(),
                                reason="native runtime not built")


def test_encode_matches_python():
    s = "ACGTacgtTTGGCCAA"
    np.testing.assert_array_equal(rn.encode(s), encode(s.upper()))


def test_encode_invalid():
    with pytest.raises(ValueError, match="position 3"):
        rn.encode("ACGXACGT")


def test_glibc_rand_parity():
    py = GlibcRand(1).reference_sequence(64)
    cc = rn.reference_random(64, seed=1)
    np.testing.assert_array_equal(py, cc)


def test_traceback_matches_oracle():
    a, b = random_pair(50, 40, seed=3)
    ref = oracle.fill(a, b)
    assert rn.traceback(ref.P, ref.max_pos) == oracle.backtrack(ref.P, ref.max_pos)
    sa, sb = rn.alignment_strings(a, b, ref.P, ref.max_pos)
    pa, pb = oracle.alignment_strings(a, b, ref.P, ref.max_pos)
    assert (sa, sb) == (pa, pb)


def test_fasta_roundtrip(tmp_path):
    p = tmp_path / "seqs.fa"
    p.write_text(">s1 header\nACGT\nACGT\n>s2\nTTTT\n>empty\n>s3\nGG\n")
    seqs = rn.read_seqfile(str(p))
    assert len(seqs) == 4
    np.testing.assert_array_equal(seqs[0], encode("ACGTACGT"))
    np.testing.assert_array_equal(seqs[1], encode("TTTT"))
    assert len(seqs[2]) == 0
    np.testing.assert_array_equal(seqs[3], encode("GG"))


def test_fastq(tmp_path):
    p = tmp_path / "reads.fq"
    p.write_text("@r1\nACGT\n+\n!!!!\n@r2\nGGCC\n+\n####\n")
    seqs = rn.read_seqfile(str(p))
    assert len(seqs) == 2
    np.testing.assert_array_equal(seqs[0], encode("ACGT"))
    np.testing.assert_array_equal(seqs[1], encode("GGCC"))


def test_missing_file():
    with pytest.raises(FileNotFoundError):
        rn.read_seqfile("/nonexistent/path.fa")


def test_native_fill_fuzz_vs_oracle():
    """sw_fill is bit-equal to the oracle (H, P incl. Gotoh state bits,
    first-occurrence maxpos) across linear/affine/alt-scoring/substitution
    — it is the dispatchable v0 serial tier (serial_smithW.c:141-244)."""
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62

    if not rn.available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(0)
    modes = [(Scoring(), None),
             (Scoring(match=5, mismatch=-3, gap=-4), None),
             (Scoring(mode="affine", gap_open=-11, gap_extend=-1), None),
             (Scoring(mode="affine", gap_open=-11, gap_extend=-1), BLOSUM62),
             (Scoring(gap=-4), BLOSUM62)]
    for trial in range(20):
        sc, sub = modes[trial % len(modes)]
        m, n = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        A = 20 if sub is not None else 4
        a = rng.integers(0, A, m).astype(np.int8)
        b = rng.integers(0, A, n).astype(np.int8)
        got = rn.fill(a, b, sc, sub)
        ref = oracle.fill_loop(a, b, sc, sub)
        assert np.array_equal(got.H, ref.H), trial
        assert np.array_equal(got.P, ref.P), trial
        assert (got.max_pos, got.max_score) == (ref.max_pos,
                                                ref.max_score), trial


def test_host_plan_golden_and_traceback():
    """align(plan='host') reproduces the golden 13/69/7 with the exact
    alignment string — and dispatches there for tiny problems when the
    native lib is available."""
    import swtpu
    from swtpu.core.config import EngineConfig

    r = swtpu.align(swtpu.BUILTIN_A, swtpu.BUILTIN_B, plan="host",
                    traceback=True)
    assert (r.max_score, r.max_pos, r.last_cell) == (13, 69, 7)
    assert (r.aligned_a, r.aligned_b) == ("GTT-AC", "GTTGAC")
    rm = swtpu.align(swtpu.BUILTIN_A, swtpu.BUILTIN_B, plan="host",
                     return_matrices=True)
    assert rm.H is not None and rm.P is not None
    assert int(rm.H[-1, -1]) == 7


def test_host_plan_banded_falls_back():
    """band is not supported by the host fill: dispatch must never route
    banded problems there, and an explicit plan='host' degrades safely."""
    import swtpu
    from swtpu.core.config import EngineConfig
    from swtpu.dispatch import plan as planmod

    cfg = EngineConfig(band=2)
    ep = planmod.choose_exec(32, 32, cfg)
    assert ep.plan != "host"
    a, b = random_pair(32, 32, seed=3)
    got = swtpu.align(a, b, config=cfg, plan="host")
    want = swtpu.align(a, b, config=cfg, plan="scan")
    assert got.max_score == want.max_score
    assert (got.max_i, got.max_j) == (want.max_i, want.max_j)


def test_host_plan_substitution_guard():
    """Out-of-range codes with a substitution table fall back to the
    device plan instead of indexing garbage."""
    import swtpu
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62

    sc = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    a = np.array([0, 5, 19, 25], np.int8)     # 25 out of range
    b = np.array([0, 5, 19, 7], np.int8)
    got = swtpu.align(a, b, sc, plan="host", substitution=BLOSUM62,
                      alphabet="ACDEFGHIKLMNPQRSTVWY")
    want = swtpu.align(a, b, sc, plan="scan", substitution=BLOSUM62,
                       alphabet="ACDEFGHIKLMNPQRSTVWY")
    assert got.max_score == want.max_score


def test_simd_score_fuzz_vs_oracle():
    """Striped AVX2 score tier (sw_score_simd): exact max-score parity vs
    the oracle across linear / affine / BLOSUM62 / big-table scorings,
    gap-heavy parameters (the lazy-F loop's stress case), and odd shapes
    including thin strips and n around the 16-lane stripe boundaries."""
    from swtpu.core import oracle
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62
    from swtpu.runtime_native import available, score_simd

    if not available():
        import pytest
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    scorings = [
        (Scoring(), None),
        (Scoring(match=5, mismatch=-3, gap=-4), None),
        (Scoring(mode="affine", gap_open=-4, gap_extend=-1), None),
        (Scoring(mode="affine", gap_open=-11, gap_extend=-1), BLOSUM62),
        # gap-extend-cheap: long vertical gaps stress lazy-F convergence
        (Scoring(match=2, mismatch=-1, mode="affine",
                 gap_open=-3, gap_extend=-1), None),
    ]
    shapes = [(1, 1), (1, 40), (40, 1), (15, 16), (16, 17), (33, 31),
              (7, 129), (200, 3), (97, 64), (130, 128)]
    for sc, sub in scorings:
        A = 20 if sub is not None else 4
        for (m, n) in shapes:
            a = rng.integers(0, A, m).astype(np.int8)
            b = rng.integers(0, A, n).astype(np.int8)
            if m >= 10 and n >= 10:             # plant homology sometimes
                k = min(m, n) // 2
                b[2: 2 + k] = a[1: 1 + k]
            ref = oracle.fill(a, b, sc, sub=sub)
            got = score_simd(a, b, sc, sub)
            assert got == ref.max_score, (sc, sub is not None, m, n)


def test_simd_score_eligibility_gates():
    """score_simd refuses (returns None) instead of silently saturating:
    score range over the int16 cap, non-negative gaps, sentinel codes."""
    from swtpu.core.config import Scoring
    from swtpu.runtime_native import (available, score_simd,
                                      simd_eligible)

    if not available():
        import pytest
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(11)
    a = rng.integers(0, 4, 64).astype(np.int8)
    b = rng.integers(0, 4, 64).astype(np.int8)
    assert score_simd(a, b) is not None
    # int16 cap: 3 * min(m, n) must stay under 32000
    assert not simd_eligible(20000, 20000)
    assert simd_eligible(20000, 5000)
    # degenerate scorings never take this path
    assert score_simd(a, b, Scoring(match=3, mismatch=-3, gap=0)) is None
    # sentinel codes are SUPPORTED with oracle parity (round-4: the
    # profile carries rows for -3..-1, so N(-1) vs N(-1) still matches)
    from swtpu.core import oracle
    withn = a.copy()
    withn[3] = -1
    bn = b.copy()
    bn[7] = -1
    assert score_simd(withn, bn) == oracle.fill(withn, bn).max_score
    # but codes outside the sentinel range refuse (no profile row)
    bad = a.copy()
    bad[3] = -5
    assert score_simd(bad, b) is None
    # empty sequences score 0 without touching the kernel
    assert score_simd(a[:0], b) == 0


def test_score_routes_simd_in_dead_zone(monkeypatch):
    """engine.score() dispatches sub-cap score-only problems to the SIMD
    host tier (VERDICT r3 #6: the 8k-cells..~6k^2 regime paid the device
    dispatch floor for every call) and still returns the exact score."""
    import swtpu
    from swtpu.core import oracle
    from swtpu.core.encode import random_pair
    import swtpu.runtime_native as rn

    if not rn.available():
        import pytest
        pytest.skip("native lib unavailable")
    calls = {}
    real = rn.score_simd

    def spy(a, b, scoring=None, sub=None):
        calls["hit"] = (len(a), len(b))
        return real(a, b, scoring, sub)

    monkeypatch.setattr(rn, "score_simd", spy)
    a, b = random_pair(1056, 1056, seed=3)
    got = swtpu.score(a, b)
    assert calls["hit"] == (1056, 1056)
    assert got == oracle.fill(a, b).max_score
    # explicit plans bypass the SIMD tier
    calls.clear()
    swtpu.score(a[:64], b[:64], plan="scan")
    assert "hit" not in calls


def test_simd_256_and_512_paths_agree():
    """On AVX-512 machines both template instantiations stay covered: the
    sw_score_simd256 hook (forced 16-lane path) and the default must
    agree with the oracle on the same inputs."""
    import ctypes

    from swtpu.core import oracle
    from swtpu.runtime_native import _load

    lib = _load()
    if lib is None or not hasattr(lib, "sw_score_simd256"):
        import pytest
        pytest.skip("no AVX-512 build")
    lib.sw_score_simd256.restype = ctypes.c_int32
    lib.sw_score_simd256.argtypes = lib.sw_score_simd.argtypes
    rng = np.random.default_rng(13)
    for _ in range(20):
        m = int(rng.integers(1, 200))
        n = int(rng.integers(1, 200))
        a = rng.integers(0, 4, m).astype(np.int8)
        b = rng.integers(0, 4, n).astype(np.int8)
        ref = oracle.fill(a, b).max_score
        assert lib.sw_score_simd(a, b, m, n, 0, 3, -3, -2, 0,
                                 None, 4) == ref
        assert lib.sw_score_simd256(a, b, m, n, 0, 3, -3, -2, 0,
                                    None, 4) == ref


def test_simd_pos_exact_first_occurrence():
    """sw_score_simd_pos: exact (score, i, j) with the oracle's row-major
    first-occurrence tie rule, across tie-rich repeated motifs and all
    scoring modes."""
    from swtpu.core import oracle
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62
    from swtpu.runtime_native import available, score_simd_batch

    if not available():
        import pytest
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(17)
    # tie-rich: same motif planted twice -> equal maxima at two loci
    for trial in range(25):
        m = int(rng.integers(20, 120))
        n = int(rng.integers(20, 120))
        a = rng.integers(0, 4, (1, m)).astype(np.int8)
        b = rng.integers(0, 4, (1, n)).astype(np.int8)
        k = min(m, n) // 3
        b[0, 1: 1 + k] = a[0, 2: 2 + k]
        if n >= 2 * k + 4:
            b[0, n - k - 1: n - 1] = a[0, 2: 2 + k]   # second locus
        ref = oracle.fill(a[0], b[0])
        got = score_simd_batch(a, b)
        assert got is not None
        s, i, j = (int(x[0]) for x in got)
        assert s == ref.max_score, trial
        if ref.max_score > 0:
            assert (i, j) == ref.max_ij, (trial, (i, j), ref.max_ij)

    sc = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    a = rng.integers(0, 20, (4, 60)).astype(np.int8)
    b = rng.integers(0, 20, (4, 45)).astype(np.int8)
    b[:, 3:23] = a[:, 5:25]
    got = score_simd_batch(a, b, sc, BLOSUM62)
    assert got is not None
    for g in range(4):
        ref = oracle.fill(a[g], b[g], sc, sub=BLOSUM62)
        assert int(got[0][g]) == ref.max_score
        assert (int(got[1][g]), int(got[2][g])) == ref.max_ij


def test_batch_score_host_simd_route():
    """On the CPU platform batch_score's auto plan takes the host SIMD
    batch backend (exact scores AND positions); the vmapped scan agrees
    bit-for-bit; forced plan='host-simd' works; tracer contexts skip it
    (the sharded scorer keeps compiling)."""
    from swtpu.core.encode import random_batch
    from swtpu.dist.batch import batch_score
    from swtpu.runtime_native import available

    if not available():
        import pytest
        pytest.skip("native lib unavailable")
    B, m, n = 6, 200, 150
    aa, bb = random_batch(B, m, n, seed=21)
    auto = batch_score(aa, bb)                       # host-simd on CPU
    scan = batch_score(aa, bb, plan="scan")
    forced = batch_score(aa, bb, plan="host-simd")
    for k in range(3):
        np.testing.assert_array_equal(np.asarray(auto[k]),
                                      np.asarray(scan[k]))
        np.testing.assert_array_equal(np.asarray(forced[k]),
                                      np.asarray(scan[k]))


def test_forced_host_simd_fails_loudly():
    """A FORCED plan='host-simd' must run or raise — never silently fall
    through to another backend (ADVICE r4). Covers batch_score (ineligible
    scoring, band, tracer inputs) and database.search (ineligible scoring,
    mesh present) — each with the reject reason in the message."""
    import pytest

    from swtpu.core.config import Scoring
    from swtpu.core.encode import random_batch
    from swtpu.dist.batch import batch_score
    from swtpu.runtime_native import available

    if not available():
        pytest.skip("native lib unavailable")
    aa, bb = random_batch(4, 64, 64, seed=3)
    # gap_extend more negative than gap_open: the lazy-F gate rejects it
    bad = Scoring(mode="affine", gap_open=-1, gap_extend=-6)
    with pytest.raises(ValueError, match="lazy-F"):
        batch_score(aa, bb, scoring=bad, plan="host-simd")
    with pytest.raises(ValueError, match="band"):
        batch_score(aa, bb, band=8, plan="host-simd")

    import jax
    import jax.numpy as jnp

    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    with pytest.raises(ValueError, match="mesh"):
        batch_score(aa, bb, mesh=mesh, plan="host-simd")

    def traced(x, y):
        return batch_score(x, y, plan="host-simd").scores

    with pytest.raises(ValueError, match="concrete"):
        jax.jit(traced)(jnp.asarray(aa), jnp.asarray(bb))

    from swtpu.dist.database import make_searcher
    with pytest.raises(ValueError, match="ineligible"):
        make_searcher(None, qlen=152, shard_len=4096, scoring=bad,
                      plan="host-simd")


def test_align_score_only_routes_simd_with_last_cell():
    """align(traceback=False) below host_simd_max_cells returns the full
    score-only contract (max, exact position, last_cell) from the SIMD
    tier — including the golden builtin example's H[last] == 7."""
    import swtpu
    from swtpu.core import oracle
    from swtpu.core.encode import random_pair
    from swtpu.runtime_native import available, score_simd_pos

    if not available():
        import pytest
        pytest.skip("native lib unavailable")
    # golden example (9x8 wiki): tiny, but exercises exact parity
    got = score_simd_pos(swtpu.encode(swtpu.BUILTIN_A),
                         swtpu.encode(swtpu.BUILTIN_B))
    assert got == (13, 7, 6, 7)     # score, i, j, H[n][m]
    a, b = random_pair(777, 613, seed=31)
    res = swtpu.align(a, b, traceback=False)
    ref = oracle.fill(a, b)
    assert res.max_score == ref.max_score
    assert (res.max_i, res.max_j) == ref.max_ij
    assert res.last_cell == int(ref.H[-1, -1])
    assert res.max_pos == ref.max_ij[0] * (777 + 1) + ref.max_ij[1]


def test_swipe_window_batch_fuzz():
    """The inter-sequence (one-read-per-lane) window scorer: exact score
    AND row-major first-occurrence position parity vs the oracle across
    random batches with padded/N-sentinel reads, planted hits, chunk
    boundaries (windows > 2048 exercise the column-chunked carries), and
    protein scoring."""
    from swtpu.core import oracle
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62
    from swtpu.runtime_native import available, score_simd_window

    if not available():
        import pytest
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(51)
    # chunk-boundary case: window far beyond the 2048-column chunk
    win = rng.integers(0, 4, 5000).astype(np.int8)
    reads = np.full((37, 48), -3, np.int8)
    for g in range(37):
        L = int(rng.integers(8, 49))
        p = int(rng.integers(0, 5000 - L))
        reads[g, :L] = win[p: p + L]
        if g % 5 == 0:
            reads[g, L // 2] = -1                  # an N
        if g % 7 == 0:
            reads[g, :L] = rng.integers(0, 4, L)   # random (weak hits)
    got = score_simd_window(win, reads)
    assert got is not None
    for g in range(37):
        ref = oracle.fill(win, reads[g])
        assert int(got[0][g]) == ref.max_score, g
        if ref.max_score > 0:
            assert (int(got[1][g]), int(got[2][g])) == ref.max_ij, g

    # tie-rich: the same motif planted twice in the window; first
    # occurrence must win per the row-major rule
    win2 = rng.integers(0, 4, 3000).astype(np.int8)
    motif = win2[700:732].copy()
    win2[2400:2432] = motif
    reads2 = np.tile(motif, (5, 1)).astype(np.int8)
    got2 = score_simd_window(win2, reads2)
    for g in range(5):
        ref = oracle.fill(win2, reads2[g])
        assert int(got2[0][g]) == ref.max_score
        assert (int(got2[1][g]), int(got2[2][g])) == ref.max_ij

    # protein + affine through the swipe path (B >= 4)
    sc = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    pwin = rng.integers(0, 20, 2600).astype(np.int8)
    preads = rng.integers(0, 20, (6, 30)).astype(np.int8)
    preads[1, :25] = pwin[2200:2225]               # crosses chunk 1
    pgot = score_simd_window(pwin, preads, sc, BLOSUM62)
    for g in range(6):
        ref = oracle.fill(pwin, preads[g], sc, sub=BLOSUM62)
        assert int(pgot[0][g]) == ref.max_score, g
        if ref.max_score > 0:
            assert (int(pgot[1][g]), int(pgot[2][g])) == ref.max_ij, g


def test_swipe_cross_chunk_tie_prefers_smaller_row():
    """Review r4 regression: equal scores in DIFFERENT column chunks —
    the later chunk's smaller-row cell must win (row-major rule), and an
    equal score at the SAME row in a later chunk must lose (first j)."""
    from swtpu.core import oracle
    from swtpu.runtime_native import available, score_simd_window

    if not available():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(61)
    win = np.full(4000, 3, np.int8)      # all-T: no accidental matches
    read = rng.integers(0, 3, 100).astype(np.int8)   # A/C/G only
    win[100:150] = read[50:100]          # equal 150-score, ends row 100
    win[2500:2550] = read[0:50]          # equal 150-score, ends row 50
    got = score_simd_window(win, np.tile(read, (4, 1)))
    ref = oracle.fill(win, read)
    for g in range(4):
        assert int(got[0][g]) == ref.max_score
        assert (int(got[1][g]), int(got[2][g])) == ref.max_ij
    # same row, two chunks: first j must win
    win2 = np.full(5000, 3, np.int8)
    motif = rng.integers(0, 3, 40).astype(np.int8)
    win2[300:340] = motif
    win2[3300:3340] = motif
    got2 = score_simd_window(win2, np.tile(motif, (4, 1)))
    ref2 = oracle.fill(win2, motif)
    assert (int(got2[1][0]), int(got2[2][0])) == ref2.max_ij


def test_simd_gates_extend_pricier_than_open():
    """Review r4 regression: gap_extend more negative than gap_open is
    outside the striped lazy-F loop's assumption — the tier must refuse
    and the public paths must stay exact via the device/scan plans."""
    import swtpu
    from swtpu.core import oracle
    from swtpu.core.config import Scoring
    from swtpu.core.encode import random_pair
    from swtpu.runtime_native import score_simd, simd_eligible

    sc = Scoring(mode="affine", gap_open=-1, gap_extend=-6)
    assert not simd_eligible(64, 64, sc)
    a, b = random_pair(64, 64, seed=9)
    assert score_simd(a, b, sc) is None
    assert swtpu.score(a, b, scoring=sc) == \
        oracle.fill(a, b, sc).max_score


def test_simd_functional_probe_gates_plans(monkeypatch):
    """Review r4 regression: a library built without AVX2 stubs the SIMD
    entry points — the ISA probe must fail closed so the searcher plan
    and score() fall back instead of raising inside the jitted sweep."""
    import swtpu.runtime_native as rn
    from swtpu.core.config import Scoring
    from swtpu.dist.database import _searcher_plan

    monkeypatch.setattr(rn, "_simd_probe", {"ok": False})
    assert not rn.simd_eligible(64, 64)
    assert rn.score_simd(np.zeros(8, np.int8), np.zeros(8, np.int8)) \
        is None
    assert _searcher_plan(None, 32, 256, Scoring(), "auto") == "scan"
