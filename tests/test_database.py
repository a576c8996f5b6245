"""Database search tests: sharded read-vs-reference search must find each
planted read at its true position, across shard and window boundaries."""

import numpy as np
import pytest

from swtpu.core import oracle
from swtpu.core.encode import random_pair
from swtpu.dist.database import pad_queries, search
from swtpu.dist.mesh import data_mesh


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(8, platform="cpu")


def _plant(ref, read, pos):
    ref = ref.copy()
    ref[pos: pos + len(read)] = read
    return ref


def test_planted_reads_single_device():
    rng = np.random.default_rng(0)
    L, qlen = 2048, 32
    ref = rng.integers(0, 4, L).astype(np.int8)
    positions = [100, 1000, 1500]
    reads = []
    for p in positions:
        read = rng.integers(0, 4, qlen).astype(np.int8)
        ref = _plant(ref, read, p)
        reads.append(read)
    # re-extract after planting (later plants could overlap earlier ones)
    reads = [ref[p: p + qlen].copy() for p in positions]
    hits = search(pad_queries(reads, qlen), ref, mesh=None, window=512)
    for k, p in enumerate(positions):
        assert int(hits.scores[k]) == 3 * qlen, k
        assert int(hits.ref_pos[k]) == p + qlen - 1, k


def test_sharded_matches_single(mesh):
    rng = np.random.default_rng(1)
    L, qlen, B = 4096, 24, 16
    ref = rng.integers(0, 4, L).astype(np.int8)
    # plant some reads crossing shard boundaries (shard_len = 512)
    shard_len = -(-L // 8)
    positions = [10, shard_len - 10, 2 * shard_len - 5, L - qlen - 1]
    reads = []
    for p in positions:
        reads.append(ref[p: p + qlen].copy())
    # plus random reads (may or may not match well)
    for _ in range(B - len(reads)):
        reads.append(rng.integers(0, 4, qlen).astype(np.int8))
    q = pad_queries(reads, qlen)
    single = search(q, ref, mesh=None, window=512)
    multi = search(q, ref, mesh=mesh, window=512)
    np.testing.assert_array_equal(np.asarray(single.scores),
                                  np.asarray(multi.scores))
    np.testing.assert_array_equal(np.asarray(single.ref_pos),
                                  np.asarray(multi.ref_pos))
    for k, p in enumerate(positions):
        assert int(multi.scores[k]) == 3 * qlen
        assert int(multi.ref_pos[k]) == p + qlen - 1


def test_variable_length_reads(mesh):
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 4, 1024).astype(np.int8)
    r1 = ref[50:70].copy()      # 20bp
    r2 = ref[500:532].copy()    # 32bp
    q = pad_queries([r1, r2], 32)
    hits = search(q, ref, mesh=mesh, window=256)
    assert int(hits.scores[0]) == 60
    assert int(hits.ref_pos[0]) == 69
    assert int(hits.scores[1]) == 96
    assert int(hits.ref_pos[1]) == 531


def test_no_hit():
    # read over a disjoint alphabet region: all-A read vs all-T reference
    ref = np.full(512, 3, np.int8)
    read = np.zeros(16, np.int8)
    hits = search(pad_queries([read], 16), ref, mesh=None, window=128)
    assert int(hits.scores[0]) == 0
    assert int(hits.ref_pos[0]) == -1


@pytest.mark.parametrize("plan", ["scan", "host-simd"])
def test_search_stripe_plan_matches_scan(plan):
    """Every window scorer (the device scan, the host SIMD scorer) must
    agree with single-pair oracle windows across windows: planted reads
    found at their exact end, random reads scored identically by both."""
    import jax.numpy as jnp
    import numpy as np
    from swtpu.dist.database import (make_searcher, pad_queries,
                                     shard_reference)

    rng = np.random.default_rng(17)
    ref = rng.integers(0, 4, 600).astype(np.int8)
    reads = [ref[37:61].copy(), ref[333:357].copy(),
             rng.integers(0, 4, 24).astype(np.int8)]
    queries = pad_queries(reads, 24)
    shards, shard_len = shard_reference(ref, 1, 24)
    kw = dict(qlen=24, shard_len=shard_len, window=128)
    q, s = jnp.asarray(queries), jnp.asarray(shards)
    a = make_searcher(None, plan="scan", **kw)(q, s)
    b = make_searcher(None, plan=plan, **kw)(q, s)
    for f in ("scores", "ref_pos", "read_end"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert int(b.scores[0]) == 72          # planted 24-mer, 3*24
    assert (int(b.ref_pos[0]), int(b.ref_pos[1])) == (60, 356)


@pytest.mark.parametrize("plan", ["scan", "host-simd"])
def test_protein_search_stripe_matches_scan(plan):
    """Protein (BLOSUM62 + affine) database search through each window
    scorer finds the planted reads with the oracle's score."""
    import jax.numpy as jnp
    import numpy as np
    import swtpu
    from swtpu.core import oracle
    from swtpu.core.substitution import BLOSUM62
    from swtpu.dist.database import (make_searcher, pad_queries,
                                     shard_reference)

    rng = np.random.default_rng(31)
    ref = rng.integers(0, 20, 500).astype(np.int8)
    reads = [ref[100:124].copy(), rng.integers(0, 20, 24).astype(np.int8),
             ref[300:316].copy()]
    queries = pad_queries(reads, 24)
    shards, shard_len = shard_reference(ref, 1, 24)
    sc = swtpu.Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    kw = dict(qlen=24, shard_len=shard_len, window=128, scoring=sc,
              substitution=BLOSUM62)
    got = make_searcher(None, plan=plan, **kw)(jnp.asarray(queries),
                                               jnp.asarray(shards))
    for k in (0, 2):
        want = oracle.fill(reads[k], reads[k], sc, sub=BLOSUM62).max_score
        assert int(got.scores[k]) >= want
    assert int(got.ref_pos[0]) == 123


def test_search_auto_stays_on_device_on_gpu(fake_gpu):
    """On an accelerator the auto plan keeps the window sweep on the
    device (vmapped scan): no pure_callback into the host scorer."""
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62
    from swtpu.dist.database import _searcher_plan

    assert _searcher_plan(None, 32, 256, Scoring(), "auto") == "scan"
    aff = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    assert _searcher_plan(None, 32, 256, aff, "auto",
                          substitution=BLOSUM62) == "scan"
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 4, 900).astype(np.int8)
    q = pad_queries([ref[200:230].copy()], 30)
    hits = search(q, ref, window=256)
    assert (int(hits.scores[0]), int(hits.ref_pos[0])) == (90, 229)


@pytest.mark.parametrize("plan", ["stripe", "packed"])
def test_search_rejects_removed_plans(plan):
    from swtpu.core.config import Scoring
    from swtpu.dist.database import _searcher_plan
    with pytest.raises(ValueError, match="unknown search plan"):
        _searcher_plan(None, 32, 256, Scoring(), plan)


def test_align_hits_exact_planted_read(mesh):
    """End-to-end: search -> ranked hits -> full alignment records with
    global coordinates and CIGAR (exact 24-mer: all-M, identity strings)."""
    from swtpu.core.encode import decode
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(41)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    p = 700
    read = ref[p: p + 24].copy()
    q = pad_queries([read, rng.integers(0, 4, 24).astype(np.int8)], 24)
    hits = search(q, ref, mesh=mesh, window=512)
    recs = align_hits(hits, q, ref, top=1)
    assert len(recs) == 1
    r = recs[0]
    assert r.read == 0 and r.score == 72
    assert (r.ref_start, r.ref_end) == (p, p + 23)
    assert (r.read_start, r.read_end) == (0, 23)
    assert r.cigar == "24M"
    assert r.aligned_read == r.aligned_ref == decode(read)


def test_align_hits_gapped_read_cigar():
    """A read with an internal deletion (ref base missing from the read)
    aligns with a 'D' run and still spans the planted region."""
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(43)
    ref = rng.integers(0, 4, 1024).astype(np.int8)
    p = 400
    frag = ref[p: p + 30].copy()
    read = np.concatenate([frag[:12], frag[13:]])        # drop one base
    hits = search(pad_queries([read], 32), ref, window=256)
    recs = align_hits(hits, [read], ref)
    r = recs[0]
    assert int(hits.scores[0]) == r.score
    assert r.cigar == "12M1D17M"
    assert (r.ref_start, r.ref_end) == (p, p + 29)
    assert (r.read_start, r.read_end) == (0, 28)
    assert r.aligned_read[12] == "-" and r.aligned_ref[12] != "-"
    # the re-aligned window reproduces the search score exactly
    assert r.score == 3 * 29 + (-2)


def test_align_hits_protein_blosum():
    import swtpu
    from swtpu.core.encode import PROTEIN_ALPHABET, decode
    from swtpu.core.substitution import BLOSUM62
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(47)
    ref = rng.integers(0, 20, 800).astype(np.int8)
    p = 150
    read = ref[p: p + 20].copy()
    sc = swtpu.Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    q = pad_queries([read], 24)
    hits = search(q, ref, scoring=sc, substitution=BLOSUM62, window=256)
    recs = align_hits(hits, q, ref, scoring=sc, substitution=BLOSUM62)
    r = recs[0]
    assert r.score == int(hits.scores[0]) > 0
    assert (r.ref_start, r.ref_end) == (p, p + 19)
    assert r.aligned_ref == decode(read, PROTEIN_ALPHABET)


def test_align_hits_selection_order():
    """top= ranks by score desc then position asc; zero-score reads are
    never aligned; reads= overrides ranking."""
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(53)
    ref = rng.integers(0, 4, 1024).astype(np.int8)
    strong = ref[100:124].copy()                 # 24-mer, score 72
    weak = ref[500:516].copy()                   # 16-mer, score 48
    miss = np.zeros(16, np.int8)
    ref2 = ref.copy()
    ref2[ref2 == 0] = 1                          # kill all-A read's hits
    q = pad_queries([weak, miss, strong], 24)
    hits = search(q, ref2, window=256)
    if int(hits.scores[1]) > 0:                  # 'miss' may still scrape
        assert int(hits.scores[1]) < int(hits.scores[0])
    recs = align_hits(hits, q, ref2, top=2)
    assert [r.read for r in recs] == [2, 0]
    only = align_hits(hits, q, ref2, reads=[0])
    assert [r.read for r in only] == [0]


def test_revcomp_and_padded_revcomp():
    from swtpu.core.encode import decode, encode, revcomp
    from swtpu.dist.database import revcomp_padded

    codes = encode("ACGTTG")
    assert decode(revcomp(codes)) == "CAACGT"
    # involution on real codes
    np.testing.assert_array_equal(revcomp(revcomp(codes)), codes)
    # padded batch: pad stays at the END, valid prefix is the revcomp
    q = pad_queries([encode("ACGT"), encode("AA")], 6)
    rc = revcomp_padded(q)
    np.testing.assert_array_equal(rc[0, :4], encode("ACGT"))  # palindrome
    np.testing.assert_array_equal(rc[0, 4:], [-3, -3])
    np.testing.assert_array_equal(rc[1, :2], encode("TT"))
    np.testing.assert_array_equal(rc[1, 2:], [-3, -3, -3, -3])


def test_search_both_strands(mesh):
    """A read planted reverse-complemented is found on the minus strand at
    the same reference location and score as its forward twin."""
    from swtpu.core.encode import revcomp
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(61)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    p_f, p_r = 300, 1200
    fwd_read = ref[p_f: p_f + 24].copy()
    rc_read = revcomp(ref[p_r: p_r + 24])        # maps only via revcomp
    q = pad_queries([fwd_read, rc_read], 24)
    hits = search(q, ref, mesh=mesh, window=512, strand="both")
    assert int(hits.scores[0]) == int(hits.scores[1]) == 72
    assert int(hits.strand[0]) == 1
    assert int(hits.strand[1]) == -1
    assert int(hits.ref_pos[0]) == p_f + 23
    assert int(hits.ref_pos[1]) == p_r + 23
    # align_hits orients the minus-strand read automatically
    recs = align_hits(hits, q, ref)
    by_read = {r.read: r for r in recs}
    assert by_read[1].strand == "-"
    assert (by_read[1].ref_start, by_read[1].ref_end) == (p_r, p_r + 23)
    assert by_read[1].cigar == "24M"
    assert by_read[0].strand == "+"
    assert (by_read[0].ref_start, by_read[0].ref_end) == (p_f, p_f + 23)


def test_search_both_strands_tie_prefers_forward():
    from swtpu.core.encode import encode

    # palindromic read: forward and reverse complement are identical, so
    # both strands tie and the forward strand must win
    ref = np.concatenate([np.full(100, 0, np.int8),
                          encode("ACGCGT"), np.full(100, 0, np.int8)])
    q = pad_queries([encode("ACGCGT")], 8)
    hits = search(q, ref, window=128, strand="both")
    assert int(hits.scores[0]) == 18
    assert int(hits.strand[0]) == 1


def test_search_both_strands_protein_rejected():
    from swtpu.core.substitution import BLOSUM62

    q = pad_queries([np.zeros(8, np.int8)], 8)
    ref = np.zeros(64, np.int8)
    with pytest.raises(ValueError, match="DNA-only"):
        search(q, ref, substitution=BLOSUM62, strand="both")


def test_to_sam_plus_minus_and_softclips():
    """SAM rendering: 1-based POS, soft-clip runs for unaligned read ends,
    flag 16 + reverse-complemented SEQ on the minus strand, AS score tag."""
    from swtpu.core.encode import decode, encode, revcomp
    from swtpu.dist.database import align_hits, to_sam

    rng = np.random.default_rng(71)
    ref = rng.integers(0, 4, 1024).astype(np.int8)
    p = 256
    ref[p + 30: p + 80] = 0          # all-A downstream: extension of the
    core = ref[p: p + 30].copy()     # T-junk can never gain (T vs A = -3,
    junk = np.full(4, 3, np.int8)    # and every gap-skip lands on A again)
    # read 0: planted fragment + 4 junk bases appended -> tail soft clip
    r0 = np.concatenate([core, junk])
    # read 1: maps only reverse-complemented
    r1 = revcomp(ref[600:630])
    q = pad_queries([r0, r1], 40)
    hits = search(q, ref, window=256, strand="both")
    recs = align_hits(hits, q, ref)
    sam = to_sam(recs, q, ref_name="chr1", ref_len=len(ref),
                 read_names=["frag", "rcread"])
    lines = sam.strip().split("\n")
    assert lines[0].startswith("@HD")
    assert lines[1] == f"@SQ\tSN:chr1\tLN:{len(ref)}"
    by_name = {ln.split("\t")[0]: ln.split("\t") for ln in lines[2:]}
    f0 = by_name["frag"]
    assert f0[1] == "0" and f0[2] == "chr1"
    assert f0[3] == str(p + 1)                   # 1-based POS
    assert f0[5] == "30M4S"                      # tail soft clip
    assert f0[9] == decode(r0)
    assert f0[11] == "AS:i:90"
    f1 = by_name["rcread"]
    assert f1[1] == "16"
    assert f1[3] == "601"
    assert f1[5] == "30M"
    # SEQ is stored in reference-forward orientation (the rc of the read)
    assert f1[9] == decode(revcomp(r1))
    assert f1[9] == decode(ref[600:630])


def test_align_hits_tolerates_underreported_search_score():
    """The searcher scores window fragments independently (halo = qlen),
    so a gapped alignment straddling a window boundary with reference
    span > qlen can be under-reported. align_hits must then return the
    better re-aligned record (not crash failing to reproduce the lower
    score) — simulated here by handing it hits whose score is below the
    true optimum at the reported end column."""
    from swtpu.dist.database import SearchHits, align_hits

    rng = np.random.default_rng(79)
    ref = rng.integers(0, 4, 1024).astype(np.int8)
    p = 300
    read = ref[p: p + 40].copy()
    hits = SearchHits(scores=np.array([100], np.int32),      # true: 120
                      ref_pos=np.array([p + 39], np.int32),
                      read_end=np.array([40], np.int32))
    recs = align_hits(hits, [read], ref)
    r = recs[0]
    assert r.score == 3 * 40
    assert (r.ref_start, r.ref_end) == (p, p + 39)
    assert r.cigar == "40M"


def test_align_hits_truncated_read_stays_end_anchored():
    """A read longer than the search qlen was truncated by pad_queries;
    the hit refers to the truncated read, and align_hits (even given the
    full read) reports an alignment ending at the hit's end column — the
    extra bases simply stay unaligned."""
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(83)
    ref = rng.integers(0, 4, 1024).astype(np.int8)
    p = 300
    full = ref[p: p + 40].copy()
    q = pad_queries([full], 32)                  # truncates to 32
    hits = search(q, ref, window=256)
    assert int(hits.scores[0]) == 3 * 32
    recs = align_hits(hits, [full], ref)
    r = recs[0]
    assert r.score >= 3 * 32
    assert r.ref_end == p + 31


def test_map_cli_end_to_end(tmp_path):
    """`python -m swtpu map ref.fa reads.fa` — native FASTA in, SAM out,
    both strands, in a fresh process."""
    import os
    import subprocess
    import sys

    from swtpu.core.encode import decode, revcomp

    rng = np.random.default_rng(91)
    ref = rng.integers(0, 4, 4096).astype(np.int8)
    fwd = ref[1000:1080]
    rc = revcomp(ref[2000:2080])
    (tmp_path / "ref.fa").write_text(">chrT\n" + decode(ref) + "\n")
    (tmp_path / "reads.fa").write_text(
        ">plus\n" + decode(fwd) + "\n>minus\n" + decode(rc) + "\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "swtpu", "map",
         str(tmp_path / "ref.fa"), str(tmp_path / "reads.fa"),
         "--min-score", "100"],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    body = [ln.split("\t") for ln in out.stdout.strip().split("\n")
            if not ln.startswith("@")]
    by_name = {f[0]: f for f in body}
    assert set(by_name) == {"plus", "minus"}
    assert by_name["plus"][1] == "0" and by_name["plus"][3] == "1001"
    assert by_name["minus"][1] == "16" and by_name["minus"][3] == "2001"
    assert by_name["plus"][5] == by_name["minus"][5] == "80M"


def test_map_cli_protein_blosum62(tmp_path):
    """`swtpu map --blosum62`: protein FASTA through the native
    alphabet-parameterized reader, BLOSUM62+affine search, SAM out."""
    import os
    import subprocess
    import sys

    from swtpu.core.encode import PROTEIN_ALPHABET, decode

    rng = np.random.default_rng(97)
    ref = rng.integers(0, 20, 1500).astype(np.int8)
    pep = ref[400:430]
    (tmp_path / "ref.fa").write_text(
        ">protRef\n" + decode(ref, PROTEIN_ALPHABET) + "\n")
    (tmp_path / "peps.fa").write_text(
        ">pep\n" + decode(pep, PROTEIN_ALPHABET) + "\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "swtpu", "map", str(tmp_path / "ref.fa"),
         str(tmp_path / "peps.fa"), "--blosum62"],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    rec = [ln for ln in out.stdout.strip().split("\n")
           if ln.startswith("pep\t")][0].split("\t")
    assert rec[3] == "401" and rec[5] == "30M"
    assert rec[9] == decode(pep, PROTEIN_ALPHABET)
    # exact self-match BLOSUM62 score
    from swtpu.core.substitution import BLOSUM62
    assert rec[11] == f"AS:i:{int(BLOSUM62[pep, pep].sum())}"


def test_read_seqfile_protein_alphabet(tmp_path):
    from swtpu.core.encode import PROTEIN_ALPHABET
    from swtpu.runtime_native import available, read_seqfile

    if not available():
        pytest.skip("native lib unavailable")
    (tmp_path / "p.fa").write_text(">a\nMKvl\nW?\n")
    (seq,) = read_seqfile(str(tmp_path / "p.fa"),
                          alphabet=PROTEIN_ALPHABET)
    lut = {c: i for i, c in enumerate(PROTEIN_ALPHABET)}
    assert list(seq) == [lut["M"], lut["K"], lut["V"], lut["L"],
                         lut["W"], -1]


def test_search_n_best_two_loci(mesh):
    """A read planted at two loci (second copy carries one SNP) yields a
    primary hit at the exact copy and a secondary at the mutated one; a
    single-locus read reports no second hit (overlapping windows must not
    double-count the same alignment)."""
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(101)
    ref = rng.integers(0, 4, 4096).astype(np.int8)
    p1, p2 = 700, 2900
    read = ref[p1: p1 + 32].copy()
    mut = read.copy()
    mut[10] = (mut[10] + 1) % 4
    ref[p2: p2 + 32] = mut
    ref[p1: p1 + 32] = read                      # keep exact copy intact
    lone = ref[1500:1532].copy()
    # windows of 256 with qlen overlap guarantee multi-window visibility
    q = pad_queries([read, lone], 32)
    hits = search(q, ref, mesh=mesh, window=256, n_best=2)
    assert int(hits.scores[0]) == 96
    assert int(hits.ref_pos[0]) == p1 + 31
    assert int(hits.scores2[0]) == 96 - 6        # one SNP: 3 -> -3
    assert int(hits.ref_pos2[0]) == p2 + 31
    # single-locus read: the same alignment seen from two overlapping
    # windows must NOT occupy both slots
    assert int(hits.scores[1]) == 96
    assert int(hits.ref_pos[1]) == 1531
    assert int(hits.scores2[1]) < 96
    assert int(hits.ref_pos2[1]) != 1531
    # single-device == mesh
    single = search(q, ref, mesh=None, window=256, n_best=2)
    for f in range(6):
        np.testing.assert_array_equal(np.asarray(hits[f]),
                                      np.asarray(single[f]))
    # primary view matches the n_best=1 searcher exactly
    h1 = search(q, ref, mesh=mesh, window=256)
    np.testing.assert_array_equal(np.asarray(hits.primary.scores),
                                  np.asarray(h1.scores))
    np.testing.assert_array_equal(np.asarray(hits.primary.ref_pos),
                                  np.asarray(h1.ref_pos))
    # align_hits consumes the secondary view directly
    recs = align_hits(hits.secondary, q, ref, reads=[0])
    assert recs[0].score == 90 and recs[0].ref_end == p2 + 31


def test_search_n_best_cross_shard(mesh):
    """Primary and secondary loci on different shards merge correctly
    (the all_gather top-2 fold)."""
    rng = np.random.default_rng(103)
    L = 4096                                     # shard_len = 512 on 8 dev
    ref = rng.integers(0, 4, L).astype(np.int8)
    pA, pB = 100, 3700                           # shards 0 and 7
    read = ref[pA: pA + 24].copy()
    mut = read.copy()
    mut[5] = (mut[5] + 2) % 4
    ref[pB: pB + 24] = mut
    ref[pA: pA + 24] = read
    q = pad_queries([read], 24)
    hits = search(q, ref, mesh=mesh, window=256, n_best=2)
    assert int(hits.scores[0]) == 72
    assert int(hits.ref_pos[0]) == pA + 23
    assert int(hits.scores2[0]) == 66
    assert int(hits.ref_pos2[0]) == pB + 23


def test_search_both_strands_top2(mesh):
    """strand='both' + n_best=2: the two slots rank over all four
    strand/locus candidates — here the primary on the minus strand and
    the secondary (one SNP weaker) on the plus strand."""
    from swtpu.core.encode import revcomp
    from swtpu.dist.database import align_hits

    rng = np.random.default_rng(107)
    ref = rng.integers(0, 4, 4096).astype(np.int8)
    pA, pB = 800, 2700
    site = ref[pA: pA + 32].copy()
    weaker = site.copy()
    weaker[7] = (weaker[7] + 1) % 4              # one SNP
    ref[pB: pB + 32] = weaker
    ref[pA: pA + 32] = site
    read = revcomp(site)   # hits pA on '-' (96) and pB on '-' (one SNP, 90)
    q = pad_queries([read], 32)
    hits = search(q, ref, mesh=mesh, window=256, strand="both", n_best=2)
    assert int(hits.scores[0]) == 96
    assert int(hits.strand[0]) == -1
    assert int(hits.ref_pos[0]) == pA + 31
    assert int(hits.scores2[0]) == 90
    assert int(hits.strand2[0]) == -1
    assert int(hits.ref_pos2[0]) == pB + 31
    # align_hits consumes the views with strand orientation
    rp = align_hits(hits.primary, q, ref)
    rs = align_hits(hits.secondary, q, ref)
    assert rp[0].strand == "-" and rp[0].ref_start == pA
    assert rs[0].strand == "-" and rs[0].ref_start == pB


def test_search_both_strands_top2_mixed_strands():
    """Candidates from different strands interleave correctly: plus-strand
    primary, minus-strand secondary."""
    from swtpu.core.encode import revcomp

    rng = np.random.default_rng(109)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    pF, pR = 300, 1500
    read = ref[pF: pF + 28].copy()               # exact forward hit
    weaker = read.copy()
    weaker[3] = (weaker[3] + 2) % 4
    ref[pR: pR + 28] = revcomp(weaker)           # minus-strand weaker hit
    ref[pF: pF + 28] = read
    q = pad_queries([read], 28)
    hits = search(q, ref, window=256, strand="both", n_best=2)
    assert int(hits.scores[0]) == 84 and int(hits.strand[0]) == 1
    assert int(hits.ref_pos[0]) == pF + 27
    assert int(hits.scores2[0]) == 78 and int(hits.strand2[0]) == -1
    assert int(hits.ref_pos2[0]) == pR + 27


def test_map_cli_secondary_records(tmp_path):
    """`swtpu map --secondary`: primary line carries XS:i (second-best
    score); secondary locus emitted as a flag-256 record (272 when it is
    on the minus strand)."""
    import os
    import subprocess
    import sys

    from swtpu.core.encode import decode, revcomp

    rng = np.random.default_rng(113)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    site = ref[700:732].copy()
    weak = site.copy()
    weak[9] = (weak[9] + 1) % 4
    ref[2000:2032] = revcomp(weak)
    ref[700:732] = site
    (tmp_path / "ref.fa").write_text(">c\n" + decode(ref) + "\n")
    (tmp_path / "r.fa").write_text(">r1\n" + decode(site) + "\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "swtpu", "map", str(tmp_path / "ref.fa"),
         str(tmp_path / "r.fa"), "--secondary", "--min-score", "50"],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    body = [ln.split("\t") for ln in out.stdout.strip().split("\n")
            if not ln.startswith("@")]
    assert len(body) == 2
    prim, sec = body
    assert prim[1] == "0" and prim[3] == "701"
    assert prim[11] == "AS:i:96" and prim[12] == "XS:i:90"
    assert sec[1] == "272" and sec[3] == "2001"  # secondary + minus
    assert sec[11] == "AS:i:90"


def test_n_best_no_phantom_secondary_at_window_boundary():
    """A uniquely-mapping read straddling a window boundary is seen twice
    (once end-truncated at the boundary with a SHIFTED end position);
    the truncated view must not surface as a phantom second locus."""
    rng = np.random.default_rng(127)
    ref = rng.integers(0, 4, 512).astype(np.int8)
    p = 110                                      # spans windows 0 and 1
    read = ref[p: p + 32].copy()
    hits = search(pad_queries([read], 32), ref, window=128, n_best=2)
    assert int(hits.scores[0]) == 96
    assert int(hits.ref_pos[0]) == p + 31
    # the end-truncated view scores 3 * 18 = 54 at the window-0 boundary
    # (pos 127); a genuine weak secondary elsewhere is fine, but nothing
    # within a read length of the primary may occupy the second slot
    if int(hits.scores2[0]) > 0:
        assert abs(int(hits.ref_pos2[0]) - int(hits.ref_pos[0])) > 32
        assert int(hits.scores2[0]) < 54


def test_n_best_boundary_straddler_with_real_second_locus(mesh):
    """The boundary-straddling primary still reports its genuine second
    locus elsewhere (the truncated view must not shadow it either)."""
    rng = np.random.default_rng(131)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    p1, p2 = 110, 1500                           # p1 straddles window 0/1
    read = ref[p1: p1 + 32].copy()
    weak = read.copy()
    weak[4] = (weak[4] + 1) % 4
    ref[p2: p2 + 32] = weak
    ref[p1: p1 + 32] = read
    for m in (None, mesh):
        hits = search(pad_queries([read], 32), ref, mesh=m, window=128,
                      n_best=2)
        assert int(hits.scores[0]) == 96, m
        assert int(hits.ref_pos[0]) == p1 + 31, m
        assert int(hits.scores2[0]) == 90, m
        assert int(hits.ref_pos2[0]) == p2 + 31, m


def test_n_best_mixed_length_batch_uses_per_read_dedup_radius():
    """In a mixed-length batch the locus-dedup radius must be each read's
    OWN length, not the padded batch length: a 24-base read's two genuine
    loci 60 apart (farther than the read, nearer than the 128-base pad)
    must fill both slots instead of collapsing to a false unique mapping
    (which would report MAPQ 60 for a true multi-mapper)."""
    rng = np.random.default_rng(137)
    ref = rng.integers(0, 4, 512).astype(np.int8)
    p1, p2 = 100, 160                            # end positions 60 apart
    short = ref[p1: p1 + 24].copy()
    ref[p2: p2 + 24] = short                     # exact second copy
    ref[p1: p1 + 24] = short
    long = ref[300: 300 + 128].copy()            # pads the batch to 128
    q = pad_queries([short, long], 128)
    hits = search(q, ref, window=256, n_best=2, sec_resolution=256)
    assert int(hits.scores[0]) == 72
    assert int(hits.ref_pos[0]) == p1 + 23       # tie -> lower position
    assert int(hits.scores2[0]) == 72, \
        "second exact locus collapsed by the padded-length dedup radius"
    assert int(hits.ref_pos2[0]) == p2 + 23
    # the long read itself still dedups at its own (full) length: its
    # overlapping-window views must not fabricate a second locus
    if int(hits.scores2[1]) > 0:
        assert abs(int(hits.ref_pos2[1]) - int(hits.ref_pos[1])) > 128


def test_both_strands_top2_tie_prefers_forward():
    """Equal-score hits on both strands: the primary must be the forward
    one regardless of position — the same tie rule as n_best=1."""
    from swtpu.core.encode import revcomp

    rng = np.random.default_rng(137)
    ref = rng.integers(0, 4, 2048).astype(np.int8)
    pR, pF = 300, 1500                           # reverse locus FIRST
    read = ref[pF: pF + 28].copy()
    ref[pR: pR + 28] = revcomp(read)
    ref[pF: pF + 28] = read
    q = pad_queries([read], 28)
    h1 = search(q, ref, window=256, strand="both")
    h2 = search(q, ref, window=256, strand="both", n_best=2)
    assert int(h1.strand[0]) == 1 and int(h1.ref_pos[0]) == pF + 27
    assert int(h2.strand[0]) == 1 and int(h2.ref_pos[0]) == pF + 27
    assert int(h2.strand2[0]) == -1 and int(h2.ref_pos2[0]) == pR + 27


def test_seq_names_fastq_quality_line_starting_with_header_chars(tmp_path):
    """'>' and '@' are legal Phred+33 quality characters; names must come
    only from real headers."""
    from swtpu.runtime_native import available, read_seqfile, seq_names

    fq = tmp_path / "r.fq"
    fq.write_text("@read1\nACGTACGT\n+\n>IIIIIII\n"
                  "@read2\nTTTTACGT\n+\n@IIIIIII\n")
    assert seq_names(str(fq)) == ["read1", "read2"]
    if available():
        seqs = read_seqfile(str(fq))
        assert len(seqs) == 2
        assert list(seqs[1][:4]) == [3, 3, 3, 3]


def test_concat_references_and_locate():
    """Spacers between records are long enough that no local alignment
    can profitably span them, and coordinates map back per record."""
    import swtpu
    from swtpu.dist.database import concat_references, locate_record

    rng = np.random.default_rng(139)
    a = rng.integers(0, 4, 300).astype(np.int8)
    b = rng.integers(0, 4, 200).astype(np.int8)
    qlen = 32
    cat, starts = concat_references([a, b], qlen)
    assert list(starts) == [0, 300 + (3 * qlen // 2 + qlen + 1)]
    np.testing.assert_array_equal(cat[:300], a)
    np.testing.assert_array_equal(cat[int(starts[1]):], b)
    assert (cat[300:int(starts[1])] == -2).all()
    assert locate_record(starts, [a, b], 299) == (0, 299)
    assert locate_record(starts, [a, b], int(starts[1]) + 5) == (1, 5)
    with pytest.raises(ValueError, match="spacer"):
        locate_record(starts, [a, b], 305)
    # a read whose halves sit at the two record edges cannot span: the
    # best alignment is one side alone
    read = np.concatenate([a[-16:], b[:16]])
    hits = search(pad_queries([read], 32), cat, window=256)
    assert int(hits.scores[0]) <= 3 * 16 + 12    # one side +slack, never 96


def test_map_cli_multi_chromosome(tmp_path):
    """Multi-record reference FASTA: per-record @SQ headers, RNAME and
    local 1-based POS on both strands."""
    import os
    import subprocess
    import sys

    from swtpu.core.encode import decode, revcomp

    rng = np.random.default_rng(149)
    chr1 = rng.integers(0, 4, 1500).astype(np.int8)
    chr2 = rng.integers(0, 4, 1000).astype(np.int8)
    r1 = chr1[400:440].copy()
    r2 = revcomp(chr2[700:740])
    (tmp_path / "g.fa").write_text(
        ">chr1\n" + decode(chr1) + "\n>chr2\n" + decode(chr2) + "\n")
    (tmp_path / "r.fa").write_text(
        ">a\n" + decode(r1) + "\n>b\n" + decode(r2) + "\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "swtpu", "map", str(tmp_path / "g.fa"),
         str(tmp_path / "r.fa"), "--min-score", "100"],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().split("\n")
    assert "@SQ\tSN:chr1\tLN:1500" in lines and \
        "@SQ\tSN:chr2\tLN:1000" in lines
    by = {f[0]: f for f in (ln.split("\t") for ln in lines
                            if not ln.startswith("@"))}
    assert by["a"][2] == "chr1" and by["a"][3] == "401" and by["a"][1] == "0"
    assert by["b"][2] == "chr2" and by["b"][3] == "701" and by["b"][1] == "16"


def test_concat_references_substitution_spacer():
    """BLOSUM62 spacers are sized by the TABLE MAX (W-W scores 11), not
    scoring.match=3: with match-sized spacers a tryptophan-rich read
    straddling two record edges profitably spans the spacer (157 > 147
    one-sided at qlen=24) and crashes the map CLI's record-locating
    assertion. Table-sized spacers make the crossing strictly losing."""
    from swtpu.core.substitution import BLOSUM62
    from swtpu.dist.database import (align_hits, concat_references,
                                     locate_record)
    from swtpu.core.config import Scoring

    qlen, W = 24, 17                       # PROTEIN_ALPHABET.index('W')
    rng = np.random.default_rng(157)
    a = rng.integers(0, 20, 220).astype(np.int8)
    b = rng.integers(0, 20, 180).astype(np.int8)
    a[-12:] = W                            # W-rich record edges
    b[:12] = W
    scoring = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    cat, starts = concat_references([a, b], qlen, scoring,
                                    substitution=BLOSUM62)
    assert int(starts[1]) - len(a) >= 11 * qlen + qlen + 1
    read = np.full(qlen, W, np.int8)
    hits = search(pad_queries([read], qlen), cat, window=512,
                  scoring=scoring, substitution=BLOSUM62)
    recs = align_hits(hits, [read], cat, scoring=scoring,
                      substitution=BLOSUM62)
    ci, _ = locate_record(starts, [a, b], recs[0].ref_start)
    cj, _ = locate_record(starts, [a, b], recs[0].ref_end)
    assert ci == cj
    with pytest.raises(ValueError, match="before the first"):
        locate_record(starts, [a, b], -1)


def test_search_memo_invalidation_and_lru(monkeypatch):
    """The searcher memo must not rebuild on tuned-policy observations
    (no searcher reads them) and must evict least-recently-USED, so a hot
    shape survives churn from one-shot shapes."""
    import swtpu.dist.database as db
    from swtpu.dispatch.plan import _tuned_policy

    builds = []
    real = db.make_searcher

    def counting(*a, **k):
        builds.append(1)
        return real(*a, **k)

    monkeypatch.setattr(db, "make_searcher", counting)
    db._searcher_memo.clear()
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 400).astype(np.int8)
    q = pad_queries([ref[50:70]], 20)
    db.search(q, ref, window=128)
    n0 = len(builds)
    db.search(q, ref, window=128)              # same shape: memo hit
    assert len(builds) == n0
    pol = _tuned_policy(create=True)
    # a warm align() observe must NOT invalidate the searcher
    pol.observe(999, 999, "scan", 0.1)
    pol.observe(128, 400, "scan", 0.5, sig="batch|linear")
    db.search(q, ref, window=128)
    assert len(builds) == n0
    db.search(q, ref, window=127)              # another shape: new build
    assert len(builds) == n0 + 1
    for w in range(60, 75):                    # 15 cold shapes -> memo full
        db.search(q, ref, window=w)
    db.search(q, ref, window=128)              # touch the hot entry
    db.search(q, ref, window=50)               # 17th insert evicts LRU
    n1 = len(builds)
    db.search(q, ref, window=128)
    assert len(builds) == n1                   # hot survived the eviction


def test_mapq_formula():
    from swtpu.dist.database import mapq

    assert mapq(100, None) == 60        # unique placement
    assert mapq(100, 0) == 60
    assert mapq(100, 100) == 0          # tied loci: ambiguous
    assert mapq(100, 50) == 30          # linear in the relative gap
    assert mapq(0, None) == 0           # no alignment at all
    assert 0 <= mapq(37, 36) <= 60


def test_seq_quals_fastq_and_fasta(tmp_path):
    from swtpu.runtime_native import seq_quals

    fq = tmp_path / "r.fq"
    fq.write_text("@r1\nACGT\n+\n>@I!\n"        # quals may start with > or @
                  "@r2\nTTTT\n+anything\nIIII\n")
    assert seq_quals(str(fq)) == [">@I!", "IIII"]
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGT\nACGT\n>b\nTT\n")
    assert seq_quals(str(fa)) == [None, None]


def test_to_sam_mapq_and_qual_passthrough():
    """MAPQ comes from the AS-XS gap when a second-best score is known
    (255 otherwise, 0 for secondary records); FASTQ quality strings fill
    QUAL, reversed on the minus strand to match the rc'd SEQ."""
    from swtpu.dist.database import HitAlignment, to_sam

    recs = [
        HitAlignment(0, 100, 10, 39, 0, 29, "A" * 30, "A" * 30, "30M"),
        HitAlignment(1, 100, 50, 79, 0, 29, "A" * 30, "A" * 30, "30M",
                     strand="-", xs=50),
        HitAlignment(1, 50, 200, 229, 0, 29, "A" * 30, "A" * 30, "30M",
                     is_secondary=True),
    ]
    q = [np.zeros(30, np.int8), np.zeros(30, np.int8)]
    quals = ["I" * 30, "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123"]
    sam = to_sam(recs, q, ref_len=512, quals=quals)
    body = [ln.split("\t") for ln in sam.strip().split("\n")
            if not ln.startswith("@")]
    assert body[0][4] == "255" and body[0][10] == "I" * 30
    assert body[1][4] == "30"                       # 60*(100-50)/100
    assert body[1][10] == quals[1][::-1]            # minus strand reversed
    assert body[2][4] == "0" and body[2][1] == "256"


def test_secondary_locus_same_window():
    """Two loci of one read inside a single user-sized window: each
    window contributes one candidate to the top-2 carry, so n_best=2
    clamps the sweep window to the secondary resolution — an exact
    duplicate 1.5 kb away must surface as the secondary hit even when
    the caller asked for 32 kb windows."""
    from swtpu.dist.database import pad_queries, search

    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    ref[2000:2040] = ref[500:540]            # exact duplicate locus
    read = ref[505:535].copy()
    h = search(pad_queries([read], 30), ref, n_best=2, window=32768)
    assert int(h.scores[0]) == 90 and int(h.ref_pos[0]) == 534
    assert int(h.scores2[0]) == 90 and int(h.ref_pos2[0]) == 2034


def test_pair_hits_selection():
    """pair_hits picks the highest-scoring PROPER (FR, insert-bounded)
    combination of each end's top-2 candidates — even when that means
    the secondary slot — and falls back to the independent bests
    (proper=False) when no combination qualifies."""
    from swtpu.dist.database import StrandedHits2, pair_hits

    def h2(rows):
        cols = list(zip(*rows))
        return StrandedHits2(*[np.asarray(c) for c in cols])

    # fields: s, p, e, st, s2, p2, e2, st2
    h1 = h2([
        (100, 5000, 40, 1, 90, 1000, 40, 1),   # primary is a far decoy
        (100, 1000, 40, 1, 0, -1, 0, 0),        # fwd, unique
    ])
    hB = h2([
        (95, 1300, 40, -1, 0, -1, 0, 0),        # proper only with h1's 2nd
        (80, 3000, 40, 1, 70, 900, 40, 1),      # same strand: never proper
    ])
    ps = pair_hits(h1, hB, max_insert=1000)
    # pair 0: (secondary of end1, primary of end2) is FR with insert ~340
    assert bool(ps.proper[0])
    assert int(ps.mate1.scores[0]) == 90 and int(ps.mate1.ref_pos[0]) == 1000
    assert int(ps.mate2.scores[0]) == 95
    assert int(ps.alt_scores1[0]) == 100        # the decoy becomes XS
    # pair 1: both ends forward -> no proper combo, primary/primary kept
    assert not bool(ps.proper[1])
    assert int(ps.mate1.scores[1]) == 100 and int(ps.mate2.scores[1]) == 80


def test_map_cli_paired_end(tmp_path):
    """Paired-end CLI: proper FR pair gets flags 99/147, RNEXT '=',
    signed TLEN, shared QNAME (suffixes stripped); a poly-N mate is
    unmapped, so its partner carries the mate-unmapped bit."""
    import os
    import subprocess
    import sys

    from swtpu.core.encode import decode, revcomp

    rng = np.random.default_rng(9)
    ref = rng.integers(0, 4, 4000).astype(np.int8)
    a1, a2 = ref[1000:1040], revcomp(ref[1300:1340])
    b1 = ref[2500:2540]
    (tmp_path / "g.fa").write_text(">c1\n" + decode(ref) + "\n")
    (tmp_path / "r1.fq").write_text(
        "@pA/1\n" + decode(a1) + "\n+\n" + "I" * 40 + "\n"
        "@pB/1\n" + decode(b1) + "\n+\n" + "I" * 40 + "\n")
    (tmp_path / "r2.fq").write_text(
        "@pA/2\n" + decode(a2) + "\n+\n" + "J" * 40 + "\n"
        "@pB/2\n" + "N" * 40 + "\n+\n" + "J" * 40 + "\n")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "swtpu", "map", str(tmp_path / "g.fa"),
         str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    body = [ln.split("\t") for ln in out.stdout.strip().split("\n")
            if not ln.startswith("@")]
    pa = [f for f in body if f[0] == "pA"]
    assert [f[1] for f in pa] == ["99", "147"]       # proper FR pair
    assert pa[0][3] == "1001" and pa[0][6] == "=" and pa[0][7] == "1301"
    assert pa[0][8] == "340" and pa[1][8] == "-340"
    assert pa[0][10] == "I" * 40 and pa[1][10] == "J" * 40
    pb = [f for f in body if f[0] == "pB"]
    assert len(pb) == 2                  # mapped mate1 + flag-4 mate2
    assert int(pb[0][1]) & 0x8 and int(pb[0][1]) & 0x1 and \
        int(pb[0][1]) & 0x40
    assert int(pb[1][1]) & 0x4 and int(pb[1][1]) & 0x80
    assert pb[1][3] == pb[0][3] and pb[1][5] == "*"  # placed at mate, no CIGAR


def test_empty_fastq_record_stays_in_sync():
    """A quality-trimmed empty read must not desynchronize the FASTQ
    parsers: before the fix, the blank seq/qual lines were skipped
    without advancing the 4-line state machine, so the NEXT read's
    bases were returned as the empty read's quality string (and the
    native reader encoded the '+' separator as a base)."""
    import tempfile

    from swtpu.runtime_native import available, read_seqfile, seq_names, \
        seq_quals

    with tempfile.NamedTemporaryFile("w", suffix=".fq",
                                     delete=False) as f:
        f.write("@r1\n\n+\n\n@r2\nACGT\n+\nIIII\n")
        path = f.name
    assert seq_names(path) == ["r1", "r2"]
    assert seq_quals(path) == ["", "IIII"]
    if available():
        seqs = read_seqfile(path)
        assert len(seqs) == 2
        assert len(seqs[0]) == 0                 # empty read stays empty
        assert list(seqs[1]) == [0, 1, 2, 3]


def test_pair_hits_record_gate():
    """With a concat_references reference, two mates straddling the
    (short) inter-record spacer satisfy the FR/insert check in global
    coordinates; record_starts gates properness to one chromosome."""
    from swtpu.dist.database import StrandedHits2, pair_hits

    def h(*rows):
        return StrandedHits2(*[np.asarray(c) for c in zip(*rows)])

    # chr0 = [0, 400), chr1 starts at 500 (spacer 100): mate1 fwd ends
    # at 390 (chr0), mate2 rev ends at 600 (chr1), "insert" ~250
    h1 = h((100, 390, 40, 1, 0, -1, 0, 0))
    hB = h((95, 600, 40, -1, 0, -1, 0, 0))
    ps = pair_hits(h1, hB, max_insert=1000)
    assert bool(ps.proper[0])                    # ungated: looks proper
    ps = pair_hits(h1, hB, max_insert=1000,
                   record_starts=np.array([0, 500]))
    assert not bool(ps.proper[0])                # gated: cross-record


def test_unique_mapping_gets_mapq_60():
    """xs=0 means 'second locus searched, none found' — the most
    confident mappings must render MAPQ 60, not 255 ('unavailable',
    which MAPQ-aware downstream tools filter out), and no XS tag."""
    from swtpu.dist.database import HitAlignment, to_sam

    rec = HitAlignment(0, 120, 10, 49, 0, 39, "A" * 40, "A" * 40,
                       "40M", xs=0)
    line = [ln for ln in to_sam([rec], [np.zeros(40, np.int8)],
                                ref_len=100).splitlines()
            if not ln.startswith("@")][0]
    fields = line.split("\t")
    assert fields[4] == "60"
    assert not any(f.startswith("XS:") for f in fields)


def test_align_hits_uses_host_tier(monkeypatch):
    """Hit re-alignment windows (a read x ~2 read lengths) must run the
    native C host fill — align_hits raises the host-tier cell cap, so
    per-hit cost is ~µs instead of the multi-ms device dispatch floor
    (a 152 bp read's first window is ~28k cells, over the default 8k
    cap)."""
    import swtpu.runtime_native as rn
    from swtpu.dist.database import align_hits

    if not rn.available():
        pytest.skip("native runtime not built")
    calls = []
    real = rn.fill
    monkeypatch.setattr(
        rn, "fill", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    rng = np.random.default_rng(77)
    ref = rng.integers(0, 4, 4096).astype(np.int8)
    read = ref[1000:1152].copy()
    hits = search(pad_queries([read], 152), ref, window=1024)
    recs = align_hits(hits, [read], ref)
    assert recs[0].cigar == "152M" and recs[0].ref_start == 1000
    assert calls                     # the re-alignment ran the C fill


def test_to_sam_unmapped_record():
    """Flag-4 records: '*' RNAME/CIGAR and POS/MAPQ 0 when unplaced,
    the mate's coordinate when placed, SEQ with 'N' for unknown-base
    sentinels (negative codes previously rendered as the LAST alphabet
    letter via Python negative indexing)."""
    from swtpu.dist.database import HitAlignment, to_sam

    unplaced = HitAlignment(0, 0, -1, -1, 0, 0, "", "", "*",
                            is_unmapped=True)
    placed = HitAlignment(1, 0, 499, -1, 0, 0, "", "", "*",
                          is_unmapped=True, flag_extra=0x1 | 0x80,
                          rnext="=", pnext=499)
    q = [np.full(8, -1, np.int8), np.zeros(8, np.int8)]
    body = [ln.split("\t") for ln in
            to_sam([unplaced, placed], q, ref_len=1000,
                   quals=["IIIIIIII", None]).splitlines()
            if not ln.startswith("@")]
    assert body[0][1:9] == ["4", "*", "0", "0", "*", "*", "0", "0"]
    assert body[0][9] == "N" * 8 and body[0][10] == "IIIIIIII"
    assert body[1][1] == str(4 | 0x1 | 0x80)
    assert body[1][2] == "ref" and body[1][3] == "500"
    assert body[1][6] == "=" and body[1][7] == "500"


def test_pair_hits_prefers_higher_scoring_proper_combo():
    """When two combinations are both proper, the higher-scoring one
    wins; insert bounds are inclusive and measured from the forward
    mate's estimated start to the reverse mate's end."""
    from swtpu.dist.database import StrandedHits2, pair_hits

    def h(*rows):
        return StrandedHits2(*[np.asarray(c) for c in zip(*rows)])

    # end1 candidates: fwd@1000 (s=80) and fwd@5000 (s=70)
    h1 = h((80, 1000, 40, 1, 70, 5000, 40, 1))
    # end2 candidates: rev@1300 (s=50, pairs with slot0, sum 130) and
    # rev@5200 (s=90, pairs with slot1, sum 160 -> wins)
    h2 = h((90, 5200, 40, -1, 50, 1300, 40, -1))
    ps = pair_hits(h1, h2, max_insert=1000)
    assert bool(ps.proper[0])
    assert int(ps.mate1.ref_pos[0]) == 5000
    assert int(ps.mate2.ref_pos[0]) == 5200
    assert int(ps.alt_scores1[0]) == 80      # displaced best becomes XS
    # exact-bound check: insert = rev_end - (fwd_pos - fwd_read_end) + 1
    # = 1300 - (1000 - 40) + 1 = 341; max_insert=341 keeps it proper,
    # 340 rejects it
    h2b = h((50, 1300, 40, -1, 0, -1, 0, 0))
    h1b = h((80, 1000, 40, 1, 0, -1, 0, 0))
    assert bool(pair_hits(h1b, h2b, max_insert=341).proper[0])
    assert not bool(pair_hits(h1b, h2b, max_insert=340).proper[0])


def test_map_reads_library_api():
    """swtpu.map_reads: the whole mapping pipeline as one library call —
    multi-record reference, paired-end, proper flags, sorted output."""
    import swtpu
    from swtpu.core.encode import revcomp

    rng = np.random.default_rng(23)
    c1 = rng.integers(0, 4, 1200).astype(np.int8)
    c2 = rng.integers(0, 4, 800).astype(np.int8)
    r1 = [c1[300:340].copy(), c2[100:140].copy()]
    r2 = [revcomp(c1[600:640]), revcomp(c2[400:440])]
    res = swtpu.map_reads([c1, c2], r1, reads2=r2,
                          ref_names=["c1", "c2"], sort=True)
    assert res.so == "coordinate" and res.sq == [("c1", 1200), ("c2", 800)]
    mapped = [r for r in res.records if not r.is_unmapped]
    assert len(mapped) == 4
    assert all(r.flag_extra & 0x1 and r.flag_extra & 0x2 for r in mapped)
    # coordinate order: c1 pair before c2 pair
    assert [r.rname for r in mapped] == ["c1", "c1", "c2", "c2"]
    assert mapped[0].ref_start == 300 and mapped[2].ref_start == 100
    assert mapped[0].tlen == 340 and mapped[1].tlen == -340


def test_map_reads_library_hardening():
    """Library-entry edge cases the CLI used to paper over: protein
    calls auto-switch to forward strand, empty/mismatched references
    raise ValueError, and sort-with-no-ref_names puts unplaced
    unmapped records LAST."""
    import swtpu
    from swtpu.core.substitution import BLOSUM62

    rng = np.random.default_rng(29)
    prot = rng.integers(0, 20, 400).astype(np.int8)
    res = swtpu.map_reads(prot, [prot[50:74].copy()],
                          substitution=BLOSUM62,
                          scoring=swtpu.Scoring(mode="affine",
                                                gap_open=-11,
                                                gap_extend=-1))
    assert [r for r in res.records if not r.is_unmapped][0].ref_start == 50
    with pytest.raises(ValueError, match="empty reference"):
        swtpu.map_reads([], [prot[:24]])
    dna = rng.integers(0, 4, 600).astype(np.int8)
    with pytest.raises(ValueError, match="ref_names"):
        swtpu.map_reads([dna[:300], dna[300:]], [dna[10:40].copy()],
                        ref_names=["only-one"])
    res = swtpu.map_reads(dna, [dna[100:130].copy(),
                                np.full(30, -1, np.int8)], sort=True)
    assert not res.records[0].is_unmapped      # mapped first
    assert res.records[-1].is_unmapped         # unplaced flag-4 last


def test_map_reads_flagstat_completeness():
    """The completeness contract behind default unmapped emission:
    every input read appears EXACTLY once as a non-secondary record
    (mapped or flag-4) — single-end and paired, even under top
    truncation; unmapped=False drops the flag-4 records."""
    import swtpu
    from swtpu.core.encode import revcomp

    rng = np.random.default_rng(31)
    dna = rng.integers(0, 4, 2000).astype(np.int8)
    reads = [dna[100:140].copy(), dna[700:740].copy(),
             np.full(40, -1, np.int8)]
    res = swtpu.map_reads(dna, reads, top=1)
    assert sorted(r.read for r in res.records
                  if not r.is_secondary) == [0, 1, 2]
    assert sum(not r.is_unmapped for r in res.records) == 1   # top=1
    res = swtpu.map_reads(dna, reads, unmapped=False)
    assert all(not r.is_unmapped for r in res.records)
    assert len(res.records) == 2
    r1 = [dna[300:340].copy(), dna[900:940].copy()]
    r2 = [revcomp(dna[600:640]), np.full(40, -1, np.int8)]
    res = swtpu.map_reads(dna, r1, reads2=r2, top=1)
    assert sorted(r.read for r in res.records) == [0, 1, 2, 3]


def test_window_must_exceed_qlen():
    """A window no larger than the padded read length would make the
    sweep stride non-positive (ZeroDivisionError before the guard)."""
    rng = np.random.default_rng(33)
    ref = rng.integers(0, 4, 512).astype(np.int8)
    with pytest.raises(ValueError, match="must exceed"):
        search(pad_queries([ref[:32].copy()], 32), ref, window=32)


def test_searcher_host_simd_plan_parity():
    """On the CPU platform the auto plan is 'host-simd' (the striped AVX
    scorer inside the jitted window sweep via pure_callback); it must
    agree with the scan plan bit-for-bit — scores AND positions — across
    single-best, both-strand top-2, and protein searches, including
    N-sentinel reads."""
    from swtpu.core.config import Scoring
    from swtpu.core.substitution import BLOSUM62
    from swtpu.dist.database import _searcher_plan
    from swtpu.runtime_native import available

    if not available():
        pytest.skip("native lib unavailable")
    assert _searcher_plan(None, 32, 256, Scoring(), "auto") == "host-simd"

    rng = np.random.default_rng(151)
    ref = rng.integers(0, 4, 3000).astype(np.int8)
    p1, p2 = 400, 2200
    read = ref[p1: p1 + 48].copy()
    mut = read.copy()
    mut[7] = (mut[7] + 1) % 4
    ref[p2: p2 + 48] = mut
    ref[p1: p1 + 48] = read
    nread = read.copy()
    nread[5] = -1                                # an N base
    q = pad_queries([read, nread, ref[100:120].copy()], 48)

    for kw in (dict(), dict(n_best=2), dict(strand="both"),
               dict(strand="both", n_best=2)):
        host = search(q, ref, window=512, plan="host-simd", **kw)
        scan = search(q, ref, window=512, plan="scan", **kw)
        for f in range(len(host)):
            np.testing.assert_array_equal(
                np.asarray(host[f]), np.asarray(scan[f]), str(kw))

    # protein (BLOSUM62 + affine): substitution profile parity
    pref = rng.integers(0, 20, 1500).astype(np.int8)
    pread = pref[300:340].copy()
    sc = Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    pq = pad_queries([pread], 40)
    h = search(pq, pref, window=256, scoring=sc, substitution=BLOSUM62,
               plan="host-simd")
    s = search(pq, pref, window=256, scoring=sc, substitution=BLOSUM62,
               plan="scan")
    assert int(h.scores[0]) == int(s.scores[0])
    assert int(h.ref_pos[0]) == int(s.ref_pos[0])


@pytest.mark.parametrize("L,qlen,D,window,n_best", [
    (4096, 32, 8, 256, 1), (4096, 24, 1, 512, 1), (1_000_000, 152, 4, 32768,
                                                  2),
    (1_000_000, 152, 1, 32768, 2), (5000, 100, 3, 101, 1)])
def test_window_spans_hold_every_short_span(L, qlen, D, window, n_best):
    """Windows overlap by qlen, so every reference interval of at most
    qlen columns lies inside one window, whatever the shard count."""
    from swtpu.dist.database import window_spans

    starts, w = window_spans(L, qlen, D, window, n_best)
    assert w > qlen and (np.diff(np.sort(starts)) <= w - qlen).all()
    s = np.arange(0, L - qlen + 1)
    # the last window starting at or before s must reach s + qlen - 1
    ss = np.sort(starts)
    k = np.searchsorted(ss, s, side="right") - 1
    assert (k >= 0).all() and (ss[k] + w >= s + qlen).all()


def test_window_edge_cut_depends_on_sharding(mesh):
    """A gapped hit spanning more reference columns than the read length
    is reported at full score by the cut whose windows hold its whole
    span, and below it by a cut whose window edge falls inside the span —
    the one way a sharded search and a single-device search may differ."""
    from swtpu.dist.database import window_spans

    rng = np.random.default_rng(163)
    L, qlen, window = 4096, 32, 256
    ref = rng.integers(0, 4, L).astype(np.int8)
    one, w = window_spans(L, qlen, 1, window)
    eight, _ = window_spans(L, qlen, 8, window)

    def held(starts, lo, hi):
        return bool(((starts <= lo) & (starts + w > hi)).any())

    # a 40-column span (8 reference bases deleted from the read) that the
    # 8-shard cut holds whole and the single-device cut splits
    p = next(p for p in range(L - 40)
             if held(eight, p, p + 39) and not held(one, p, p + 39))
    frag = ref[p: p + 40]
    read = np.delete(frag, np.arange(2, 40, 5))
    assert len(read) == qlen
    q = pad_queries([read], qlen)
    exact = oracle.fill(ref, read).max_score
    assert exact >= 3 * qlen - 2 * 8
    whole = search(q, ref, mesh=mesh, window=window)
    cut = search(q, ref, mesh=None, window=window)
    assert int(whole.scores[0]) == exact
    assert int(cut.scores[0]) < exact
