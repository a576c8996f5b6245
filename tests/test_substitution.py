"""Protein/BLOSUM substitution-matrix tests."""

import numpy as np

import swtpu
from swtpu.core import oracle
from swtpu.core.encode import PROTEIN_ALPHABET, encode
from swtpu.core.substitution import BLOSUM62, dna_matrix


def test_dna_matrix_equals_compare_path():
    a, b = swtpu.random_pair(40, 30, seed=1)
    ref = oracle.fill(a, b)
    via_matrix = oracle.fill(a, b, sub=dna_matrix())
    np.testing.assert_array_equal(ref.H, via_matrix.H)
    r = swtpu.align(a, b, substitution=dna_matrix())
    assert r.max_score == ref.max_score
    assert r.max_pos == ref.max_pos


def test_blosum62_protein_alignment():
    # classic example: identical peptides score the diagonal sum
    pep = "HEAGAWGHEE"
    codes = encode(pep, PROTEIN_ALPHABET)
    r = swtpu.align(codes, codes, substitution=BLOSUM62,
                    scoring=swtpu.Scoring(gap=-8),
                    alphabet=PROTEIN_ALPHABET)
    expect = int(sum(BLOSUM62[c, c] for c in codes))
    assert r.max_score == expect
    assert r.aligned_a == pep


def test_blosum62_vs_oracle_random():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 20, 50).astype(np.int8)
    b = rng.integers(0, 20, 40).astype(np.int8)
    sc = swtpu.Scoring(gap=-6)
    ref = oracle.fill(a, b, sc, sub=BLOSUM62)
    r = swtpu.align(a, b, scoring=sc, substitution=BLOSUM62,
                    alphabet=PROTEIN_ALPHABET)
    assert r.max_score == ref.max_score
    assert r.max_pos == ref.max_pos


def test_blosum62_affine():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 20, 30).astype(np.int8)
    b = rng.integers(0, 20, 30).astype(np.int8)
    sc = swtpu.Scoring(mode="affine", gap_open=-10, gap_extend=-1)
    ref = oracle.fill_loop(a, b, sc, sub=BLOSUM62)
    r = swtpu.align(a, b, scoring=sc, substitution=BLOSUM62,
                    alphabet=PROTEIN_ALPHABET)
    assert r.max_score == ref.max_score


def test_engine_substitution_stripe_plan(fake_gpu):
    """Forcing the kernel plan with traceback on a protein pair yields the
    scan's exact alignment (the kernel is score-only)."""
    import numpy as np
    import swtpu
    from swtpu.core.substitution import BLOSUM62

    rng = np.random.default_rng(9)
    pa = rng.integers(0, 20, 80).astype(np.int8)
    pb = rng.integers(0, 20, 200).astype(np.int8)
    pb[50:100] = pa[10:60]
    r_scan = swtpu.align(pa, pb, substitution=BLOSUM62, plan="scan",
                         alphabet=swtpu.core.encode.PROTEIN_ALPHABET)
    r_str = swtpu.align(pa, pb, substitution=BLOSUM62, plan="wavefront",
                        alphabet=swtpu.core.encode.PROTEIN_ALPHABET)
    assert r_str.max_score == r_scan.max_score
    assert (r_str.max_i, r_str.max_j) == (r_scan.max_i, r_scan.max_j)
    assert r_str.aligned_a == r_scan.aligned_a
    assert r_str.aligned_b == r_scan.aligned_b


def test_blosum_affine_traceback_rescore(fake_gpu):
    """Every walked BLOSUM62+affine alignment must re-score to its reported
    max (the Gotoh state-bit invariant, across both plans)."""
    import numpy as np
    import swtpu
    from swtpu.core.encode import PROTEIN_ALPHABET
    from swtpu.core.substitution import BLOSUM62

    rng = np.random.default_rng(31337)
    sc = swtpu.Scoring(mode="affine", gap_open=-11, gap_extend=-1)
    checked = 0
    for t in range(6):
        m, n = int(rng.integers(30, 120)), int(rng.integers(30, 220))
        pa = rng.integers(0, 20, m).astype(np.int8)
        pb = rng.integers(0, 20, n).astype(np.int8)
        k = min(m, n) // 2
        pb[:k] = pa[:k]
        r = swtpu.align(pa, pb, scoring=sc, substitution=BLOSUM62,
                        plan="wavefront" if t % 2 else "scan",
                        alphabet=PROTEIN_ALPHABET)
        if r.max_score == 0:
            continue
        total, in_gap = 0, False
        for x, y in zip(r.aligned_a, r.aligned_b):
            if "-" in (x, y):
                total += sc.gap_extend if in_gap else sc.gap_open
                in_gap = True
            else:
                total += int(BLOSUM62[PROTEIN_ALPHABET.index(x),
                                      PROTEIN_ALPHABET.index(y)])
                in_gap = False
        assert total == r.max_score, (t, total, r.max_score)
        checked += 1
    assert checked >= 4


def test_substitution_score_fast_path(fake_gpu):
    """The device-resident score fast path must serve substitution too
    (table embedded on device; one fetch) and match the oracle."""
    import numpy as np
    import swtpu.engine.align as al
    from swtpu.core import oracle
    from swtpu.core.encode import PROTEIN_ALPHABET
    from swtpu.core.substitution import BLOSUM62

    rng = np.random.default_rng(23)
    pa = rng.integers(0, 20, 80).astype(np.int8)
    pb = rng.integers(0, 20, 120).astype(np.int8)
    pb[20:60] = pa[10:50]
    for sc in (swtpu.Scoring(),
               swtpu.Scoring(mode="affine", gap_open=-11, gap_extend=-1)):
        ref = oracle.fill(pa, pb, sc, sub=np.asarray(BLOSUM62))
        r = al.align(pa, pb, scoring=sc, substitution=BLOSUM62,
                     traceback=False, plan="wavefront",
                     alphabet=PROTEIN_ALPHABET)
        assert r.max_score == ref.max_score, sc.mode
        assert (r.max_i, r.max_j) == ref.max_ij, sc.mode
        assert r.last_cell == int(ref.H[-1, -1]), sc.mode
    assert fake_gpu == [(80, 120)] * 2    # the fast path actually served
