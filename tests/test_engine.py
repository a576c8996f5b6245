"""End-to-end engine tests: align() API, traceback, score()."""

import numpy as np

from swtpu import (
    BUILTIN_A, BUILTIN_B, BUILTIN_LAST_CELL, BUILTIN_MAX_POS,
    BUILTIN_MAX_SCORE, EngineConfig, Scoring, align, score,
)
from swtpu.core import oracle
from swtpu.core.encode import random_pair


def test_align_builtin():
    r = align(BUILTIN_A, BUILTIN_B)
    assert r.max_score == BUILTIN_MAX_SCORE
    assert r.max_pos == BUILTIN_MAX_POS
    assert r.last_cell == BUILTIN_LAST_CELL
    assert r.aligned_a == "GTT-AC"
    assert r.aligned_b == "GTTGAC"
    assert r.path[0] == BUILTIN_MAX_POS


def test_align_matrices():
    a, b = random_pair(21, 17, seed=2)
    ref = oracle.fill(a, b)
    r = align(a, b, return_matrices=True)
    np.testing.assert_array_equal(r.H, ref.H)
    np.testing.assert_array_equal(r.P, ref.P)
    assert r.max_pos == ref.max_pos


def test_score_only():
    a, b = random_pair(50, 60, seed=4)
    assert score(a, b) == oracle.fill(a, b).max_score


def test_affine_align():
    sc = Scoring(mode="affine", gap_open=-4, gap_extend=-1)
    a, b = random_pair(30, 30, seed=9)
    r = align(a, b, scoring=sc)
    assert r.max_score == oracle.fill_loop(a, b, sc).max_score


def test_banded_config():
    a, b = random_pair(32, 32, seed=1)
    cfg = EngineConfig(band=64)
    assert align(a, b, config=cfg).max_score == oracle.fill(a, b).max_score


def test_empty_alignment_score_zero():
    # all-mismatch inputs: max score can still be 0 only if no letter matches;
    # with a 4-letter alphabet that needs disjoint letters
    r = align("AAAA", "TTTT", scoring=Scoring(match=3, mismatch=-3, gap=-2))
    assert r.max_score == 0
    assert r.aligned_a is None  # no path when nothing scored


def test_score_transposes_thin_problems():
    import numpy as np
    import swtpu
    from swtpu.core.encode import random_pair

    a, b = random_pair(500, 40, seed=71)
    assert swtpu.score(a, b) == swtpu.align(a, b,
                                            traceback=False).max_score
    # asymmetric substitution table must be transposed with the operands
    rng = np.random.default_rng(5)
    S = rng.integers(-4, 6, (4, 4)).astype(np.int32)
    r1 = swtpu.score(a, b, scoring=swtpu.Scoring(gap=-2), substitution=S)
    r2 = swtpu.align(a, b, scoring=swtpu.Scoring(gap=-2), substitution=S,
                     traceback=False).max_score
    assert r1 == r2


def test_score_fast_path_matches_general(fake_gpu):
    """The device-resident score-only fast path (the GPU kernel's wrapper
    route, the kernel stood in for by the scan) must agree with the oracle
    on score, position, and last_cell."""
    import numpy as np
    import swtpu
    from swtpu.core import oracle
    from swtpu.core.encode import random_pair

    a, b = random_pair(150, 400, seed=17)
    ref = oracle.fill(a, b)
    r = swtpu.align(a, b, traceback=False, plan="wavefront")
    assert r.plan == "wavefront" and fake_gpu == [(150, 400)]
    assert r.max_score == ref.max_score
    assert (r.max_i, r.max_j) == ref.max_ij
    assert r.last_cell == int(ref.H[-1, -1])


def test_affine_traceback_stripe_plan(fake_gpu):
    """align() with affine gaps + traceback with the kernel plan forced:
    the score-only kernel hands traceback to the scan's P capture, which
    must reproduce the Gotoh oracle's score and positions and yield an
    alignment that re-scores exactly under affine rules."""
    import numpy as np
    import swtpu
    from swtpu.core import oracle
    from swtpu.core.encode import random_pair

    sc = swtpu.Scoring(mode="affine", gap_open=-6, gap_extend=-1)
    a, b = random_pair(120, 300, seed=23)
    b[40:120] = a[10:90]
    ref = oracle.fill_loop(a, b, sc)
    r = swtpu.align(a, b, scoring=sc, plan="wavefront")
    assert r.plan == "scan"
    assert r.max_score == ref.max_score
    assert (r.max_i, r.max_j) == ref.max_ij
    # affine re-score of the alignment string
    total, in_gap = 0, False
    for x, y in zip(r.aligned_a, r.aligned_b):
        if "-" in (x, y):
            total += sc.gap_extend if in_gap else sc.gap_open
            in_gap = True
        else:
            total += sc.match if x == y else sc.mismatch
            in_gap = False
    assert total == r.max_score


def test_banded_traceback_never_drops_band():
    """A banded alignment request must return the BANDED optimum even when
    the lean traceback method is selected (explicitly or via size): the
    engine routes banded traceback to the full-P path, which honors the
    band (the lean fills would silently drop it)."""
    from swtpu.core.encode import encode

    a = encode("AAAAAAAATTTT")
    b = encode("TTTTAAAAAAAA")
    unbanded = align(a, b, traceback=True)
    for method in ("windowed", "hirschberg", "auto"):
        cfg = EngineConfig(band=2, traceback_method=method)
        r = align(a, b, config=cfg, traceback=True)
        ref = align(a, b, config=EngineConfig(band=2),
                    traceback=True, plan="scan")
        assert r.max_score == ref.max_score
        assert r.max_score < unbanded.max_score
        assert (r.aligned_a, r.aligned_b) == (ref.aligned_a, ref.aligned_b)
