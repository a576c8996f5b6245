"""The GPU wavefront kernel's wrapper (kernels/gpu_fill.py).

The CUDA kernel has no interpret mode, so the CPU tests cover everything
around it: the geometry, the sentinel padding and the substitution-table
embedding, and the cross-stripe first-occurrence reduction, fed with
per-stripe bests cut from oracle H matrices exactly as the kernel's warps
report them. The ``gpu`` tests run the kernel itself against the oracle
and the scan; they skip without a CUDA device (chip_smoke.py runs the same
checks at full size on the card). All comparisons are exact: the DP is
int32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from swtpu import Scoring
from swtpu.core import oracle
from swtpu.core.encode import random_pair
from swtpu.core.substitution import BLOSUM62, NEG_SUB, embed_sentinels
from swtpu.kernels import gpu_fill
from swtpu.kernels.scan_fill import diag_to_rowmajor, scan_fill

AFF = Scoring(mode="affine", gap_open=-4, gap_extend=-1)
BLOSUM_AFF = Scoring(mode="affine", gap_open=-11, gap_extend=-1)


# --- geometry ---------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(1, 1), (5, 40), (32, 32), (33, 129),
                                 (1000, 513), (8192, 8192), (25632, 25632),
                                 (65536, 16384), (2000, 145002)])
def test_geometry_covers_the_matrix(m, n):
    g = gpu_fill.geometry(m, n)
    assert g.R in gpu_fill.ROWS_PER_LANE
    assert g.stripes == -(-n // (32 * g.R))
    assert g.rows_pad == g.stripes * 32 * g.R >= n
    assert g.rows_pad - n < 32 * g.R           # no empty stripe
    assert g.mpad % 32 == 0 and 0 <= g.mpad - m < 32
    # the boundary ring: two rows suffice, one when there is one stripe
    assert g.slots == min(g.stripes, gpu_fill.RING_SLOTS)
    assert g.slots >= 2 or g.stripes == 1


@pytest.mark.parametrize("m,n,R", [(25632, 25632, 4), (8192, 8192, 4)])
def test_geometry_picks_the_measured_winner(m, n, R):
    """The cost model reproduces the rows-per-lane that won on the card
    at the benchmark sizes."""
    assert gpu_fill.geometry(m, n).R == R


def test_geometry_rejects_bad_requests():
    with pytest.raises(ValueError, match="empty"):
        gpu_fill.geometry(0, 10)
    with pytest.raises(ValueError, match="rows_per_lane"):
        gpu_fill.geometry(10, 10, rows_per_lane=6)
    assert gpu_fill.geometry(10, 10, rows_per_lane=16).R == 16


def test_modeled_steps():
    """One stripe sweeps m + 31 steps; each further stripe starts
    STRIPE_LAG steps later — more rows per lane, fewer stripes."""
    assert gpu_fill.modeled_steps(100, 32, 4) == 100 + 31
    s4 = gpu_fill.modeled_steps(25632, 25632, 4)
    s16 = gpu_fill.modeled_steps(25632, 25632, 16)
    assert s4 - s16 == (201 - 51) * gpu_fill.STRIPE_LAG


# --- input preparation --------------------------------------------------------


@pytest.mark.parametrize("m,n", [(1, 1), (31, 33), (64, 300)])
def test_prepare_inputs_pads_with_distinct_sentinels(m, n):
    a, b = random_pair(m, n, seed=m * n)
    g = gpu_fill.geometry(m, n)
    ap, bp = gpu_fill.prepare_inputs(jnp.asarray(a), jnp.asarray(b), g)
    ap, bp = np.asarray(ap), np.asarray(bp)
    assert ap.dtype == np.int8 and bp.dtype == np.int8
    assert ap.shape == (g.mpad,) and bp.shape == (g.rows_pad,)
    np.testing.assert_array_equal(ap[:m], a)
    np.testing.assert_array_equal(bp[:n], b)
    assert (ap[m:] == -1).all() and (bp[n:] == -2).all()


def test_prepare_inputs_maps_out_of_table_codes_to_sentinel():
    """With a substitution table, codes outside [-3, A) score as padding
    instead of indexing outside the table."""
    a = np.array([0, 25, 3, -7, -1], np.int8)
    b = np.array([19, 20, -2, 5], np.int8)
    g = gpu_fill.geometry(len(a), len(b))
    ap, bp = gpu_fill.prepare_inputs(a, b, g, nsym=20)
    np.testing.assert_array_equal(np.asarray(ap)[:5], [0, -3, 3, -3, -1])
    np.testing.assert_array_equal(np.asarray(bp)[:4], [19, -3, -2, 5])
    # without a table (match/mismatch mode) codes pass through
    ap, _ = gpu_fill.prepare_inputs(a, b, g)
    np.testing.assert_array_equal(np.asarray(ap)[:5], a)


@pytest.mark.parametrize("sub", [BLOSUM62, np.arange(16).reshape(4, 4) - 8])
def test_kernel_table_indexing(sub):
    """table[(a+3)*(A+3) + (b+3)] == S[a, b]; every sentinel row and
    column scores NEG_SUB — the scan's own embedding, flattened."""
    sub = np.asarray(sub, np.int32)
    A = sub.shape[0]
    t = gpu_fill.kernel_table(sub)
    assert t.shape == ((A + 3) ** 2,) and t.dtype == np.int32
    np.testing.assert_array_equal(t, embed_sentinels(sub).reshape(-1))
    for x in range(-3, A):
        for y in range(-3, A):
            want = sub[x, y] if x >= 0 and y >= 0 else NEG_SUB
            assert t[(x + 3) * (A + 3) + (y + 3)] == want
    assert gpu_fill.kernel_table(None).shape == (1,)


@pytest.mark.parametrize("sc,sub,alpha", [(Scoring(), None, 4),
                                          (AFF, None, 4),
                                          (BLOSUM_AFF, BLOSUM62, 20)])
def test_padded_inputs_leave_the_real_region_exact(sc, sub, alpha):
    """The kernel fills the padded (rows_pad x mpad) matrix; padding sits
    right of and below the real cells, so the real region of the padded
    fill is the unpadded oracle matrix, cell for cell."""
    rng = np.random.default_rng(5)
    m, n = 37, 70
    a = rng.integers(0, alpha, m).astype(np.int8)
    b = rng.integers(0, alpha, n).astype(np.int8)
    g = gpu_fill.geometry(m, n)
    ap, bp = gpu_fill.prepare_inputs(a, b, g, 0 if sub is None else 20)
    table = None if sub is None else jnp.asarray(embed_sentinels(sub))
    out = scan_fill(ap, bp, scoring=sc, return_h=True, sub_table=table)
    H = diag_to_rowmajor(out.h_diag, g.rows_pad, g.mpad)
    ref = oracle.fill(a, b, sc, sub)
    np.testing.assert_array_equal(H[:n + 1, :m + 1], ref.H)


def test_gap_params():
    assert gpu_fill._gap_params(Scoring(gap=-5)) == (-5, 0)
    assert gpu_fill._gap_params(AFF) == (-4, -1)


# --- the cross-stripe reduction ---------------------------------------------------


def stripe_bests(H: np.ndarray, geom, n: int, m: int) -> np.ndarray:
    """(S, 3) per-stripe (score, i, j) as the kernel's warps report them:
    each stripe's first row-major maximum over its real rows and columns,
    (0, 0, 0) when nothing scores above zero."""
    rows = 32 * geom.R
    out = np.zeros((geom.stripes, 3), np.int32)
    for s in range(geom.stripes):
        lo, hi = s * rows + 1, min((s + 1) * rows, n)
        if lo > hi:
            continue
        blk = H[lo:hi + 1, 1:m + 1]
        k = int(np.argmax(blk))
        top = int(blk.flat[k])
        if top > 0:
            r, c = divmod(k, m)
            out[s] = (top, lo + r, 1 + c)
    return out


def _case(kind, m, n, seed):
    if kind == "random":
        return random_pair(m, n, seed=seed)
    if kind == "zeros":              # every diagonal ties
        return np.zeros(m, np.int8), np.zeros(n, np.int8)
    if kind == "periodic":           # ties across stripes and columns
        return (np.tile(np.int8([0, 1]), -(-m // 2))[:m],
                np.tile(np.int8([0, 1]), -(-n // 2))[:n])
    if kind == "planted":            # the same maximum in several stripes
        a, b = random_pair(m, n, seed=seed)
        blk = a[:24].copy()
        for r0 in range(0, n - 24, 150):
            b[r0:r0 + 24] = blk
        return a, b
    raise ValueError(kind)


@pytest.mark.parametrize("R", [4, 8, 16])
@pytest.mark.parametrize("kind", ["random", "zeros", "periodic", "planted"])
@pytest.mark.parametrize("m,n", [(40, 600), (300, 257)])
def test_reduce_bests_first_occurrence(R, kind, m, n):
    """Per-stripe bests cut from the oracle's H reduce to the oracle's
    global first-occurrence maximum, for every stripe geometry."""
    a, b = _case(kind, m, n, seed=m + n + R)
    ref = oracle.fill(a, b)
    g = gpu_fill.geometry(m, n, rows_per_lane=R)
    bests = stripe_bests(ref.H, g, n, m)
    s, i, j = (int(x) for x in gpu_fill.reduce_bests(jnp.asarray(bests)))
    assert s == ref.max_score
    assert (i, j) == (ref.max_ij if ref.max_score > 0 else (0, 0))


def test_reduce_bests_tie_rules():
    """Highest score, then smallest row, then smallest column; an all-zero
    matrix reports (0, 0, 0)."""
    red = lambda x: tuple(int(v) for v in gpu_fill.reduce_bests(
        jnp.asarray(x, jnp.int32)))
    assert red([[5, 40, 2], [5, 33, 9], [5, 33, 4], [3, 1, 1]]) == (5, 33, 4)
    assert red([[0, 0, 0], [0, 0, 0]]) == (0, 0, 0)
    assert red([[7, 900, 3]]) == (7, 900, 3)
    assert red([[2, 10, 10], [9, 500, 1], [9, 500, 1]]) == (9, 500, 1)


# --- build ------------------------------------------------------------------------


def test_library_path_tracks_the_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(gpu_fill, "SOURCE", src)
    monkeypatch.setattr(gpu_fill, "BUILD_DIR", tmp_path / "build")
    p1 = gpu_fill.library_path()
    src.write_text("// v2\n")
    p2 = gpu_fill.library_path()
    assert p1 != p2 and p1.parent == tmp_path / "build"


def test_build_reuses_an_existing_library(tmp_path, monkeypatch):
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(gpu_fill, "library_path", lambda: lib)
    monkeypatch.setattr(gpu_fill, "_nvcc", lambda: None)   # never called
    assert gpu_fill.build() == lib


def test_score_fn_raises_when_the_kernel_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setattr(gpu_fill, "_state",
                        {"lib": None, "registered": False, "build_s": None})
    monkeypatch.setattr(gpu_fill, "_nvcc", lambda: None)
    monkeypatch.setattr(gpu_fill, "library_path",
                        lambda: tmp_path / "absent.so")
    gpu_fill._score_fn.cache_clear()
    with pytest.raises(gpu_fill.KernelBuildError, match="nvcc"):
        gpu_fill.score_fn(64, 64)


# --- on the card ------------------------------------------------------------------


def _expect(a, b, sc, sub):
    o = oracle.fill(a, b, sc, sub)
    return (o.max_score, *o.max_ij, int(o.H[len(b), len(a)]))


@pytest.mark.gpu
@pytest.mark.parametrize("sc,sub,alpha", [(Scoring(), None, 4),
                                          (AFF, None, 4),
                                          (BLOSUM_AFF, BLOSUM62, 20)])
@pytest.mark.parametrize("m,n", [(1, 1), (31, 33), (200, 77), (129, 300)])
def test_kernel_matches_oracle(gpu, sc, sub, alpha, m, n):
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.integers(0, alpha, m).astype(np.int8)
    b = rng.integers(0, alpha, n).astype(np.int8)
    for R in gpu_fill.ROWS_PER_LANE:
        fn = gpu_fill.score_fn(m, n, sc, sub, rows_per_lane=R)
        got = tuple(int(x) for x in fn(jnp.asarray(a), jnp.asarray(b)))
        assert got == _expect(a, b, sc, sub), R


@pytest.mark.gpu
@pytest.mark.parametrize("sc,sub,alpha", [(Scoring(), None, 4),
                                          (BLOSUM_AFF, BLOSUM62, 20)])
def test_kernel_matches_scan(gpu, sc, sub, alpha):
    rng = np.random.default_rng(9)
    m, n = 3000, 2500
    a = rng.integers(0, alpha, m).astype(np.int8)
    b = rng.integers(0, alpha, n).astype(np.int8)
    table = None if sub is None else jnp.asarray(embed_sentinels(sub))
    out = scan_fill(jnp.asarray(a), jnp.asarray(b), scoring=sc,
                    sub_table=table)
    want = (int(out.max_score), int(out.max_i), int(out.max_j),
            int(out.last_cell))
    fn = gpu_fill.score_fn(m, n, sc, sub)
    assert tuple(int(x) for x in fn(jnp.asarray(a), jnp.asarray(b))) == want
