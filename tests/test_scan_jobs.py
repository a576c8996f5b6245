"""The XLA scan takes over the jobs the former single-core kernel modes
did: boundary-injected block fills chained down a matrix (stripe chaining,
pipeline stages, Hirschberg and window refills), global-mode anchored
reverse passes, and batches of padded reads. Each is held to the oracle
(or a plain NumPy global-alignment reference) in linear, affine and
BLOSUM62 scoring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swtpu import Scoring
from swtpu.core import oracle
from swtpu.core.substitution import BLOSUM62, embed_sentinels
from swtpu.kernels import gpu_fill
from swtpu.kernels.scan_fill import scan_fill

NEG = -(1 << 30)
SCORINGS = {
    "linear": (Scoring(), None, 4),
    "affine": (Scoring(mode="affine", gap_open=-5, gap_extend=-1), None, 4),
    "blosum62": (Scoring(mode="affine", gap_open=-11, gap_extend=-1),
                 BLOSUM62, 20),
}


def _pair(name, m, n, seed, plant=True):
    _, _, alpha = SCORINGS[name]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, alpha, m).astype(np.int8)
    b = rng.integers(0, alpha, n).astype(np.int8)
    if plant:
        k = min(m, n) // 3
        b[n // 4:n // 4 + k] = a[m // 5:m // 5 + k]
    return a, b


def _table(sub):
    return None if sub is None else jnp.asarray(embed_sentinels(sub))


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("m,n,h", [(50, 90, 30), (64, 64, 16),
                                   (33, 120, 41)])
def test_row_block_chain_matches_oracle(name, m, n, h):
    """Fill the matrix as a chain of h-row blocks, each seeded with the
    block above's bottom row (and F row when affine): the per-block bests,
    reduced under the first-occurrence rule, give the oracle's maximum,
    position and last cell."""
    sc, sub, _ = SCORINGS[name]
    a, b = _pair(name, m, n, seed=m * n + h)
    ref = oracle.fill(a, b, sc, sub)
    top = jnp.zeros((m + 1,), jnp.int32)
    top_f = jnp.full((m + 1,), NEG, jnp.int32)
    bests = []
    for r0 in range(0, n, h):
        out = scan_fill(jnp.asarray(a), jnp.asarray(b[r0:r0 + h]),
                        scoring=sc, top_row=top,
                        top_f=top_f if sc.is_affine else None,
                        sub_table=_table(sub))
        s = int(out.max_score)
        bests.append((s, r0 + int(out.max_i), int(out.max_j)) if s > 0
                     else (0, 0, 0))
        top = out.bottom_row
        if sc.is_affine:
            top_f = out.bottom_f
        last = int(out.last_cell)
    got = tuple(int(x) for x in gpu_fill.reduce_bests(
        jnp.asarray(bests, jnp.int32)))
    assert got == (ref.max_score, *ref.max_ij)
    assert last == int(ref.H[n, m])


def nw_reference(a, b, sc, sub, top, left):
    """Plain global-mode (no zero floor) DP with injected H boundaries
    and -inf E/F boundaries; returns (max, i, j) of the first row-major
    maximum over the interior."""
    m, n = len(a), len(b)
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, :], H[:, 0] = top, left
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = (int(sub[a[j - 1], b[i - 1]]) if sub is not None
                 else (sc.match if a[j - 1] == b[i - 1] else sc.mismatch))
            if sc.is_affine:
                E[i, j] = max(H[i, j - 1] + sc.gap_open,
                              E[i, j - 1] + sc.gap_extend)
                F[i, j] = max(H[i - 1, j] + sc.gap_open,
                              F[i - 1, j] + sc.gap_extend)
                up, lf = F[i, j], E[i, j]
            else:
                up, lf = H[i - 1, j] + sc.gap, H[i, j - 1] + sc.gap
            H[i, j] = max(H[i - 1, j - 1] + s, up, lf)
    inner = H[1:, 1:]
    k = int(np.argmax(inner))
    i, j = divmod(k, m)
    return int(inner.flat[k]), i + 1, j + 1, H


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("m,n,seed", [(30, 40, 1), (45, 25, 2), (60, 60, 3)])
def test_anchored_reverse_nw_matches_reference(name, m, n, seed):
    """The locate pass's anchored reverse fill (global mode, -inf borders
    except the origin) on the scan equals a plain NumPy global DP, and
    reproduces the forward local score."""
    from swtpu.engine import traceback as tb
    sc, sub, _ = SCORINGS[name]
    a, b = _pair(name, m, n, seed=seed)
    fwd = oracle.fill(a, b, sc, sub)
    ei, ej = fwd.max_ij
    ar, br = a[:ej][::-1].copy(), b[:ei][::-1].copy()
    top = np.full((ej + 1,), NEG, np.int64)
    left = np.full((ei + 1,), NEG, np.int64)
    top[0] = left[0] = 0
    want = nw_reference(ar, br, sc, sub, top, left)[:3]
    got = tb._nw_argmax(ar, br, sc, top.astype(np.int32),
                        left.astype(np.int32), sub=sub)
    assert got == want
    assert got[0] == fwd.max_score


@pytest.mark.parametrize("name", ["linear", "affine"])
@pytest.mark.parametrize("h", [7, 16])
def test_nw_block_chain_last_row(name, h):
    """Global-mode blocks chained down the rows (the Hirschberg /
    Myers-Miller last-row passes): the final bottom row equals the
    monolithic global DP's last row."""
    sc, sub, _ = SCORINGS[name]
    a, b = _pair(name, 40, 48, seed=h)
    m, n = len(a), len(b)
    g = sc.gap if not sc.is_affine else sc.gap_open
    e = sc.gap if not sc.is_affine else sc.gap_extend
    top = np.array([0] + [g + e * (j - 1) for j in range(1, m + 1)])
    left = np.array([0] + [g + e * (i - 1) for i in range(1, n + 1)])
    H = nw_reference(a, b, sc, sub, top, left)[3]
    row = jnp.asarray(top, jnp.int32)
    row_f = jnp.full((m + 1,), NEG, jnp.int32)
    for r0 in range(0, n, h):
        out = scan_fill(jnp.asarray(a), jnp.asarray(b[r0:r0 + h]),
                        scoring=sc, local=False, top_row=row,
                        left_col=jnp.asarray(left[r0:r0 + h + 1],
                                             jnp.int32),
                        top_f=row_f if sc.is_affine else None)
        row = out.bottom_row
        if sc.is_affine:
            row_f = out.bottom_f
    np.testing.assert_array_equal(np.asarray(row), H[n])


@pytest.mark.parametrize("name", list(SCORINGS))
def test_padded_reads_batch_matches_oracle(name):
    """The database window scorer (vmapped scan) on a batch of reads
    padded with the -3 sentinel: each read's (score, read end, window
    column) equals its unpadded oracle fill — padding resets nothing and
    never wins."""
    from swtpu.dist.database import _window_scorer, pad_queries
    sc, sub, alpha = SCORINGS[name]
    rng = np.random.default_rng(11)
    window = rng.integers(0, alpha, 160).astype(np.int8)
    reads = [window[20:50].copy(), rng.integers(0, alpha, 17).astype(np.int8),
             window[100:140].copy(), window[5:9].copy()]
    reads[2][10] = (reads[2][10] + 1) % alpha          # one mismatch
    q = pad_queries(reads, 40)
    s, qi, wj = jax.jit(_window_scorer(sc, sub))(jnp.asarray(q),
                                                 jnp.asarray(window))
    for k, r in enumerate(reads):
        ref = oracle.fill(window, r, sc, sub)
        got = (int(s[k]), int(qi[k]), int(wj[k]))
        want = (ref.max_score, *ref.max_ij) if ref.max_score > 0 \
            else (0, 0, 0)
        assert got == want, k


@pytest.mark.parametrize("name", list(SCORINGS))
def test_vmapped_batch_of_pairs_matches_oracle(name):
    """batch_score's device route (vmapped scan) over same-shape pairs —
    the job of the former packed-pairs and pair-grid modes."""
    from swtpu.dist.batch import batch_score
    sc, sub, alpha = SCORINGS[name]
    rng = np.random.default_rng(21)
    aa = rng.integers(0, alpha, (6, 70)).astype(np.int8)
    bb = rng.integers(0, alpha, (6, 90)).astype(np.int8)
    bb[:, 10:40] = aa[:, 20:50]
    hits = batch_score(aa, bb, sc, plan="scan", substitution=sub)
    for k in range(6):
        ref = oracle.fill(aa[k], bb[k], sc, sub)
        assert int(hits.scores[k]) == ref.max_score, k
        assert (int(hits.max_i[k]), int(hits.max_j[k])) == ref.max_ij, k
