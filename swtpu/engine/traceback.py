"""Memory-lean traceback for huge matrices: locate + windowed refill +
Hirschberg / Myers-Miller divide-and-conquer.

The reference keeps the full O(mn) predecessor matrix and walks it on the
host (serial_smithW.c:262-277); its memory-lean rotated family simply leaves
traceback unimplemented (rotated-cuda/sw-rotated.cu:286-319 is a TODO stub).
This module closes that gap:

1. `locate()` — forward score pass finds the alignment END; a second score
   pass on the reversed clipped prefixes finds the START (the classic
   reverse-SW trick). O(1) extra memory.
2. `windowed()` — if the located window fits a budget, refill just the
   window with predecessors and walk it. O(window) memory.
3. `hirschberg()` — otherwise, global-align the located substrings in
   O(m+n) memory via divide-and-conquer, with the row-splitting passes
   running the device NW fill (`scan_fill(local=False)`) and only the
   O(small) base cases materializing matrices. Affine gaps use the full
   Myers-Miller state split (forward/reverse H AND F last rows, border
   gap-open flags so a vertical gap crossing a split is charged one open).

All three support linear and affine (Gotoh) gaps and arbitrary substitution
matrices (BLOSUM/PAM) — capability extensions over the linear-only
reference (serial_smithW.c:61).

Note on parity: full-P traceback (the default engine path) reproduces the
reference's tie-breaking exactly. The linear-space paths return an optimal
alignment with the same score; on ties the path may differ (standard for
Hirschberg-style methods).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import (DIAGONAL, E_EXT, F_EXT, LEFT, NONE, UP,
                           EngineConfig, Scoring)
from ..core.encode import DNA_ALPHABET
from ..kernels.scan_fill import diag_to_rowmajor, scan_fill

_NEG = -(1 << 30)


def _device_resident() -> bool:
    """P matrices stay on an accelerator and are walked there; on the CPU
    platform the host walk reads them in place."""
    from ..dispatch.plan import capability
    return capability().platform != "cpu"


def _sub_table(sub):
    """Raw (A, A) substitution matrix -> embedded jnp (A+3, A+3) table for
    scan_fill (sentinel codes -1/-2/-3 score NEG_SUB)."""
    if sub is None:
        return None
    from ..core.substitution import embed_sentinels
    return jnp.asarray(embed_sentinels(np.asarray(sub)))


def _local_score(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub=None):
    """Score-only forward pass: (max_score, max_i, max_j, last_cell), on
    the device plan dispatch picks for a score-only fill of this shape
    (the GPU kernel where it can run, else the scan)."""
    from ..dispatch.plan import choose_exec
    m, n = len(a), len(b)
    cfg = EngineConfig(host_max_cells=0, traceback=False)
    if choose_exec(m, n, cfg, scoring, sub).plan == "wavefront":
        from ..kernels import gpu_fill
        fn = gpu_fill.score_fn(m, n, scoring, sub)
        s, i, j, last = fn(jnp.asarray(a), jnp.asarray(b))
        return int(s), int(i), int(j), int(last)
    out = scan_fill(jnp.asarray(a), jnp.asarray(b), scoring=scoring,
                    sub_table=_sub_table(sub))
    return (int(out.max_score), int(out.max_i), int(out.max_j),
            int(out.last_cell))


def _nw_argmax(a: np.ndarray, b: np.ndarray, scoring: Scoring,
               top: np.ndarray, left: np.ndarray, sub=None):
    """Global-mode fill with injected boundaries; returns
    (max_score, max_i, max_j). Used by the anchored reverse pass, whose
    max is guaranteed positive."""
    out = scan_fill(jnp.asarray(a), jnp.asarray(b), scoring=scoring,
                    local=False, top_row=jnp.asarray(top),
                    left_col=jnp.asarray(left), sub_table=_sub_table(sub))
    return int(out.max_score), int(out.max_i), int(out.max_j)


class AnchoredReverseMismatch(RuntimeError):
    """The anchored reverse pass did not reproduce the forward score.

    The locate trick's precondition: an optimal LOCAL alignment starts and
    ends in the H state, so a global-mode reverse DP anchored at the
    forward end cell must reach exactly the forward score. A mismatch
    means the scoring model violates that contract (e.g. a non-negative
    gap/mismatch making terminal gaps free) or an internal inconsistency
    between the forward and reverse fills. Unlike the reference's
    fail-fast asserts (simple-cuda/cuda_global_mem_smithW.cu:90-96), this
    carries the evidence and survives ``python -O``.
    """

    def __init__(self, forward_score: int, reverse_score: int,
                 end_i: int, end_j: int, last_cell: int = 0):
        self.forward_score = int(forward_score)
        self.reverse_score = int(reverse_score)
        self.end_i = int(end_i)
        self.end_j = int(end_j)
        self.last_cell = int(last_cell)
        super().__init__(
            f"anchored reverse pass scored {reverse_score} but the forward "
            f"pass found {forward_score} ending at ({end_i}, {end_j}); the "
            f"locate contract requires negative gap/mismatch penalties so "
            f"optimal local alignments start and end in the H state")


class Located(NamedTuple):
    score: int
    start_i: int     # first aligned row (1-based, padded coords)
    start_j: int
    end_i: int       # last aligned row
    end_j: int
    last_cell: int = 0   # H[n, m] (the reference's H[m*n-1] invariant)


def locate(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
           sub=None) -> Optional[Located]:
    """Find score + start/end cells of the optimal local alignment with two
    score-only passes (no P matrix). Linear/affine, optional substitution."""
    score, ei, ej, last = _local_score(a, b, scoring, sub=sub)
    if score <= 0:
        return None
    # Anchored reverse pass over the clipped reversed prefixes: global-mode
    # DP with -inf boundaries (except the origin) scores only paths that
    # START at the forward end cell, so its argmax is the true START of a
    # path ending exactly at (ei, ej). A plain reverse SW would be wrong:
    # its zero floor lets it pick a different equal-scoring path whose end
    # is elsewhere, breaking the window extraction. (Affine: an optimal
    # local alignment starts and ends in the H state — trimming a terminal
    # gap always raises the score — so reversing the Gotoh recurrence with
    # default -inf E/F boundaries scores exactly the reversed paths.)
    ar = a[:ej][::-1].copy()
    br = b[:ei][::-1].copy()
    subr = None if sub is None else np.asarray(sub)   # lookup is symmetric
    top = np.full((ej + 1,), _NEG, np.int32)
    left = np.full((ei + 1,), _NEG, np.int32)
    top[0] = left[0] = 0
    rs, ri, rj = _nw_argmax(ar, br, scoring, top, left, sub=subr)
    if rs != score:
        raise AnchoredReverseMismatch(score, rs, ei, ej, last)
    si = ei - ri + 1
    sj = ej - rj + 1
    return Located(score, si, sj, ei, ej, last)


# ---------------------------------------------------------------------------
# Dense host base cases


def _score_fn(a, b, scoring, sub):
    if sub is not None:
        sm = np.asarray(sub, np.int64)
        return sm[a[None, :], b[:, None]]       # (n, m): s[b_i, a_j]
    return np.where(b[:, None] == a[None, :], scoring.match,
                    scoring.mismatch).astype(np.int64)


def _nw_host(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub=None):
    """Small dense global alignment on host; returns (codes_a, codes_b).
    Base case of the linear Hirschberg recursion."""
    m, n = len(a), len(b)
    g = scoring.gap
    H = np.zeros((n + 1, m + 1), np.int64)
    H[0, :] = g * np.arange(m + 1)
    H[:, 0] = g * np.arange(n + 1)
    P = np.zeros((n + 1, m + 1), np.int8)
    P[0, 1:] = LEFT
    P[1:, 0] = UP
    smat = _score_fn(a, b, scoring, sub)
    # anti-diagonal vectorized NW fill (same wavefront trick as oracle.fill,
    # without the zero floor)
    for d in range(2, n + m + 1):
        i_lo, i_hi = max(1, d - m), min(n, d - 1)
        if i_lo > i_hi:
            continue
        ii = np.arange(i_lo, i_hi + 1)
        jj = d - ii
        diag = H[ii - 1, jj - 1] + smat[ii - 1, jj - 1]
        up = H[ii - 1, jj] + g
        left = H[ii, jj - 1] + g
        best = np.maximum(np.maximum(diag, up), left)
        pred = np.where(diag == best, DIAGONAL,
                        np.where(up == best, UP, LEFT)).astype(np.int8)
        H[ii, jj] = best
        P[ii, jj] = pred
    # walk from (n, m) to (0, 0)
    out_a, out_b = [], []
    i, j = n, m
    while i > 0 or j > 0:
        code = P[i, j]
        if code == DIAGONAL:
            out_a.append(a[j - 1]); out_b.append(b[i - 1]); i -= 1; j -= 1
        elif code == UP:
            out_a.append(-1); out_b.append(b[i - 1]); i -= 1
        else:
            out_a.append(a[j - 1]); out_b.append(-1); j -= 1
    return out_a[::-1], out_b[::-1]


def _nw_host_affine(a, b, scoring: Scoring, tbg: int, teg: int, sub=None):
    """Dense global Gotoh alignment with Myers-Miller border gap-open
    parts: a vertical gap that starts at the top border (down column 0)
    opens with g-part ``tbg``, one that ends at the bottom-right corner
    with ``teg`` (0 = the gap continues across the border and was already
    opened there; g0 = open - extend = normal). Returns (codes_a, codes_b).
    """
    m, n = len(a), len(b)
    op, ext = scoring.gap_open, scoring.gap_extend
    g0 = op - ext
    if m == 0:
        return [-1] * n, list(b)
    if n == 0:
        return list(a), [-1] * m
    NEG = np.int64(_NEG)
    H = np.empty((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, 0] = 0
    H[0, 1:] = g0 + ext * np.arange(1, m + 1)
    H[1:, 0] = tbg + ext * np.arange(1, n + 1)
    F[1:, 0] = H[1:, 0]                     # column-0 gap IS the F state
    smat = _score_fn(a, b, scoring, sub)
    for i in range(1, n + 1):
        Ei = NEG
        for j in range(1, m + 1):
            Ei = max(H[i, j - 1] + op, Ei + ext)
            # teg discounts ONLY the final corner gap: any used vertical
            # gap in column m necessarily runs to row n (from (i, m) the
            # path can only continue down), so discounting opens in
            # column m == discounting the gap glued across the bottom
            # border at the crossing column. A row-n gap at j < m does
            # NOT continue below and must pay the normal open.
            fo = teg + ext if j == m else op
            F[i, j] = max(H[i - 1, j] + fo, F[i - 1, j] + ext)
            E[i, j] = Ei
            H[i, j] = max(H[i - 1, j - 1] + smat[i - 1, j - 1],
                          max(Ei, F[i, j]))
    # walk with the Gotoh state machine
    out_a, out_b = [], []
    i, j = n, m
    state = 0
    while i > 0 or j > 0:
        if j == 0:
            out_a.append(-1); out_b.append(b[i - 1]); i -= 1
            continue
        if i == 0:
            out_a.append(a[j - 1]); out_b.append(-1); j -= 1
            continue
        if state == UP:
            out_a.append(-1); out_b.append(b[i - 1])
            fo = teg + ext if j == m else op
            if F[i, j] != H[i - 1, j] + fo:   # extension continues
                state = UP
            else:
                state = 0
            i -= 1
            continue
        if state == LEFT:
            out_a.append(a[j - 1]); out_b.append(-1)
            if E[i, j] != H[i, j - 1] + op:
                state = LEFT
            else:
                state = 0
            j -= 1
            continue
        h = H[i, j]
        if h == H[i - 1, j - 1] + smat[i - 1, j - 1]:
            out_a.append(a[j - 1]); out_b.append(b[i - 1]); i -= 1; j -= 1
        elif h == F[i, j]:
            state = UP
        else:
            state = LEFT
    return out_a[::-1], out_b[::-1]


# ---------------------------------------------------------------------------
# Device last-row passes


def _bucket(m: int) -> int:
    """Power-of-two query padding: the recursion's arbitrary split widths
    reuse ~log2(m) compiled shapes instead of one per node. NW values at
    columns <= m are unaffected by sentinel-padded columns to their right
    (the DP flows left to right), so padding is exact."""
    return max(16, 1 << (m - 1).bit_length())


def _nw_last_row(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                 sub=None) -> np.ndarray:
    """Last row of the linear global DP via the device fill. O(m) output."""
    m, n = len(a), len(b)
    if n == 0:
        return scoring.gap * np.arange(m + 1)
    g = scoring.gap
    mp = _bucket(m)
    a_pad = np.full((mp,), -1, np.int8)
    a_pad[:m] = a
    top = (g * np.arange(mp + 1)).astype(np.int32)
    left = (g * np.arange(n + 1)).astype(np.int32)
    out = scan_fill(jnp.asarray(a_pad), jnp.asarray(b), scoring=scoring,
                    local=False, top_row=jnp.asarray(top),
                    left_col=jnp.asarray(left), sub_table=_sub_table(sub))
    return np.asarray(out.bottom_row[:m + 1]).astype(np.int64)


def _nw_last_rows_affine(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                         tbg: int, sub=None):
    """(H_last, F_last) of the global Gotoh DP of a x b with left-border
    gap-open part ``tbg`` — the Myers-Miller forward/reverse pass, run on
    device via scan_fill(local=False). Both are int64 (m+1,) arrays;
    F_last[0] is the column-0 boundary gap value."""
    m, n = len(a), len(b)
    op, ext = scoring.gap_open, scoring.gap_extend
    g0 = op - ext
    if n == 0:
        H = np.empty((m + 1,), np.int64)
        H[0] = 0
        H[1:] = g0 + ext * np.arange(1, m + 1)
        return H, np.full((m + 1,), _NEG, np.int64)
    mp = _bucket(m)
    a_pad = np.full((mp,), -1, np.int8)
    a_pad[:m] = a
    top = np.empty((mp + 1,), np.int32)
    top[0] = 0
    top[1:] = g0 + ext * np.arange(1, mp + 1)
    left = (tbg + ext * np.arange(n + 1)).astype(np.int32)
    left[0] = 0
    out = scan_fill(jnp.asarray(a_pad), jnp.asarray(b),
                    scoring=scoring, local=False,
                    top_row=jnp.asarray(top),
                    left_col=jnp.asarray(left),
                    sub_table=_sub_table(sub))
    H = np.asarray(out.bottom_row[:m + 1]).astype(np.int64)
    F = np.asarray(out.bottom_f[:m + 1]).astype(np.int64)
    F[0] = left[n]          # the column-0 boundary gap is an F state
    return H, F


_BASE_CELLS = 1 << 18


def _hirschberg(a: np.ndarray, b: np.ndarray, scoring: Scoring, sub=None):
    m, n = len(a), len(b)
    if m == 0:
        return [-1] * n, list(b)
    if n == 0:
        return list(a), [-1] * m
    if (m + 1) * (n + 1) <= _BASE_CELLS or n == 1:
        return _nw_host(a, b, scoring, sub=sub)
    half = n // 2
    top = _nw_last_row(a, b[:half], scoring, sub=sub)
    bot = _nw_last_row(a[::-1].copy(), b[half:][::-1].copy(), scoring,
                       sub=sub)[::-1]
    split = int(np.argmax(top + bot))
    a1, b1 = _hirschberg(a[:split], b[:half], scoring, sub=sub)
    a2, b2 = _hirschberg(a[split:], b[half:], scoring, sub=sub)
    return a1 + a2, b1 + b2


def _mm_affine(a: np.ndarray, b: np.ndarray, scoring: Scoring,
               tbg: int, teg: int, sub=None):
    """Myers-Miller affine divide-and-conquer (Myers & Miller 1988,
    'Optimal alignments in linear space'): split b (rows) at half; the
    crossing is either an H-state cell (type 1) or a vertical gap spanning
    the split (type 2, joined with a single gap-open: DD + SS - g0).
    ``tbg``/``teg`` are the g-parts charged to gaps touching the top /
    bottom borders (0 when the gap continues across a type-2 split)."""
    m, n = len(a), len(b)
    op, ext = scoring.gap_open, scoring.gap_extend
    g0 = op - ext
    if m == 0 or n <= 2 or (m + 1) * (n + 1) <= _BASE_CELLS:
        return _nw_host_affine(a, b, scoring, tbg, teg, sub=sub)
    half = n // 2
    CC, DD = _nw_last_rows_affine(a, b[:half], scoring, tbg, sub=sub)
    subr = None if sub is None else np.asarray(sub)
    RRr, SSr = _nw_last_rows_affine(a[::-1].copy(),
                                    b[half:][::-1].copy(), scoring, teg,
                                    sub=subr)
    RR, SS = RRr[::-1], SSr[::-1]
    t1 = CC + RR
    t2 = DD + SS - g0
    j1, j2 = int(np.argmax(t1)), int(np.argmax(t2))
    if t1[j1] >= t2[j2]:
        j = j1
        a1, b1 = _mm_affine(a[:j], b[:half], scoring, tbg, g0, sub=sub)
        a2, b2 = _mm_affine(a[j:], b[half:], scoring, g0, teg, sub=sub)
        return a1 + a2, b1 + b2
    # type 2: rows half and half+1 are inside one vertical gap; emit them
    # explicitly and tell both halves their border gap is already open
    j = j2
    a1, b1 = _mm_affine(a[:j], b[:half - 1], scoring, tbg, 0, sub=sub)
    a2, b2 = _mm_affine(a[j:], b[half + 1:], scoring, 0, teg, sub=sub)
    mid_a = [-1, -1]
    mid_b = [b[half - 1], b[half]]
    return a1 + mid_a + a2, b1 + mid_b + b2


def _render(codes_a, codes_b, alphabet=DNA_ALPHABET):
    ra = "".join("-" if c == -1 else alphabet[c] for c in codes_a)
    rb = "".join("-" if c == -1 else alphabet[c] for c in codes_b)
    return ra, rb


def hirschberg(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
               loc: Optional[Located] = None,
               alphabet: str = DNA_ALPHABET, sub=None):
    """O(m+n)-memory optimal local alignment. Returns (score, Located,
    aligned_a, aligned_b) or None if nothing scores above 0.

    Linear gaps use classic Hirschberg; affine gaps the full Myers-Miller
    state split (type-2 vertical-gap crossings charged one open). ``sub``:
    optional substitution matrix. ``loc``: optional precomputed Located
    (e.g. from the multi-chip pipeline locate) — skips the score passes.
    """
    if loc is None:
        loc = locate(a, b, scoring, sub=sub)
    if loc is None:
        return None
    sub_a = np.asarray(a[loc.start_j - 1: loc.end_j])
    sub_b = np.asarray(b[loc.start_i - 1: loc.end_i])
    if scoring.is_affine:
        g0 = scoring.gap_open - scoring.gap_extend
        ca, cb = _mm_affine(sub_a, sub_b, scoring, g0, g0, sub=sub)
    else:
        ca, cb = _hirschberg(sub_a, sub_b, scoring, sub=sub)
    ra, rb = _render(ca, cb, alphabet)
    return loc.score, loc, ra, rb


@functools.partial(jax.jit, static_argnames=("wn", "wm"))
def _walk_diag(p_diag, *, wn: int, wm: int):
    """On-device predecessor walk over the scan's diagonal-major P (cell
    (i, j) at [i + j - 2, i - 1]) from the window's bottom-right corner,
    with the full Gotoh state machine for affine P. Only the O(path) move
    sequence leaves the device, never the O(window) P matrix. Returns
    (moves written, moves); a written NONE ends the walk at the local
    start (the zero floor)."""
    cap = wn + wm

    def body(carry):
        i, j, state, pos, moves = carry
        code = p_diag[i + j - 2, i - 1]
        base = code & 3
        move = jnp.where(state != 0, state, base).astype(jnp.int8)
        # an UP/LEFT move stays in the F/E run while the extension bit
        # says the gap continues
        new_state = jnp.where(
            (move == UP) & ((code & F_EXT) != 0), jnp.int32(UP),
            jnp.where((move == LEFT) & ((code & E_EXT) != 0),
                      jnp.int32(LEFT), jnp.int32(0)))
        moves = moves.at[pos].set(move)
        di = jnp.where((move == DIAGONAL) | (move == UP), 1, 0)
        dj = jnp.where((move == DIAGONAL) | (move == LEFT), 1, 0)
        return i - di, j - dj, new_state, pos + 1, moves

    def cond(carry):
        i, j, state, pos, moves = carry
        moved = (pos == 0) | (moves[pos - 1] != NONE)
        return (i > 0) & (j > 0) & moved & (pos < cap)

    moves0 = jnp.full((cap,), jnp.int8(NONE))
    _, _, _, pos, moves = lax.while_loop(
        cond, body, (jnp.int32(wn), jnp.int32(wm), jnp.int32(0),
                     jnp.int32(0), moves0))
    return pos, moves


def _device_window_walk(sub_a, sub_b, wn, wm, scoring, sub=None):
    """LOCAL scan refill with P capture, walked on the device."""
    out = scan_fill(jnp.asarray(sub_a), jnp.asarray(sub_b), scoring=scoring,
                    return_p=True, sub_table=_sub_table(sub))
    pos, moves = _walk_diag(out.p_diag, wn=wn, wm=wm)
    npos = int(pos)
    mvs = np.asarray(moves)[:npos]
    if npos and mvs[-1] == NONE:
        mvs = mvs[:-1]
    return _apply_moves(sub_a, sub_b, wn, wm, mvs)


def _apply_moves(sub_a, sub_b, wn, wm, moves):
    """End-first move sequence -> (codes_a, codes_b) from the corner."""
    out_a, out_b = [], []
    i, j = wn, wm
    for move in moves:
        if move == DIAGONAL:
            out_a.append(sub_a[j - 1]); out_b.append(sub_b[i - 1])
            i -= 1; j -= 1
        elif move == UP:
            out_a.append(-1); out_b.append(sub_b[i - 1]); i -= 1
        else:
            out_a.append(sub_a[j - 1]); out_b.append(-1); j -= 1
    return out_a[::-1], out_b[::-1]


def _scan_window_walk(sub_a, sub_b, wn, wm, scoring, sub=None):
    """Portable window walk: LOCAL scan refill with P capture, host walk
    with the Gotoh state machine (linear P has no state bits; the same
    walk covers both)."""
    out = scan_fill(jnp.asarray(sub_a), jnp.asarray(sub_b), scoring=scoring,
                    return_p=True, sub_table=_sub_table(sub))
    P = diag_to_rowmajor(out.p_diag, wn, wm)
    moves = []
    i, j, state = wn, wm, 0
    while i > 0 and j > 0:
        code = int(P[i, j])
        base = code & 3
        move = state if state else base
        if move == NONE:
            break
        moves.append(move)
        if move == UP:
            state = UP if (code & F_EXT) else 0
            i -= 1
        elif move == LEFT:
            state = LEFT if (code & E_EXT) else 0
            j -= 1
        else:
            state = 0
            i -= 1
            j -= 1
    return _apply_moves(sub_a, sub_b, wn, wm, moves)


def walk_from_end(a: np.ndarray, b: np.ndarray, scoring: Scoring,
                  score: int, end_i: int, end_j: int, last_cell: int = 0,
                  alphabet: str = DNA_ALPHABET, sub=None):
    """Full-P fallback when the anchored reverse pass is unavailable: refill
    [1..end_i] x [1..end_j] with predecessors and walk from the end cell
    (the zero-floor NONE stop finds the start without a reverse pass).
    O(end_i * end_j) memory — the caller gates on the window budget."""
    sub_a = np.asarray(a[:end_j])
    sub_b = np.asarray(b[:end_i])
    if _device_resident():
        ca, cb = _device_window_walk(sub_a, sub_b, end_i, end_j, scoring,
                                     sub=sub)
    else:
        ca, cb = _scan_window_walk(sub_a, sub_b, end_i, end_j, scoring,
                                   sub=sub)
    si = end_i - sum(1 for c in cb if c != -1) + 1
    sj = end_j - sum(1 for c in ca if c != -1) + 1
    loc = Located(int(score), si, sj, end_i, end_j, int(last_cell))
    ra, rb = _render(ca, cb, alphabet)
    return loc.score, loc, ra, rb


def windowed(a: np.ndarray, b: np.ndarray, scoring: Scoring = Scoring(),
             max_window_cells: Optional[int] = None,
             loc: Optional[Located] = None,
             alphabet: str = DNA_ALPHABET, sub=None):
    """Locate, then refill only the alignment window with predecessors and
    walk it. Falls back to hirschberg() when the window exceeds the budget.
    Linear/affine, optional substitution matrix.
    ``loc``: optional precomputed Located (skips the score passes).

    If the anchored reverse pass inside locate() fails its contract
    (AnchoredReverseMismatch), the full-P end-anchored walk recovers the
    alignment when [1..end] fits the window budget; the typed error
    propagates otherwise."""
    if loc is None:
        try:
            loc = locate(a, b, scoring, sub=sub)
        except AnchoredReverseMismatch as e:
            budget = max_window_cells if max_window_cells is not None \
                else (1 << 26)
            if e.end_i * e.end_j <= budget:
                return walk_from_end(a, b, scoring, e.forward_score,
                                     e.end_i, e.end_j, e.last_cell,
                                     alphabet=alphabet, sub=sub)
            raise
    if loc is None:
        return None
    wm = loc.end_j - loc.start_j + 1
    wn = loc.end_i - loc.start_i + 1
    on_device = _device_resident()
    if max_window_cells is None:
        # on an accelerator the refill keeps P in device memory (int8,
        # diagonal-major: about 2 bytes per cell of a square window) and
        # walks it there, so the budget is device memory, not transfer:
        # 2^30 cells fit an 80 GB card many times over. Random DNA at
        # reference scoring is in the linear growth phase, so whole-matrix
        # windows are the common case and must not fall to Hirschberg.
        max_window_cells = (1 << 30) if on_device else (1 << 26)
    if wm * wn > max_window_cells:
        return hirschberg(a, b, scoring, loc=loc, alphabet=alphabet,
                          sub=sub)
    sub_a = np.asarray(a[loc.start_j - 1: loc.end_j])
    sub_b = np.asarray(b[loc.start_i - 1: loc.end_i])
    if on_device:
        ca, cb = _device_window_walk(sub_a, sub_b, wn, wm, scoring, sub=sub)
    else:
        ca, cb = _scan_window_walk(sub_a, sub_b, wn, wm, scoring, sub=sub)
    ra, rb = _render(ca, cb, alphabet)
    return loc.score, loc, ra, rb
