"""XLA `lax.scan` anti-diagonal fill — the portable execution plan.

This is the XLA analog of the reference's v0/v1 ladder rungs
(serial sweep `serial_smithW.c:141-145`; OpenMP wavefront
`omp_smithW.c:203-217`): one compiled program sweeps anti-diagonals with all
cells of a diagonal computed as one vector op. It runs on any JAX backend and
is the correctness backstop for the GPU wavefront kernel.

Layout: **row-stationary**. Lane ``k`` (0..n-1) always holds row ``i = k+1``
of the padded matrix; at step ``t`` it holds cell ``(k+1, t-k+1)``. Then:

* LEFT  neighbor ``(i, j-1)``   = same lane, previous step;
* UP    neighbor ``(i-1, j)``   = lane k-1, previous step (shift by one);
* DIAG  neighbor ``(i-1, j-1)`` = lane k-1, two steps back (shift by one).

The substitution inputs are made contiguous by the *reversed-query trick*:
lane k at step t needs ``a[t-k]``; with ``Q = reverse(pad(a))`` that window is
``Q[m+n-2-t : m+n-2-t+n]`` — one dynamic slice per step, ascending in k.
(The rotated-CUDA family solves the same problem with diagonal-major storage,
rotated-cuda/sw-rotated.cu:2-21; here the *data layout* never rotates, only
the sliding window does.)

Boundary injection (``top_row`` / ``left_col``) generalizes the zero padding
(calloc, serial_smithW.c:97) so the identical kernel fills interior blocks of
a tiled or multi-device decomposition.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import (DIAGONAL, E_EXT, F_EXT, LEFT, NONE,
                           UP, Scoring)

# np scalar, NOT jnp: a module-level jnp scalar would initialize the XLA
# backend at import time — which breaks jax.distributed.initialize (it
# must run before any backend touch). Same strong-int32 semantics.
NEG = np.int32(-(1 << 30))


class FillOut(NamedTuple):
    """Device-side fill results (diagonal-major where 2D)."""
    max_score: jax.Array        # () int32
    max_i: jax.Array            # () int32 — padded row index of first max
    max_j: jax.Array            # () int32 — padded col index of first max
    last_cell: jax.Array        # () int32 — H[n, m] (reference's H[m*n-1] check)
    bottom_row: jax.Array       # (m+1,) int32 — H[n, :] for stripe chaining
    right_col: jax.Array        # (n+1,) int32 — H[:, m] for pipeline halos
    p_diag: Optional[jax.Array]     # (n+m-1, n) int8 or None
    h_diag: Optional[jax.Array]     # (n+m-1, n) int32 or None
    e_diag: Optional[jax.Array]     # affine E, diag-major, or None
    f_diag: Optional[jax.Array]     # affine F, diag-major, or None
    bottom_f: Optional[jax.Array] = None   # (m+1,) F[n, :] (affine)
    right_e: Optional[jax.Array] = None    # (n+1,) E[:, m] (affine)


def _shift_down(v: jax.Array, fill) -> jax.Array:
    """v'[k] = v[k-1]; v'[0] = fill. The lane-0 inflow is the top boundary."""
    return jnp.concatenate([jnp.asarray(fill, v.dtype)[None], v[:-1]])


@functools.partial(
    jax.jit,
    static_argnames=("scoring", "return_p", "return_h", "band", "local"),
)
def scan_fill(
    a: jax.Array,
    b: jax.Array,
    *,
    scoring: Scoring = Scoring(),
    return_p: bool = False,
    return_h: bool = False,
    band: Optional[int] = None,
    top_row: Optional[jax.Array] = None,    # (m+1,) int32 H values of row 0
    left_col: Optional[jax.Array] = None,   # (n+1,) int32 H values of col 0
    top_f: Optional[jax.Array] = None,      # (m+1,) int32 F of row 0 (affine)
    left_e: Optional[jax.Array] = None,     # (n+1,) int32 E of col 0 (affine)
    local: bool = True,
    sub_table: Optional[jax.Array] = None,  # (A+3, A+3) embedded sub matrix
) -> FillOut:
    """Fill the (n+1)x(m+1) DP matrix for one pair. a: (m,) int8, b: (n,) int8.

    ``local=False`` switches to global (Needleman-Wunsch) semantics: no zero
    floor, every cell takes a real predecessor. Callers supply gap-penalty
    boundaries via top_row/left_col. This mode powers the Hirschberg
    linear-space traceback (the capability the reference leaves as a TODO,
    rotated-cuda/sw-rotated.cu:286-319).
    """
    m, n = a.shape[0], b.shape[0]
    steps = n + m - 1
    gap = jnp.int32(scoring.gap)
    match = jnp.int32(scoring.match)
    mismatch = jnp.int32(scoring.mismatch)

    if top_row is None:
        top_row = jnp.zeros((m + 1,), jnp.int32)
    if left_col is None:
        left_col = jnp.zeros((n + 1,), jnp.int32)
    # top_row padded so reads at index up to m+1 are in range (value unused
    # on the final step's invalid lanes, but must not be OOB-clamped garbage).
    top_pad = jnp.concatenate([top_row.astype(jnp.int32),
                               jnp.zeros((1,), jnp.int32)])

    # Reversed-query window: Q[(m+n-2-t) + k] == a[t-k] (sentinel outside).
    sent = jnp.full((n - 1,), -1, dtype=a.dtype) if n > 1 else jnp.zeros((0,), a.dtype)
    q = jnp.concatenate([sent, a, sent])[::-1]

    kk = jnp.arange(n, dtype=jnp.int32)           # lane ids; row i = k+1
    b32 = b.astype(jnp.int32)
    # Pre-entry carry: lane k holds its left boundary H(k+1, 0) until it
    # enters the matrix, so the first LEFT/DIAG reads see the injected column.
    h_init = left_col[1:].astype(jnp.int32)

    affine = scoring.is_affine
    if affine:
        g_open = jnp.int32(scoring.gap_open)
        g_ext = jnp.int32(scoring.gap_extend)
        # affine boundary continuation: F enters from the row above
        # (vertical gaps crossing the block's top edge), E from the left
        # column (horizontal gaps crossing its left edge)
        if top_f is None:
            top_f = jnp.full((m + 1,), NEG, jnp.int32)
        f_top_pad = jnp.concatenate([top_f.astype(jnp.int32),
                                     jnp.full((1,), NEG, jnp.int32)])
        e_init = (left_e[1:].astype(jnp.int32) if left_e is not None
                  else jnp.full((n,), NEG, jnp.int32))

    def step(carry, t):
        h1, h2, e1, f1, right, e_right, best, bi, bj = carry
        valid = (kk <= t) & (kk >= t - m + 1)
        if band is not None:
            # |i - j| = |2k - t| <= band
            valid &= jnp.abs(2 * kk - t) <= band

        w = lax.dynamic_slice(q, (m + n - 2 - t,), (n,)).astype(jnp.int32)
        if sub_table is None:
            sub = jnp.where(w == b32, match, mismatch)
        else:
            # codes are shifted +3 so sentinels (-3..-1) hit NEG_SUB rows
            sub = sub_table[w + 3, b32 + 3]

        up_in = top_pad[t + 1]      # H(0, t+1): lane-0 UP inflow
        di_in = top_pad[t]          # H(0, t):   lane-0 DIAG inflow
        h1s = _shift_down(h1, up_in)
        h2s = _shift_down(h2, di_in)

        diag = h2s + sub
        up = h1s + gap
        left = h1 + gap

        if affine:
            f1s = _shift_down(f1, f_top_pad[t + 1])
            e_new = jnp.maximum(h1 + g_open, e1 + g_ext)       # LEFT chain
            f_new = jnp.maximum(h1s + g_open, f1s + g_ext)
            up = f_new
            left = e_new

        if local:
            h_new = jnp.zeros_like(h1)
            p_new = jnp.zeros((n,), jnp.int8)
            take = diag > h_new
            h_new = jnp.where(take, diag, h_new)
            p_new = jnp.where(take, jnp.int8(DIAGONAL), p_new)
        else:
            h_new = diag
            p_new = jnp.full((n,), DIAGONAL, jnp.int8)
        take = up > h_new
        h_new = jnp.where(take, up, h_new)
        p_new = jnp.where(take, jnp.int8(UP), p_new)
        take = left > h_new
        h_new = jnp.where(take, left, h_new)
        p_new = jnp.where(take, jnp.int8(LEFT), p_new)
        if affine:
            # Gotoh state bits for exact affine traceback (tie -> extend)
            p_new = (p_new
                     + jnp.where(e_new == e1 + g_ext, jnp.int8(E_EXT),
                                 jnp.int8(0))
                     + jnp.where(f_new == f1s + g_ext, jnp.int8(F_EXT),
                                 jnp.int8(0)))

        # Outside the matrix (or band), lanes carry their boundary value so
        # the entering cell reads the correct LEFT/DIAG neighbors.
        h_new = jnp.where(valid, h_new, h_init)
        p_new = jnp.where(valid, p_new, jnp.int8(NONE))
        if affine:
            # pre-entry lanes carry the injected E boundary (like h_init)
            e_new = jnp.where(valid, e_new, e_init)
            f_new = jnp.where(valid, f_new, NEG)
        else:
            e_new = e1
            f_new = f1

        # Global max with the reference's first-occurrence-in-row-major rule
        # (serial_smithW.c:240): lexicographic (score, -i, -j).
        masked = jnp.where(valid, h_new, jnp.int32(-1))
        step_best = jnp.max(masked)
        lane = jnp.argmax(masked == step_best).astype(jnp.int32)  # min i
        ci = lane + 1
        cj = t - lane + 1
        better = (step_best > best) | (
            (step_best == best) & ((ci < bi) | ((ci == bi) & (cj < bj)))
        )
        best = jnp.where(better, step_best, best)
        bi = jnp.where(better, ci, bi)
        bj = jnp.where(better, cj, bj)

        # Right-edge capture: lane k holds H(k+1, m) at its last valid step
        # t = k + m - 1 (the pipeline halo, the ppermute payload).
        at_edge = t - kk == m - 1
        right = jnp.where(at_edge, h_new, right)
        if affine:
            e_right = jnp.where(at_edge, e_new, e_right)

        ys = [h_new[n - 1]]          # bottom-row stream (row n is lane n-1)
        if affine:
            ys.append(f_new[n - 1])
        if return_p:
            ys.append(p_new)
        if return_h:
            ys.append(jnp.where(valid, h_new, 0))
        return (h_new, h1, e_new, f_new, right, e_right, best, bi, bj), \
            tuple(ys)

    if affine:
        e0 = e_init
        f0 = jnp.full((n,), NEG, jnp.int32)
    else:
        e0 = f0 = jnp.zeros((n,), jnp.int32)
    carry0 = (
        h_init, h_init, e0, f0, jnp.zeros((n,), jnp.int32),
        jnp.full((n,), NEG, jnp.int32),
        jnp.int32(0), jnp.int32(0), jnp.int32(0),
    )
    (h1, h2, _, _, right, e_right, best, bi, bj), ys = lax.scan(
        step, carry0, jnp.arange(steps, dtype=jnp.int32)
    )

    ys = list(ys)
    y_bot = ys.pop(0)                       # (steps,) lane n-1 per step
    y_fbot = ys.pop(0) if affine else None
    p_diag = ys.pop(0) if return_p else None
    h_diag = ys.pop(0) if return_h else None

    last_cell = h1[n - 1]
    # Bottom row H[n, j]: lane n-1 is valid at steps t = (n-1) + (j-1).
    bottom_row = jnp.concatenate(
        [left_col[n:].astype(jnp.int32), y_bot[n - 1:]])
    right_col = jnp.concatenate([top_row[m:m + 1].astype(jnp.int32), right])
    bottom_f = right_e = None
    if affine:
        bottom_f = jnp.concatenate(
            [jnp.full((1,), NEG, jnp.int32), y_fbot[n - 1:]])
        right_e = jnp.concatenate(
            [jnp.full((1,), NEG, jnp.int32), e_right])

    return FillOut(
        max_score=best, max_i=bi, max_j=bj, last_cell=last_cell,
        bottom_row=bottom_row, right_col=right_col,
        p_diag=p_diag, h_diag=h_diag, e_diag=None, f_diag=None,
        bottom_f=bottom_f, right_e=right_e,
    )


def diag_to_rowmajor(diag: "jnp.ndarray", n: int, m: int):
    """Host-side conversion of diagonal-major (steps, n) to padded row-major
    (n+1, m+1): cell (i, j) lives at [i+j-2, i-1]. NumPy fancy-gather."""
    import numpy as np

    d = np.asarray(diag)
    out = np.zeros((n + 1, m + 1), dtype=d.dtype)
    ii = np.arange(1, n + 1)[:, None]
    jj = np.arange(1, m + 1)[None, :]
    out[1:, 1:] = d[ii + jj - 2, ii - 1]
    return out
