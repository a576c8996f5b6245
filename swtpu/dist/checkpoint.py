"""Checkpoint / resume for long mega-matrix pipeline runs.

The reference has no checkpointing (SURVEY.md §5 — its longest run is
~260 s). A 10^6 x 10^6 pipeline run is hours; its live state is tiny and
boundary-shaped, which the rolling-wavefront design makes natural
(rotated-cuda/sw-rotated-cuda-unified.cu:225-241): per device, one bottom
row (m/D + 1 ints), one incoming halo column (R + 1 ints), the affine
F/E companions, and the running best — O((m + n)/D) total. This module
runs THE live pipeline stage (dist/pipeline._make_stage — one stage
implementation, not a re-implementation that drifts) in host-stepped
segments, snapshotting that carry to an .npz between segments and
resuming from any snapshot bit-exactly. Block fills are the same
`_make_block` the live pipeline uses (the boundary-injected scan), linear,
affine and substitution alike.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import Scoring
from .pipeline import PipelineResult, _make_block, _make_stage

_KEYS = ["bottom", "bottom_f", "left", "left_e", "bs", "bi", "bj", "last"]


@dataclasses.dataclass
class ResumablePipeline:
    """Segmented mega-matrix pipeline with snapshot/restore.

    Usage::

        rp = ResumablePipeline(mesh, m, n, block_rows=4096)
        carry = rp.init()
        for seg in range(rp.num_segments):
            carry = rp.segment(a, b, carry, seg)
            rp.save(carry, seg, "ckpt.npz")          # crash-safe point
        # ... after a restart:
        carry, seg = rp.load("ckpt.npz")
        ...
        result = rp.finish(carry)

    Results bit-match `pipeline_align` on the same mesh for linear AND
    affine (and substitution) scoring — the carry IS the live pipeline's
    stage carry.
    """

    mesh: Mesh
    m: int
    n: int
    block_rows: int
    scoring: Scoring = Scoring()
    axis: str = "seq"
    stages_per_segment: int = 8
    substitution: Optional[np.ndarray] = None

    def __post_init__(self):
        D = self.mesh.shape[self.axis]
        if self.m % D or self.n % self.block_rows:
            raise ValueError("m must divide by mesh size, n by block_rows")
        self.D = D
        self.mc = self.m // D
        self.R = self.block_rows
        self.nblocks = self.n // self.R
        self.stages = self.nblocks + D - 1
        self.num_segments = -(-self.stages // self.stages_per_segment)
        self._seg_fn = self._build_segment()

    # carry pytree: dict of (D, ...) arrays sharded over the mesh axis
    def _sharding(self):
        return NamedSharding(self.mesh, P(self.axis))

    def init(self) -> dict:
        """Fresh carry: one stage-loop init per device (the same
        _carry0 the live pipeline starts from)."""
        D, mc, R = self.D, self.mc, self.R
        sh = self._sharding()
        NEGB = -(1 << 30)
        z = lambda shape, fill=0: jax.device_put(
            np.full(shape, fill, np.int32), sh)
        return {
            "bottom": z((D, mc + 1)),
            "bottom_f": z((D, mc + 1), NEGB),
            "left": z((D, R + 1)),
            "left_e": z((D, R + 1), NEGB),
            "bs": z((D,)), "bi": z((D,)), "bj": z((D,)), "last": z((D,)),
        }

    def _build_segment(self):
        mc, R, D = self.mc, self.R, self.D
        nblocks = self.nblocks
        axis = self.axis
        perm = [(i, i + 1) for i in range(D - 1)]
        K = self.stages_per_segment
        affine = self.scoring.is_affine
        block = _make_block(mc, self.scoring, is_local=True,
                            substitution=self.substitution)
        stage = _make_stage(D=D, mc=mc, R=R, nblocks=nblocks, npb=nblocks,
                            axis=axis, perm=perm, block=block,
                            affine=affine, is_local=True)

        def local(a_shard, b_full, bottom, bottom_f, left, left_e,
                  bs, bi, bj, last, t0):
            d = lax.axis_index(axis)
            a_shard = a_shard[0]
            carry = (bottom[0], bottom_f[0], left[0], left_e[0],
                     bs, bi, bj, last)      # best regs stay (1,) = per-pair

            carry = lax.fori_loop(
                0, K,
                lambda k, c: stage(t0 + k, c, d, b_full,
                                   lambda pid: a_shard),
                carry)
            bottom, bottom_f, left, left_e, bs, bi, bj, last = carry
            exp = lambda x: x[None]
            return (exp(bottom), exp(bottom_f), exp(left), exp(left_e),
                    bs, bi, bj, last)

        pa = P(self.axis)
        fn = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(pa, P(), pa, pa, pa, pa, pa, pa, pa, pa, P()),
            out_specs=(pa, pa, pa, pa, pa, pa, pa, pa),
            check_vma=False,
        )
        return jax.jit(fn)

    def segment(self, a_sharded, b_full, carry: dict, seg_idx: int) -> dict:
        t0 = jnp.int32(seg_idx * self.stages_per_segment)
        out = self._seg_fn(a_sharded, b_full, *(carry[k] for k in _KEYS),
                           t0)
        return dict(zip(_KEYS, out))

    def save(self, carry: dict, seg_idx: int, path: str) -> None:
        np.savez(path, seg=seg_idx,
                 **{k: np.asarray(v) for k, v in carry.items()})

    def load(self, path: str) -> tuple[dict, int]:
        """Load a snapshot. Pre-round-3 snapshots carry 6 keys (no affine
        bottom_f/left_e): for linear runs the stage never reads them, so
        synthesize the NEGB init defaults; an affine pipeline cannot
        resume from one — fail with a versioned message, not a KeyError."""
        z = np.load(path)
        sh = self._sharding()
        missing = [k for k in _KEYS if k not in z]
        if missing:
            affine_only = {"bottom_f", "left_e"}
            if set(missing) <= affine_only and not self.scoring.is_affine:
                NEGB = -(1 << 30)
                shapes = {"bottom_f": (self.D, self.mc + 1),
                          "left_e": (self.D, self.R + 1)}
                fills = {k: np.full(shapes[k], NEGB, np.int32)
                         for k in missing}
            else:
                raise ValueError(
                    f"checkpoint {path!r} predates the affine carry "
                    f"(missing {sorted(missing)}); an affine pipeline "
                    "cannot resume from it — refill from scratch or "
                    "resume with linear scoring")
        else:
            fills = {}
        carry = {k: jax.device_put(fills[k] if k in fills else z[k], sh)
                 for k in _KEYS}
        return carry, int(z["seg"])

    def finish(self, carry: dict) -> PipelineResult:
        bs = np.asarray(carry["bs"])
        bi = np.asarray(carry["bi"])
        bj = np.asarray(carry["bj"])
        last = np.asarray(carry["last"])
        order = np.lexsort((bj, bi, -bs))
        k = order[0]
        if bs[k] <= 0:
            return PipelineResult(np.int32(0), np.int32(0), np.int32(0),
                                  np.int32(last[-1]))
        return PipelineResult(np.int32(bs[k]), np.int32(bi[k]),
                              np.int32(bj[k]), np.int32(last[-1]))

    # convenience: full run with optional checkpoint file
    def run(self, a_codes: np.ndarray, b_codes: np.ndarray,
            ckpt_path: Optional[str] = None,
            resume: bool = False) -> PipelineResult:
        sh = self._sharding()
        a_sh = jax.device_put(np.asarray(a_codes, np.int8)
                              .reshape(self.D, self.mc), sh)
        b_full = jnp.asarray(np.asarray(b_codes, np.int8))
        start = 0
        if resume and ckpt_path and Path(ckpt_path).exists():
            carry, seg = self.load(ckpt_path)
            start = seg + 1
        else:
            carry = self.init()
        for seg in range(start, self.num_segments):
            carry = self.segment(a_sh, b_full, carry, seg)
            if ckpt_path:
                self.save(carry, seg, ckpt_path)
        return self.finish(carry)
