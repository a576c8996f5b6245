"""Hopper wavefront kernel for the single-pair score-only fill.

The CUDA source is ``csrc/sw_gpu.cu`` (layout and correctness argument at
its top). This module builds it with ``nvcc`` into ``build/`` at the
first kernel call on a GPU platform, registers it as an XLA FFI target,
and keeps everything around the kernel in JAX, where the CPU tests reach
it:

* the geometry: rows per lane R, the stripe count, the padded widths and
  the boundary-ring size (``geometry``);
* input preparation: sentinel padding of both sequences and the
  substitution-table embedding (``prepare_inputs``, ``kernel_table``);
* the final reduction of the per-stripe bests under the reference's
  row-major first-occurrence rule (``reduce_bests``).

The DP is int32 throughout, so the kernel's results are compared with the
scan and the oracle by exact equality; no float tolerance applies.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Scoring

_REPO = Path(__file__).resolve().parent.parent.parent
SOURCE = _REPO / "csrc" / "sw_gpu.cu"
BUILD_DIR = _REPO / "build"
TARGET = "swtpu_sw_fill"

WARP = 32
ROWS_PER_LANE = (4, 8, 16)
# Every stripe trails the one above by one warp of ramp plus one 32-column
# publication chunk; a step costs about R cell updates plus this many
# cell-equivalents of shuffles, chunk loads and flag waits (geometry's cost
# model; fitted to R = 4/8/16 timings at 8192^2 and 25632^2 on an H100,
# where R = 4 won or came within 3% in linear, affine and BLOSUM62).
STRIPE_LAG = 64
STEP_OVERHEAD = 12
# Boundary-ring rows: two suffice (the argument is in csrc/sw_gpu.cu).
RING_SLOTS = 2

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """The GPU fill kernel could not be built or loaded on a GPU platform.
    Raised instead of falling back to another plan."""


_state = {"lib": None, "registered": False, "build_s": None}


def _nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else None


def library_path() -> Path:
    """Where the build for the current source and flags lives: the name
    carries a digest, so an edited source never loads a stale library."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libswtpu_gpu-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile csrc/sw_gpu.cu (once per source digest). Raises
    KernelBuildError when nvcc is missing or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the GPU fill "
            "kernel cannot be built")
    import jax.ffi
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", str(tmp),
           str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    _state["build_s"] = time.perf_counter() - t0
    return out


def build_seconds() -> Optional[float]:
    """Seconds the build took in this process (None if it was cached)."""
    return _state["build_s"]


def ensure_registered() -> None:
    """Build (if needed), load and register the FFI target. Idempotent."""
    if _state["registered"]:
        return
    import jax.ffi
    path = build()
    try:
        lib = ctypes.cdll.LoadLibrary(str(path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {path}: {e}") from e
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SwFill),
                                platform="CUDA")
    _state.update(lib=lib, registered=True)


@dataclasses.dataclass(frozen=True)
class Geometry:
    R: int            # rows per lane
    stripes: int      # ceil(n / (32 R))
    mpad: int         # m rounded up to 32
    rows_pad: int     # stripes * 32 * R
    slots: int        # boundary-ring rows


def modeled_steps(m: int, n: int, R: int) -> int:
    """Critical path of the fill in warp steps: one stripe sweeps m + 31
    steps, and each further stripe starts STRIPE_LAG steps after the one
    above it."""
    stripes = -(-n // (WARP * R))
    return m + WARP - 1 + (stripes - 1) * STRIPE_LAG


def geometry(m: int, n: int, rows_per_lane: Optional[int] = None) -> Geometry:
    """Kernel geometry for an (n x m) fill. R minimizes the modeled time
    steps * (R + STEP_OVERHEAD) unless given."""
    if m < 1 or n < 1:
        raise ValueError(f"empty operand ({m} x {n})")
    if rows_per_lane is None:
        R = min(ROWS_PER_LANE, key=lambda r: (
            modeled_steps(m, n, r) * (r + STEP_OVERHEAD), r))
    elif rows_per_lane in ROWS_PER_LANE:
        R = rows_per_lane
    else:
        raise ValueError(f"rows_per_lane must be one of {ROWS_PER_LANE}")
    stripes = -(-n // (WARP * R))
    mpad = -(-m // WARP) * WARP
    return Geometry(R=R, stripes=stripes, mpad=mpad,
                    rows_pad=stripes * WARP * R,
                    slots=min(stripes, RING_SLOTS))


def kernel_table(substitution) -> np.ndarray:
    """Flattened (A+3)^2 int32 table the kernel indexes as
    table[(a+3) * (A+3) + (b+3)]: the scan's sentinel embedding, so padding
    codes -1/-2/-3 score strongly negative. None -> a one-element dummy
    (match/mismatch mode compares codes)."""
    if substitution is None:
        return np.zeros((1,), np.int32)
    from ..core.substitution import embed_sentinels
    return np.ascontiguousarray(
        embed_sentinels(np.asarray(substitution)).reshape(-1))


def prepare_inputs(a, b, geom: Geometry, nsym: int = 0):
    """Pad a to (mpad,) with -1 and b to (rows_pad,) with -2, as int8 (the
    two sentinels never match each other or a real code). With a
    substitution table of nsym symbols, codes outside [-3, nsym) become the
    -3 sentinel instead of indexing outside the table. Works on device
    arrays under jit."""
    import jax.numpy as jnp
    a = jnp.asarray(a).astype(jnp.int32)
    b = jnp.asarray(b).astype(jnp.int32)
    if nsym:
        a = jnp.where((a >= -3) & (a < nsym), a, -3)
        b = jnp.where((b >= -3) & (b < nsym), b, -3)
    ap = jnp.full((geom.mpad,), -1, jnp.int32).at[:a.shape[0]].set(a)
    bp = jnp.full((geom.rows_pad,), -2, jnp.int32).at[:b.shape[0]].set(b)
    return ap.astype(jnp.int8), bp.astype(jnp.int8)


def reduce_bests(bests):
    """(S, 3) per-stripe (score, i, j) -> global (score, i, j): highest
    score, then smallest row, then smallest column — the reference's
    first occurrence in row-major order. All-zero -> (0, 0, 0)."""
    import jax.numpy as jnp
    big = jnp.int32(2**31 - 1)
    s, i, j = bests[:, 0], bests[:, 1], bests[:, 2]
    top = jnp.max(s)
    hit = s == top
    bi = jnp.min(jnp.where(hit, i, big))
    bj = jnp.min(jnp.where(hit & (i == bi), j, big))
    pos = top > 0
    return (jnp.maximum(top, 0), jnp.where(pos, bi, 0),
            jnp.where(pos, bj, 0))


def _gap_params(scoring: Scoring) -> tuple:
    """(gap_open, gap_extend) as the kernel takes them: linear mode passes
    its one gap penalty as gap_open (extend unused)."""
    if scoring.is_affine:
        return int(scoring.gap_open), int(scoring.gap_extend)
    return int(scoring.gap), 0


def fill_call(m: int, n: int, scoring: Scoring, geom: Geometry,
              sub_dim: int = 0):
    """The raw FFI call: (a_pad, b_pad, table) -> (bests (S, 3), right
    (rows_pad,), ring_h, ring_f, flags); the last three are scratch."""
    import jax
    import jax.numpy as jnp
    i32 = jnp.int32
    ring = (geom.slots, geom.mpad)
    outs = (jax.ShapeDtypeStruct((geom.stripes, 3), i32),
            jax.ShapeDtypeStruct((geom.rows_pad,), i32),
            jax.ShapeDtypeStruct(ring, i32),
            jax.ShapeDtypeStruct(ring if scoring.is_affine else (1,), i32),
            jax.ShapeDtypeStruct((geom.stripes,), i32))
    g_open, g_ext = _gap_params(scoring)
    call = jax.ffi.ffi_call(TARGET, outs)

    def run(a_pad, b_pad, table):
        return call(a_pad, b_pad, table, m=np.int32(m), n=np.int32(n),
                    rows_per_lane=np.int32(geom.R),
                    affine=np.int32(scoring.is_affine),
                    match=np.int32(scoring.match),
                    mismatch=np.int32(scoring.mismatch),
                    gap_open=np.int32(g_open), gap_extend=np.int32(g_ext),
                    sub_dim=np.int32(sub_dim))
    return run


@functools.lru_cache(maxsize=64)
def _score_fn(m: int, n: int, scoring: Scoring, sub_key, rows_per_lane):
    import jax
    import jax.numpy as jnp
    ensure_registered()
    sub = None if sub_key is None else np.frombuffer(
        sub_key[1], np.int32).reshape(sub_key[0])
    geom = geometry(m, n, rows_per_lane)
    table = kernel_table(sub)
    nsym = 0 if sub is None else sub.shape[0]
    call = fill_call(m, n, scoring, geom, sub_dim=nsym + 3 if nsym else 0)

    def fn(a, b):
        a_pad, b_pad = prepare_inputs(a, b, geom, nsym)
        bests, right, *_ = call(a_pad, b_pad, jnp.asarray(table))
        s, i, j = reduce_bests(bests)
        return s, i, j, right[n - 1]
    return jax.jit(fn)


def score_fn(m: int, n: int, scoring: Scoring = Scoring(),
             substitution=None, rows_per_lane: Optional[int] = None):
    """Jitted (a, b) -> (max_score, max_i, max_j, last_cell) on the GPU
    kernel for an (n x m) problem; a: (m,) codes, b: (n,) codes. Builds and
    registers the kernel on first use (KernelBuildError on failure)."""
    sub_key = None
    if substitution is not None:
        s32 = np.ascontiguousarray(np.asarray(substitution, np.int32))
        sub_key = (s32.shape, s32.tobytes())
    return _score_fn(m, n, scoring, sub_key, rows_per_lane)
