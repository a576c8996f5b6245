"""Scoring model and framework configuration.

Re-design of the reference's compile-time configuration surface:

* the reference hard-codes ``matchScore=3 / missmatchScore=-3 / gapScore=-2``
  as globals (``serial_smithW.c:59-61``) and predecessor codes
  ``NONE/UP/LEFT/DIAGONAL = 0/1/2/3`` (``serial_smithW.c:23-27``);
* ``parameters.h`` holds the serial-vs-parallel ``CUTOFF=1024`` knob and the
  print-only ``FACTOR=128``;
* v7's adaptive thresholds ``MEDIUM=10240 / LARGE=20480`` live at
  ``omp_smithW-v7-adaptive.cpp:106-107``.

Here all of that is *runtime* configuration carried by frozen dataclasses so it
can flow through ``jax.jit`` as static arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Predecessor codes — parity contract with the reference constant block
# (serial_smithW.c:23-27). The traceback marks path cells by negation
# (PATH = -1 multiplier, serial_smithW.c:274).
NONE = 0
UP = 1
LEFT = 2
DIAGONAL = 3
PATH = -1
# Affine traceback state bits OR'd into P (capability extension; the
# reference is linear-gap only): E/F at this cell chose gap EXTENSION
# (ties prefer extension). Needed for exact Gotoh alignment strings.
E_EXT = 4
F_EXT = 8


@dataclasses.dataclass(frozen=True)
class Scoring:
    """Substitution + gap model.

    ``mode='linear'`` reproduces the reference exactly (one gap penalty,
    serial_smithW.c:61,195-198). ``mode='affine'`` adds Gotoh H/E/F
    recurrences (gap_open charged on opening, gap_extend per extension) —
    a capability extension over the linear-only reference.
    """

    match: int = 3
    mismatch: int = -3
    gap: int = -2                 # linear gap penalty (mode='linear')
    gap_open: int = -4            # affine: cost of the first gap position
    gap_extend: int = -1          # affine: cost of each further gap position
    mode: str = "linear"          # 'linear' | 'affine'

    def __post_init__(self):
        if self.mode not in ("linear", "affine"):
            raise ValueError(f"unknown gap mode {self.mode!r}")

    @property
    def is_affine(self) -> bool:
        return self.mode == "affine"


# The reference's built-in golden example (Wikipedia): a="TGTTACGG",
# b="GGTTGACTA" (serial_smithW.c:107-124). Invariants: global max score 13 at
# padded row-major index 69 (i=7, j=6 with m=9 padded columns), bottom-right
# cell H[last]==7 (omp_smithW-v1-refinedOrig.cpp:229-238).
BUILTIN_A = "TGTTACGG"
BUILTIN_B = "GGTTGACTA"
BUILTIN_MAX_SCORE = 13
BUILTIN_MAX_POS = 69          # row-major index in the padded (n+1)x(m+1) matrix
BUILTIN_LAST_CELL = 7


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution-plan configuration (the parameters.h / v7-threshold analog).

    Thresholds are in *cells* (m*n) unless noted. ``dispatch/autotune.py`` can
    rewrite these from measured GCUPS — the ``tuneCutoff.sh`` analog, but at
    runtime instead of sed-rebuild.
    """

    # tiny problems run the native serial fill ON HOST (csrc sw_fill —
    # the reference's v0/serial tier as a dispatch backend,
    # omp_smithW-v7-adaptive.cpp:304-314's "serial if small" analog): a
    # device dispatch costs more than the whole fill below this size.
    host_max_cells: int = 1 << 13
    # SCORE-ONLY requests below this many cells run the striped AVX2 host
    # fill (csrc sw_score_simd) — the mid-size tier: between
    # host_max_cells and where a device fill amortizes its per-dispatch
    # floor, the host SIMD fill finishes before a device dispatch would
    # even return. None (the default) DERIVES the crossover in-process:
    # the measured per-core SIMD rate (one-time ~1 ms probe,
    # runtime_native.measured_simd_gcups) x the measured device
    # dispatch+fetch floor (engine.align._dispatch_fetch_floor), so the
    # threshold is a measurement, not a constant. Set an int to pin it (0
    # disables the tier). The int16 score cap gates eligibility
    # independently (runtime_native.score_simd).
    host_simd_max_cells: Optional[int] = None
    # banded mode: half-width of the band (|i-j| <= band). None = full matrix.
    band: Optional[int] = None
    # keep the predecessor matrix for traceback. False = score-only
    # (the -DSKIP_BACKTRACK=1 benchmark mode, makefile:9).
    traceback: bool = True
    # 'full'    = device-captured P matrix, exact reference tie-breaking
    # 'windowed'= locate + window refill (O(window) memory)
    # 'hirschberg' = O(m+n) memory divide-and-conquer
    # 'auto'    = full below full_p_max_cells, windowed above
    traceback_method: str = "auto"
    full_p_max_cells: int = 1 << 28
    # score dtype; int32 is the parity dtype (reference uses C int).
    dtype: str = "int32"

    def simd_cells_cap(self) -> int:
        """The effective host-SIMD crossover in cells: the pinned value
        when set, else the measured derivation for this host."""
        if self.host_simd_max_cells is not None:
            return self.host_simd_max_cells
        return derived_host_simd_max_cells()


# --- host-SIMD crossover derivation --------------------------------------

_simd_cap_cache: dict = {"value": None}

# the SIMD tier's own hard shape limit (positions ride int16 lanes): on
# the CPU platform there is no device to dispatch to and so no crossover —
# every eligible problem belongs to the SIMD tier, so the cap is the
# tier's eligibility ceiling itself
SIMD_SHAPE_LIMIT_CELLS = 32767 * 32767


def derived_host_simd_max_cells() -> int:
    """Measured crossover: cells where this host's striped-SIMD fill takes
    as long as one device round-trip — per-core SIMD GCUPS (one-time
    probe) x the device's measured dispatch+fetch floor. On the CPU
    platform the fallthrough is the scan on the same cores, so the SIMD
    tier wins wherever it is eligible and the cap is its shape ceiling;
    on an accelerator the cap is always the measured crossover. 0 when
    the SIMD tier is unavailable (routing then skips it entirely). Cached
    per process."""
    if _simd_cap_cache["value"] is None:
        from ..runtime_native import measured_simd_gcups
        rate = measured_simd_gcups()
        if rate is None:
            _simd_cap_cache["value"] = 0
        else:
            from ..dispatch.plan import capability
            if capability().platform == "cpu":
                _simd_cap_cache["value"] = SIMD_SHAPE_LIMIT_CELLS
            else:
                from ..engine.align import _dispatch_fetch_floor
                _simd_cap_cache["value"] = int(rate * 1e9
                                               * _dispatch_fetch_floor())
    return _simd_cap_cache["value"]
