"""Adaptive execution-plan dispatch — the v7/v8 analog.

The reference picks serial / CPU-parallel / GPU per *diagonal* with fixed
thresholds (omp_smithW-v7-adaptive.cpp:106-107,303-397) or an Apollo-learned
policy (omp_smithW-v8-apollo.cpp:304-420). Under XLA the whole fill is one
compiled program, so the dispatch granularity is the *problem*, not the
diagonal. The tiers mirror v7's serial/CPU/GPU ladder:

* 'host'      — tiny problems run the native serial fill on the host;
* 'wavefront' — single-pair score-only fills on a Hopper GPU run the CUDA
  wavefront kernel (kernels/gpu_fill.py, csrc/sw_gpu.cu);
* 'scan'      — everything else runs the portable XLA scan plan;
* 'pipeline'  — an explicit mesh (or plan='pipeline') runs the multi-device
  sequence-parallel pipeline (dist/pipeline.py).

Every platform gate in the package reads one `capability()` resolution:
the platform computations land on, its device kind and count, and whether
the GPU kernel can serve it (a Hopper card and the kernel's source). The
kernel itself is built on its first use, not here, so a platform query
never needs nvcc. When a persisted autotune table is available (the
Apollo analog), dispatch returns its measured best plan; live timed paths
feed `Policy.observe` (the region->end() analog,
omp_smithW-v8-apollo.cpp:420) so the table keeps learning online.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax

from ..core.config import EngineConfig, Scoring

# Plan names a caller may force. 'stripe' named the kernel of the former
# accelerator; it is refused with a pointer to its replacement.
PLANS = ("host", "scan", "wavefront", "pipeline", "auto")


def check_plan(plan: Optional[str]) -> None:
    """Raise on an unknown plan name (None = 'auto')."""
    if plan is None or plan in PLANS:
        return
    if plan == "stripe":
        raise ValueError(
            "plan='stripe' no longer exists; the single-pair fill kernel "
            "is plan='wavefront' (GPU), and plan='scan' runs anywhere")
    raise ValueError(f"unknown plan {plan!r}; expected one of {PLANS}")


@dataclasses.dataclass(frozen=True)
class Capability:
    """What the platform this process computes on can run."""

    platform: str        # 'cpu' | 'gpu' | ...
    device_kind: str
    device_count: int    # devices of that platform (the mesh it can build)
    gpu_kernel: bool     # a Hopper card and the wavefront kernel's source


def _default_device():
    dev = jax.config.jax_default_device
    if dev is not None and not isinstance(dev, str):
        return dev
    return jax.devices(dev)[0] if isinstance(dev, str) else jax.devices()[0]


def is_hopper(device) -> bool:
    """The kernel is compiled for sm_90a: compute capability 9.x only."""
    cc = str(getattr(device, "compute_capability", "") or "")
    return device.platform == "gpu" and cc.split(".")[0] == "9"


def resolve_capability(device) -> Capability:
    """Capability of ``device``'s platform. Builds nothing: the kernel is
    built at its first call (gpu_fill.score_fn), and a failed build raises
    KernelBuildError there — the plan that chose it never falls back."""
    gpu_kernel = False
    if is_hopper(device):
        from ..kernels import gpu_fill
        gpu_kernel = gpu_fill.SOURCE.is_file()
    return Capability(platform=device.platform,
                      device_kind=device.device_kind,
                      device_count=len(jax.devices(device.platform)),
                      gpu_kernel=gpu_kernel)


_cap_cache: dict = {}


def capability() -> Capability:
    """Capability of the default device, resolved once per device."""
    dev = _default_device()
    key = (dev.platform, dev.id)
    if key not in _cap_cache:
        _cap_cache[key] = resolve_capability(dev)
    return _cap_cache[key]


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """A resolved execution decision. `source` records whether a measured
    table or the static tiers decided — the v8-vs-v7 distinction."""

    plan: str                      # 'host' | 'scan' | 'wavefront' | 'pipeline'
    source: str = "threshold"      # 'threshold' | 'tuned'


_policy_cache = {"loaded": False, "policy": None}


def pipeline_block_rows(m: int, n: int, D: int) -> int:
    """Row-block height for the D-device pipeline. A stage fills a
    (block_rows x m/D) block in block_rows + m/D - 1 wavefront steps and the
    pipeline runs n/block_rows + D - 1 stages, so the step count
    (n/br + D - 1)(br + m/D) is least at br = sqrt(n (m/D) / (D - 1)),
    rounded to a power of two and kept within [128, n]."""
    if D < 2:
        return max(1, n)
    mc = max(m // D, 1)
    best = math.sqrt(n * mc / (D - 1))
    br = 1 << max(7, round(math.log2(max(best, 1.0))))
    return max(1, min(br, n))


def _tuned_policy(create: bool = False):
    """Lazily load the persisted autotune table (the Apollo analog): the
    SWTPU_TUNED_TABLE env var wins, else swtpu_tuned.json in the working
    directory. With create=True, returns a fresh in-memory Policy when no
    table exists, so live observations accumulate (online v8 mode without a
    prior sweep)."""
    if not _policy_cache["loaded"]:
        _policy_cache["loaded"] = True
        import os
        from .autotune import Policy, load
        for c in (os.environ.get("SWTPU_TUNED_TABLE"), "swtpu_tuned.json"):
            if c:
                table = load(c)
                if table:
                    _policy_cache["policy"] = Policy(table)
                    break
    if create and _policy_cache["policy"] is None:
        from .autotune import Policy
        _policy_cache["policy"] = Policy()
    return _policy_cache["policy"]


def choose_exec(m: int, n: int, config: EngineConfig = EngineConfig(),
                scoring: Optional[Scoring] = None,
                substitution=None) -> ExecPlan:
    """Resolve the execution plan for a single-pair problem of m cols, n
    rows: the host tier below config.host_max_cells; otherwise a measured
    plan when a tuned table has a near-enough entry OF THE SAME SCORING
    SIGNATURE (the v8/Apollo analog) and this platform can run it; else
    the GPU kernel where it can run (score-only, unbanded) and the scan
    everywhere else (the v7 analog)."""
    cells = m * n
    # serial host tier (the v7 "serial if small" branch,
    # omp_smithW-v7-adaptive.cpp:304-314): below this size the native C
    # fill finishes before a device dispatch would even return. The very
    # first available() of a process may build the library (~2 s,
    # once per checkout); every later call is a cached-bool read.
    if cells <= config.host_max_cells and config.band is None:
        from ..runtime_native import available
        if available():
            return ExecPlan("host")
    cap = capability()
    runnable = {"scan"} | ({"wavefront"} if cap.gpu_kernel
                           and config.band is None else set())
    pol = _tuned_policy()
    if pol is not None:
        from .autotune import scoring_sig
        e = pol.choose_near(m, n, sig=scoring_sig(scoring, substitution))
        if e is not None and e.get("plan") in runnable:
            return ExecPlan(e["plan"], source="tuned")
    return ExecPlan("wavefront" if "wavefront" in runnable else "scan")


def choose_plan(m: int, n: int, config: EngineConfig = EngineConfig()) -> str:
    """Plan-name-only view of choose_exec (back-compat surface)."""
    return choose_exec(m, n, config).plan


def observe(m: int, n: int, plan: str, seconds: float,
            sig: str = "linear") -> None:
    """Feed a live measured timing back into the session policy — the
    Apollo region->end() analog (omp_smithW-v8-apollo.cpp:420). Called by
    the engine's warm timed paths; accumulates in memory and, when
    SWTPU_AUTOTUNE_PERSIST names a file, auto-saves at process exit with
    a disk-table merge (the APOLLO_CROSS_EXECUTION analog,
    run-v8.sh:15)."""
    pol = _tuned_policy(create=True)
    pol.observe(m, n, plan, seconds, sig=sig)
    _register_autopersist()


def session_policy():
    """The live Policy (loaded table + online observations), or None."""
    return _tuned_policy()


_persist_state = {"registered": False}


def persist_session_policy(path: Optional[str] = None) -> Optional[str]:
    """Merge the session policy's table into the one at ``path`` (env
    SWTPU_AUTOTUNE_PERSIST when omitted) and save. Returns the path
    written, or None when there is nothing to persist. Merge semantics:
    per (m, n, sig) the better-GCUPS best wins, so two processes
    alternating cannot lose each other's measurements."""
    import os
    path = path or os.environ.get("SWTPU_AUTOTUNE_PERSIST")
    pol = _policy_cache["policy"]
    if not path or pol is None or not pol.table \
            or not pol.table.get("entries"):
        return None
    from .autotune import Policy, load, save
    merged = Policy({"entries": []})
    merged.merge(load(path))
    merged.merge(pol.table)
    save(merged.table, path)
    return path


def _register_autopersist() -> None:
    import atexit
    import os
    if _persist_state["registered"] \
            or not os.environ.get("SWTPU_AUTOTUNE_PERSIST"):
        return
    _persist_state["registered"] = True
    atexit.register(persist_session_policy)
