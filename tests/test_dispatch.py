"""Dispatch tests: one capability resolution drives every platform gate,
the tuned table changes the plan that actually runs (the v8/Apollo closed
loop), the pipeline tier is reached by a mesh, and live timed paths feed
Policy.observe."""

import json
import types

import numpy as np
import pytest

from swtpu import Scoring
from swtpu.core import oracle
from swtpu.core.config import EngineConfig
from swtpu.core.encode import random_batch, random_pair
from swtpu.dispatch import plan as planmod
from swtpu.dispatch.autotune import Policy


def _fresh_policy(monkeypatch, table_path=None):
    monkeypatch.setattr(planmod, "_policy_cache",
                        {"loaded": False, "policy": None})
    if table_path is not None:
        monkeypatch.setenv("SWTPU_TUNED_TABLE", str(table_path))


def _write_table(path, m, n, best):
    path.write_text(json.dumps({"entries": [
        {"m": m, "n": n, "best": best, "all": []}]}))


# these tests pin the DEVICE dispatch; the score-only SIMD host tier
# (which would intercept small traceback=False calls before choose_exec)
# is disabled explicitly
_NO_SIMD = EngineConfig(host_simd_max_cells=0)

TUNED = {"plan": "scan", "s": 0.001, "gcups": 100.0}


def test_choose_exec_returns_full_tuned_config(tmp_path, fake_gpu,
                                               monkeypatch):
    """A measured table entry overrides the static tier: on a GPU where
    the kernel would win by default, a tuned 'scan' entry decides."""
    f = tmp_path / "tuned.json"
    _write_table(f, 256, 256, TUNED)
    _fresh_policy(monkeypatch, f)
    ep = planmod.choose_exec(256, 256)
    assert ep.plan == "scan" and ep.source == "tuned"


@pytest.mark.parametrize("row_plan", ["stripe", "wavefront", "bogus"])
def test_choose_exec_sanitizes_invalid_table_rows(tmp_path, monkeypatch,
                                                  row_plan):
    """A table row naming a plan this platform cannot run (a removed
    kernel, or the GPU kernel on the CPU platform) never reaches
    execution: dispatch falls back to the static tiers."""
    f = tmp_path / "tuned.json"
    _write_table(f, 256, 256, dict(TUNED, plan=row_plan))
    _fresh_policy(monkeypatch, f)
    ep = planmod.choose_exec(256, 256)
    assert ep.plan == "scan" and ep.source == "threshold"


def test_policy_far_gating(tmp_path, monkeypatch):
    # a tuned table with only large square entries must not capture tiny
    # or extreme-aspect problems (nearest-cells matching did)
    f = tmp_path / "tuned.json"
    _write_table(f, 25632, 25632, TUNED)
    _fresh_policy(monkeypatch, f)
    pol = planmod.session_policy()
    assert pol.choose_near(64, 64) is None               # far in cells
    assert pol.choose_near(2000, 145002) is None         # far in aspect
    assert pol.choose_near(25632, 25632) is not None
    # dispatch falls back to the size-threshold rule: tiny problems take
    # the native host tier (the v7 serial branch) when the lib is built,
    # the scan plan otherwise
    from swtpu.runtime_native import available
    expect = "host" if available() else "scan"
    assert planmod.choose_exec(64, 64).plan == expect
    assert planmod.choose_exec(64, 64).source == "threshold"


def test_live_path_feeds_policy_observe(tmp_path, fake_gpu, monkeypatch):
    """Warm align() calls on the kernel path must call Policy.observe (the
    region->end() analog) with the executed plan."""
    f = tmp_path / "tuned.json"
    _write_table(f, 128, 128, {"plan": "wavefront", "s": 1, "gcups": 1.0})
    _fresh_policy(monkeypatch, f)
    import swtpu.engine.align as al
    monkeypatch.setattr(al, "_warm_keys", set())

    a, b = random_pair(128, 128, seed=1)
    r = al.align(a, b, config=_NO_SIMD, traceback=False)  # cold: no observe
    assert r.plan == "wavefront"
    pol = planmod.session_policy()
    n_rows = len(pol.table["entries"][0]["all"])
    al.align(a, b, config=_NO_SIMD, traceback=False)      # warm: observed
    rows = pol.table["entries"][0]["all"]
    assert len(rows) == n_rows + 1
    assert rows[-1]["plan"] == "wavefront" and rows[-1]["s"] > 0


AFF = Scoring(mode="affine", gap_open=-5, gap_extend=-1)


def _write_table_sig(path, rows):
    """rows: list of (m, n, sig, best)."""
    path.write_text(json.dumps({"entries": [
        {"m": m, "n": n, "sig": sig, "best": best, "all": []}
        for m, n, sig, best in rows]}))


def test_tuned_table_is_scoring_aware(tmp_path, fake_gpu, monkeypatch):
    """An affine call must match only affine-sig entries; a linear-DNA
    winner never lands on affine/BLOSUM calls."""
    from swtpu.core.substitution import BLOSUM62
    from swtpu.dispatch.autotune import scoring_sig

    f = tmp_path / "tuned.json"
    _write_table_sig(f, [(256, 256, "linear", dict(TUNED, plan="scan")),
                         (256, 256, "affine",
                          dict(TUNED, plan="wavefront")),
                         (256, 256, "affine+sub21",
                          dict(TUNED, plan="scan"))])
    _fresh_policy(monkeypatch, f)

    ep_lin = planmod.choose_exec(256, 256, scoring=Scoring())
    assert (ep_lin.plan, ep_lin.source) == ("scan", "tuned")
    ep_aff = planmod.choose_exec(256, 256, scoring=AFF)
    assert (ep_aff.plan, ep_aff.source) == ("wavefront", "tuned")
    assert scoring_sig(AFF, BLOSUM62) == "affine+sub21"
    ep_sub = planmod.choose_exec(256, 256, scoring=AFF,
                                 substitution=BLOSUM62)
    assert (ep_sub.plan, ep_sub.source) == ("scan", "tuned")
    # a sig with no entries falls back to thresholds, not a wrong sig
    ep_other = planmod.choose_exec(
        256, 256, scoring=Scoring(gap=-4), substitution=BLOSUM62[:20, :20])
    assert ep_other.source == "threshold"
    assert ep_other.plan == "wavefront"


def test_policy_merge_per_signature():
    pa = Policy({"entries": [
        {"m": 64, "n": 64, "sig": "linear",
         "best": dict(TUNED, gcups=50.0), "all": []},
    ]})
    pa.merge({"entries": [
        {"m": 64, "n": 64, "sig": "linear",
         "best": dict(TUNED, gcups=80.0, plan="wavefront"), "all": []},
        {"m": 64, "n": 64, "sig": "affine",
         "best": dict(TUNED, gcups=10.0), "all": []},
    ]})
    ents = {(e["m"], e["n"], e["sig"]): e for e in pa.table["entries"]}
    assert ents[(64, 64, "linear")]["best"]["gcups"] == 80.0   # better wins
    assert ents[(64, 64, "linear")]["best"]["plan"] == "wavefront"
    assert ents[(64, 64, "affine")]["best"]["gcups"] == 10.0   # sig added
    # a worse incoming best never replaces
    pa.merge({"entries": [{"m": 64, "n": 64, "sig": "linear",
                           "best": dict(TUNED, gcups=1.0), "all": []}]})
    assert ents[(64, 64, "linear")]["best"]["gcups"] == 80.0


def test_autopersist_across_processes(tmp_path, fake_gpu, monkeypatch):
    """Two consecutive 'processes': the first observes and persists at
    exit; the second loads the persisted table and benefits."""
    path = tmp_path / "persist.json"
    monkeypatch.setenv("SWTPU_AUTOTUNE_PERSIST", str(path))
    # block the default-table fallback: an empty explicit table
    empty = tmp_path / "empty.json"
    empty.write_text('{"entries": []}')

    # process 1: no prior entries, live observation, explicit persist
    # (atexit registration is pinned separately)
    _fresh_policy(monkeypatch, empty)
    monkeypatch.setattr(planmod, "_persist_state", {"registered": False})
    planmod.observe(512, 512, "scan", 0.001, sig="linear")
    assert planmod._persist_state["registered"]     # atexit hook armed
    assert planmod.persist_session_policy() == str(path)
    assert path.exists()

    # process 2: fresh cache, the persisted observation drives dispatch
    _fresh_policy(monkeypatch)
    monkeypatch.setenv("SWTPU_TUNED_TABLE", str(path))
    ep = planmod.choose_exec(512, 512)
    assert ep.source == "tuned" and ep.plan == "scan"

    # process 2 observes something better and persists: merge keeps max
    planmod.observe(512, 512, "wavefront", 0.0001, sig="linear")
    planmod.persist_session_policy()
    saved = json.loads(path.read_text())
    ent = saved["entries"][0]
    assert ent["best"]["plan"] == "wavefront"
    assert len(ent["all"]) == 2                     # histories concatenated


def test_observe_normalizes_fetch_floor(tmp_path, fake_gpu, monkeypatch):
    """The warm fast path's observe() must feed dispatch-amortized time:
    single-dispatch wall time minus the measured dispatch+fetch floor."""
    import swtpu.engine.align as al

    f = tmp_path / "tuned.json"
    _write_table(f, 128, 128, {"plan": "wavefront", "s": 1, "gcups": 1.0})
    _fresh_policy(monkeypatch, f)
    monkeypatch.setattr(al, "_warm_keys", set())
    monkeypatch.setattr(al, "_floor_cache", {"floor": 10.0})  # huge floor

    a, b = random_pair(128, 128, seed=1)
    al.align(a, b, config=_NO_SIMD, traceback=False)            # cold
    al.align(a, b, config=_NO_SIMD, traceback=False)            # warm
    pol = planmod.session_policy()
    rows = [r for e in pol.table["entries"] for r in e["all"]
            if r.get("kind") == "observed"]
    assert rows, "warm call must observe"
    # with a 10 s floor the correction clamps at 5% of raw wall time,
    # proving the subtraction path ran (raw time here is << 10 s)
    assert rows[-1]["s"] < 1.0


def test_host_simd_crossover_is_derived(monkeypatch):
    """host_simd_max_cells=None derives the crossover from MEASURED
    quantities: on an accelerator, this host's probed per-core SIMD rate x
    the device's measured dispatch+fetch floor — never the SIMD tier's
    shape cap; on the CPU platform the fallthrough is the scan on the
    same cores, so the cap is the SIMD tier's own shape ceiling. An
    explicit value pins it; an unavailable tier derives 0."""
    import swtpu.engine.align as al
    from swtpu import runtime_native as rn
    from swtpu.core import config as cfgmod

    def fresh_cap(rate, floor_s=None, platform="gpu"):
        cfgmod._simd_cap_cache["value"] = None
        monkeypatch.setattr(rn, "measured_simd_gcups", lambda: rate)
        cap = planmod.Capability(platform, "dev", 1, platform == "gpu")
        monkeypatch.setattr(planmod, "capability", lambda: cap)
        monkeypatch.setattr(al, "_floor_cache",
                            {} if floor_s is None else {"floor": floor_s})
        try:
            return cfgmod.derived_host_simd_max_cells()
        finally:
            cfgmod._simd_cap_cache["value"] = None

    try:
        # explicit value wins, no probe
        assert EngineConfig(host_simd_max_cells=123).simd_cells_cap() == 123
        assert _NO_SIMD.simd_cells_cap() == 0
        # measured rate x measured floor
        assert fresh_cap(8.0, 0.005) == 40_000_000
        assert fresh_cap(6.0, 40e-6) == 240_000
        # the floor is measured in-process when not cached yet
        got = fresh_cap(5.0)
        assert 0 <= got < cfgmod.SIMD_SHAPE_LIMIT_CELLS
        # CPU platform: the tier's own eligibility ceiling
        assert fresh_cap(2.0, 0.0002, platform="cpu") \
            == cfgmod.SIMD_SHAPE_LIMIT_CELLS
        # SIMD tier unavailable -> 0 (tier disabled)
        assert fresh_cap(None) == 0
        # the default config routes through the derivation (int either way)
        assert isinstance(EngineConfig().simd_cells_cap(), int)
    finally:
        # never leak a cap derived under monkeypatched probes
        cfgmod._simd_cap_cache["value"] = None


# --- capability resolution -------------------------------------------------


def _device(platform="gpu", cc="9.0", kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(platform=platform, compute_capability=cc,
                                 device_kind=kind, id=0)


def test_capability_on_cpu_platform():
    cap = planmod.capability()
    assert cap.platform == "cpu" and not cap.gpu_kernel
    assert cap.device_count >= 1


@pytest.mark.parametrize("cc,built", [("9.0", True), ("9.0a", True),
                                      ("8.0", False), ("", False)])
def test_resolve_capability_gpu(monkeypatch, cc, built):
    """Only a Hopper card (compute capability 9.x) can run the kernel;
    resolving the capability builds nothing on any card (the build waits
    for the kernel's first call)."""
    from swtpu.kernels import gpu_fill
    seen = []
    monkeypatch.setattr(gpu_fill, "ensure_registered",
                        lambda: seen.append(1))
    monkeypatch.setattr(gpu_fill, "build", lambda: seen.append(1))
    monkeypatch.setattr(planmod.jax, "devices",
                        lambda platform=None: [_device(cc=cc)] * 2)
    cap = planmod.resolve_capability(_device(cc=cc))
    assert cap.gpu_kernel is built and not seen
    assert (cap.platform, cap.device_count) == ("gpu", 2)
    assert cap.device_kind == "NVIDIA H100 80GB HBM3"


def test_capability_needs_kernel_source(tmp_path, monkeypatch):
    """Without csrc/sw_gpu.cu a Hopper card resolves to the scan."""
    from swtpu.kernels import gpu_fill
    monkeypatch.setattr(gpu_fill, "SOURCE", tmp_path / "absent.cu")
    monkeypatch.setattr(planmod.jax, "devices",
                        lambda platform=None: [_device()])
    assert not planmod.resolve_capability(_device()).gpu_kernel


def _no_nvcc(monkeypatch, tmp_path):
    """A Hopper capability on a host where the kernel cannot be built."""
    from swtpu.kernels import gpu_fill
    monkeypatch.setattr(gpu_fill, "_state",
                        {"lib": None, "registered": False, "build_s": None})
    monkeypatch.setattr(gpu_fill, "_nvcc", lambda: None)
    monkeypatch.setattr(gpu_fill, "library_path",
                        lambda: tmp_path / "absent.so")
    gpu_fill._score_fn.cache_clear()
    monkeypatch.setattr(planmod.jax, "devices",
                        lambda platform=None: [_device()])
    cap = planmod.resolve_capability(_device())
    monkeypatch.setattr(planmod, "capability", lambda: cap)
    return cap


def test_missing_kernel_library_raises_on_gpu(tmp_path, monkeypatch):
    """On a GPU platform a kernel that cannot be built raises at its first
    call — it never falls back to the scan. Resolving the capability
    alone does not try the build."""
    import swtpu
    from swtpu.kernels import gpu_fill
    cap = _no_nvcc(monkeypatch, tmp_path)
    assert cap.gpu_kernel
    with pytest.raises(gpu_fill.KernelBuildError, match="nvcc"):
        gpu_fill.score_fn(300, 200)
    a, b = random_pair(300, 200, seed=0)
    with pytest.raises(gpu_fill.KernelBuildError, match="nvcc"):
        swtpu.align(a, b, config=_NO_SIMD, traceback=False)


def test_gpu_without_nvcc_still_runs_scan_routes(tmp_path, monkeypatch):
    """Routes that never run the kernel — batch_score, search, traceback
    refills, the host tier — work on a Hopper host that has no nvcc."""
    import swtpu
    from swtpu.dist.database import pad_queries
    _no_nvcc(monkeypatch, tmp_path)
    aa, bb = random_batch(4, 40, 50, seed=2)
    hits = swtpu.batch_score(aa, bb)
    for k in range(4):
        assert int(hits.scores[k]) == oracle.fill(aa[k], bb[k]).max_score
    ref = np.random.default_rng(5).integers(0, 4, 700).astype(np.int8)
    found = swtpu.search(pad_queries([ref[300:330].copy()], 30), ref,
                         window=256)
    assert (int(found.scores[0]), int(found.ref_pos[0])) == (90, 329)
    a, b = random_pair(40, 30, seed=6)
    assert swtpu.align(a, b).max_score == oracle.fill(a, b).max_score


def test_failed_compile_raises(tmp_path, monkeypatch):
    """A compile error surfaces as KernelBuildError with nvcc's stderr."""
    from swtpu.kernels import gpu_fill
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(gpu_fill, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(gpu_fill, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(gpu_fill, "library_path",
                        lambda: tmp_path / "build" / "lib.so")
    with pytest.raises(gpu_fill.KernelBuildError, match="bad kernel"):
        gpu_fill.build()
    assert not (tmp_path / "build" / "lib.so").exists()


@pytest.mark.parametrize("m,n,cfg,plan", [
    (1024, 1024, EngineConfig(), "wavefront"),
    (25632, 25632, EngineConfig(), "wavefront"),
    (145002, 2000, EngineConfig(), "wavefront"),
    (1024, 1024, EngineConfig(band=16), "scan"),
    (32, 32, EngineConfig(), "host"),
])
def test_choose_exec_on_gpu(fake_gpu, monkeypatch, m, n, cfg, plan):
    _fresh_policy(monkeypatch)
    from swtpu.runtime_native import available
    if plan == "host" and not available():
        plan = "wavefront"
    assert planmod.choose_exec(m, n, cfg).plan == plan


@pytest.mark.parametrize("m,n,cfg", [(1024, 1024, EngineConfig()),
                                     (25632, 25632, EngineConfig()),
                                     (1024, 1024, EngineConfig(band=16))])
def test_choose_exec_on_cpu(monkeypatch, m, n, cfg):
    _fresh_policy(monkeypatch)
    assert planmod.choose_exec(m, n, cfg).plan == "scan"


@pytest.mark.parametrize("plan", [None, "auto", "host", "scan", "wavefront",
                                  "pipeline"])
def test_check_plan_accepts_known(plan):
    planmod.check_plan(plan)


def test_stripe_plan_names_its_replacement():
    import swtpu
    with pytest.raises(ValueError, match="wavefront"):
        planmod.check_plan("stripe")
    with pytest.raises(ValueError, match="wavefront"):
        swtpu.align("ACGT", "ACGT", plan="stripe")
    with pytest.raises(ValueError, match="wavefront"):
        swtpu.score("ACGT", "ACGT", plan="stripe")
    with pytest.raises(ValueError, match="unknown plan"):
        planmod.check_plan("turbo")


def test_wavefront_forced_without_gpu_raises():
    import swtpu
    a, b = random_pair(200, 200, seed=0)
    with pytest.raises(ValueError, match="Hopper"):
        swtpu.align(a, b, traceback=False, plan="wavefront")


@pytest.mark.parametrize("traceback", [False, True])
def test_align_on_gpu_routes_score_only_to_kernel(fake_gpu, traceback):
    """Score-only requests above the host tiers run the kernel; traceback
    requests take the scan (the kernel is score-only)."""
    import swtpu
    a, b = random_pair(300, 200, seed=3)
    r = swtpu.align(a, b, config=_NO_SIMD, traceback=traceback)
    ref = oracle.fill(a, b)
    assert r.plan == ("scan" if traceback else "wavefront")
    assert fake_gpu == ([] if traceback else [(300, 200)])
    assert (r.max_score, (r.max_i, r.max_j)) == (ref.max_score, ref.max_ij)
    assert r.last_cell == int(ref.H[-1, -1])


def test_mesh_routes_align_to_pipeline():
    """An explicit mesh asks for the multi-device pipeline."""
    import jax
    from jax.sharding import Mesh

    import swtpu
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    a, b = random_pair(256, 128, seed=4)
    r = swtpu.align(a, b, traceback=False, mesh=mesh)
    ref = oracle.fill(a, b)
    assert r.plan == "pipeline"
    assert (r.max_score, (r.max_i, r.max_j)) == (ref.max_score, ref.max_ij)
    assert r.last_cell == int(ref.H[-1, -1])


@pytest.mark.parametrize("m,n,D,want", [
    (65536, 16384, 4, 8192),
    (1 << 20, 1 << 20, 8, 1 << 17),
    (256, 128, 4, 128),
    (1000, 50, 4, 50),
    (4096, 4096, 1, 4096),
])
def test_pipeline_block_rows(m, n, D, want):
    """Block height minimizing (n/br + D - 1)(br + m/D) wavefront steps,
    as a power of two within [128, n]."""
    assert planmod.pipeline_block_rows(m, n, D) == want
