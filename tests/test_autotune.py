"""Autotuner Policy tests: the plan-level measured table."""

import pytest

from swtpu.dispatch.autotune import Policy, load, save


def test_policy_empty_falls_back():
    p = Policy()
    c = p.choose(1000, 1000)
    assert c["plan"] in ("scan", "wavefront")


def test_policy_observe_and_choose():
    p = Policy()
    p.observe(1024, 1024, "scan", seconds=0.1)
    p.observe(1024, 1024, "wavefront", seconds=0.01)
    c = p.choose(1024, 1024)
    assert c["plan"] == "wavefront"
    # nearest-size lookup
    c2 = p.choose(1100, 1000)
    assert c2["plan"] == "wavefront"
    # a worse observation doesn't displace the best
    p.observe(1024, 1024, "scan", seconds=1.0)
    assert p.choose(1024, 1024)["plan"] == "wavefront"


def test_save_load_roundtrip(tmp_path):
    p = Policy()
    p.observe(512, 512, "scan", 0.05)
    f = tmp_path / "tuned.json"
    save(p.table, str(f))
    t = load(str(f))
    assert t["entries"][0]["best"]["plan"] == "scan"
    assert load(str(tmp_path / "missing.json")) is None


def test_choose_plan_uses_tuned_table(tmp_path, monkeypatch, fake_gpu):
    import json
    from swtpu.dispatch import plan as planmod

    f = tmp_path / "tuned.json"
    f.write_text(json.dumps({"entries": [
        {"m": 1000, "n": 1000,
         "best": {"plan": "scan", "s": 0.001, "gcups": 1.0},
         "all": []}]}))
    monkeypatch.setenv("SWTPU_TUNED_TABLE", str(f))
    monkeypatch.setattr(planmod, "_policy_cache",
                        {"loaded": False, "policy": None})
    assert planmod.choose_plan(900, 900) == "scan"
    # without a table, the static tiers apply
    monkeypatch.delenv("SWTPU_TUNED_TABLE")
    monkeypatch.setattr(planmod, "_policy_cache",
                        {"loaded": False, "policy": None})
    monkeypatch.chdir(tmp_path)
    assert planmod.choose_plan(900, 900) == "wavefront"
    from swtpu.runtime_native import available
    # tiny problems: native host tier when the lib is built
    assert planmod.choose_plan(8, 8) == ("host" if available()
                                         else "wavefront")


def test_best_promotion_is_kind_aware():
    """A floor-subtracted single observation (kind='observed', up to ~20x
    optimistic when the dispatch floor dominates a tiny problem) must not
    displace a dispatch-amortized sweep best; sweep rows always supersede
    observed bests; within one methodology higher GCUPS wins."""
    pol = Policy({"entries": []})
    pol.observe(512, 512, "scan", seconds=1e-3, kind="sweep")
    e = pol.table["entries"][0]
    assert e["best"]["kind"] == "sweep"

    # an optimistic observation: 10x faster on paper
    pol.observe(512, 512, "wavefront", seconds=1e-4, kind="observed")
    assert e["best"]["kind"] == "sweep" and e["best"]["plan"] == "scan", \
        "observed row displaced a sweep best"

    # observed rows still compete among themselves when no sweep exists
    pol.observe(256, 256, "scan", seconds=1e-3)
    pol.observe(256, 256, "wavefront", seconds=1e-4)
    e2 = [x for x in pol.table["entries"] if x["m"] == 256][0]
    assert e2["best"]["plan"] == "wavefront"

    # a sweep row supersedes an observed best even at lower paper GCUPS
    pol.observe(256, 256, "scan", seconds=5e-4, kind="sweep")
    assert e2["best"]["kind"] == "sweep" and e2["best"]["plan"] == "scan"

    # merge applies the same rule
    other = Policy({"entries": []})
    other.observe(512, 512, "wavefront", seconds=1e-5, kind="observed")
    pol.merge(other.table)
    assert e["best"]["kind"] == "sweep" and e["best"]["plan"] == "scan"


@pytest.mark.parametrize("mode,sub_n,want", [
    ("linear", None, "linear"),
    ("affine", None, "affine"),
    ("affine", 21, "affine+sub21"),
    ("linear", 4, "linear+sub4"),
])
def test_scoring_sig(mode, sub_n, want):
    import numpy as np

    from swtpu import Scoring
    from swtpu.dispatch.autotune import scoring_sig
    sub = None if sub_n is None else np.zeros((sub_n, sub_n), np.int32)
    assert scoring_sig(Scoring(mode=mode), sub) == want


def test_sig_digest_tracks_plan_changes():
    p = Policy()
    p.observe(512, 512, "scan", 1e-2)
    p.observe(256, 256, "scan", 1e-2, sig="affine")
    before = p.sig_digest("linear")
    assert before == ((512, 512, "scan"),)
    p.observe(256, 256, "wavefront", 1e-4, sig="affine")
    assert p.sig_digest("linear") == before       # other sig: unchanged
    p.observe(512, 512, "wavefront", 1e-4)
    assert p.sig_digest("linear") == ((512, 512, "wavefront"),)
