"""Autotuning — the runtime analog of tuneCutoff.sh and Apollo.

The reference tunes its serial/parallel CUTOFF by sed-rewriting parameters.h
and rebuilding over {1..1024} (tuneCutoff.sh:1-15), and v8 delegates the
per-diagonal policy to Apollo's measured-timing model
(omp_smithW-v8-apollo.cpp:304-420). Here tuning is runtime and at plan
level:

* `save()/load()` persist the tuned table as JSON (no rebuilds);
* `Policy` is the Apollo analog: it picks the plan for a problem size from
  the tuned table (nearest measured size), and can update online from
  observed timings — measured cost replaces the hand-set thresholds.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.config import Scoring
from ..instrument.metrics import gcups


def scoring_sig(scoring: Optional[Scoring] = None,
                substitution=None) -> str:
    """Scoring signature keying tuned-table entries: the measured winners
    can differ by gap mode and substitution table, so a table match is
    only valid within one signature — the Apollo per-region analog
    (omp_smithW-v8-apollo.cpp:305-318: one model per code region)."""
    base = "affine" if (scoring is not None and scoring.is_affine) \
        else "linear"
    if substitution is None:
        return base
    return f"{base}+sub{np.asarray(substitution).shape[0]}"


def save(table: dict, path="swtpu_tuned.json") -> None:
    Path(path).write_text(json.dumps(table, indent=1))


def load(path="swtpu_tuned.json") -> Optional[dict]:
    p = Path(path)
    return json.loads(p.read_text()) if p.exists() else None


def _promotes(row: dict, best: dict) -> bool:
    """Kind-aware best-promotion: compare like with like. Sweep rows are
    dispatch-amortized measurements; 'observed' rows are single live
    dispatches with the dispatch+fetch floor subtracted (clamped at 5% of
    the raw time in engine/align.py — up to ~20x optimistic when the
    floor dominates a tiny problem), so an observed row may only displace
    another observed best. A sweep-methodology row always supersedes an
    observed best (methodology upgrade), and an observed row never
    displaces a sweep best. Rows without a 'kind' predate the tag and
    were sweep-written — treat as sweep."""
    rk = row.get("kind", "sweep")
    bk = best.get("kind", "sweep")
    r_sweep = rk.startswith("sweep")
    b_sweep = bk.startswith("sweep")
    if r_sweep != b_sweep:
        return r_sweep
    return row["gcups"] > best["gcups"]


_policy_uids = itertools.count()


@dataclasses.dataclass
class Policy:
    """Measured-cost plan selector (the Apollo analog: the model is a table
    of observed timings instead of hand thresholds; `observe` updates it
    online the way region->end() feeds Apollo's model).

    ``uid`` (process-unique, never reused — unlike id()) and ``version``
    (bumped on every in-place mutation) let caches keyed on a policy's
    CONTENT — e.g. the memoized database searcher — invalidate when new
    observations land or the policy is replaced."""

    table: Optional[dict] = None
    uid: int = dataclasses.field(default_factory=lambda: next(_policy_uids))
    version: int = 0

    def choose_near(self, m: int, n: int, max_cells_ratio: float = 6.0,
                    max_aspect_ratio: float = 4.0,
                    sig: str = "linear") -> Optional[dict]:
        """Best measured config of the nearest same-signature entry in
        (cells, aspect) log-space, or None when nothing is near enough —
        shape matters (the engine's transpose trick is worth ~2x on thin
        problems), so a 2000 x 145002 rectangle must not silently resolve
        to a square entry, and a tiny problem must not inherit a 25632^2
        config. The signature gate keeps a linear-DNA champion from
        landing on BLOSUM+affine calls, whose measured winners differ
        (entries without a sig are legacy linear)."""
        import math
        if not self.table or not self.table.get("entries"):
            return None
        cands = [e for e in self.table["entries"]
                 if e.get("sig", "linear") == sig]
        if not cands:
            return None
        cells, aspect = m * n, m / n

        def dist(e):
            dc = abs(math.log(max(e["m"] * e["n"], 1) / cells))
            da = abs(math.log((e["m"] / e["n"]) / aspect))
            return dc, da

        entry = min(cands, key=lambda e: sum(dist(e)))
        dc, da = dist(entry)
        # a measured winner is size-specific, so the cells gate is
        # deliberately tight; beyond it the static tiers generalize better
        if dc > math.log(max_cells_ratio) or da > math.log(max_aspect_ratio):
            return None
        return dict(entry["best"])

    def sig_digest(self, sig: str) -> tuple:
        """Hashable snapshot of this table's decisions for ONE signature
        (each matching entry's shape + best config). Caches keyed on a
        policy's content — e.g. the memoized database searcher — use
        this instead of ``version`` so they invalidate only when an
        observation lands in THEIR signature, not on every observe()
        for unrelated shapes or scorings."""
        if not self.table:
            return ()
        return tuple(
            (e["m"], e["n"], e["best"].get("plan"))
            for e in self.table.get("entries", [])
            if e.get("sig", "linear") == sig)

    def choose(self, m: int, n: int, sig: str = "linear") -> dict:
        got = self.choose_near(m, n, sig=sig)
        if got is not None:
            return got
        from .plan import choose_plan
        return {"plan": choose_plan(m, n)}

    def observe(self, m: int, n: int, plan: str, seconds: float,
                sig: str = "linear", kind: str = "observed"):
        """``kind`` records the timing methodology ('observed' = one live
        dispatch incl. the result fetch, 'sweep' = dispatch-amortized) so
        best-promotion and merges compare like with like."""
        if self.table is None:
            self.table = {"entries": []}
        self.version += 1
        row = {"plan": plan, "s": seconds,
               "gcups": gcups(m * n, seconds), "kind": kind}
        for e in self.table["entries"]:
            if e["m"] == m and e["n"] == n \
                    and e.get("sig", "linear") == sig:
                e["all"].append(row)
                if len(e["all"]) > 64:       # bounded history: every warm
                    del e["all"][:-64]       # align() call observes
                if _promotes(row, e["best"]):
                    e["best"] = row
                return
        self.table["entries"].append({"m": m, "n": n, "sig": sig,
                                      "best": row, "all": [row]})

    def merge(self, other: Optional[dict]) -> None:
        """Fold another table's entries in (cross-execution accumulation,
        the APOLLO_CROSS_EXECUTION analog, run-v8.sh:15): per (m, n, sig),
        the better-GCUPS best wins and histories concatenate (bounded)."""
        if not other or not other.get("entries"):
            return
        if self.table is None:
            self.table = {"entries": []}
        self.version += 1
        mine = {(e["m"], e["n"], e.get("sig", "linear")): e
                for e in self.table["entries"]}
        for oe in other["entries"]:
            key = (oe["m"], oe["n"], oe.get("sig", "linear"))
            if key not in mine:
                self.table["entries"].append(dict(oe))
                continue
            e = mine[key]
            have = e.get("all", [])
            # exact-duplicate rows appear when a session was seeded from
            # the very table it later merges back into; drop them
            fresh = [r for r in oe.get("all", []) if r not in have]
            e["all"] = (have + fresh)[-64:]
            if _promotes(oe["best"], e["best"]):
                e["best"] = dict(oe["best"])
