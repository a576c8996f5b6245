"""Entry-point hygiene: one compile-cache location, and measurement
scripts that refuse to run without an accelerator."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from swtpu.core import runtime

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert runtime.compile_cache_dir() == tmp_path / "c"


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_enable_compile_cache_sets_only_that_path(monkeypatch, tmp_path,
                                                  env):
    import jax
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = REPO / ".jax_cache"
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
        want = tmp_path / env
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    assert runtime.enable_compile_cache() == want
    assert seen == [("jax_compilation_cache_dir", str(want))]


def test_no_other_cache_path_in_the_code():
    """Only core/runtime.py names a compilation cache directory."""
    hits = []
    for p in list((REPO / "swtpu").rglob("*.py")) + [
            REPO / "bench.py", REPO / "chip_smoke.py", REPO / "tests" /
            "conftest.py"]:
        text = p.read_text()
        if ("JAX_COMPILATION_CACHE_DIR" in text
                or "jax_compilation_cache_dir" in text) \
                and p.name != "runtime.py":
            hits.append(p.name)
    assert hits == []


def _run(args, cwd, env_extra=None):
    import os
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_the_cpu():
    out = _run(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no accelerator" in out.stderr


def test_chip_smoke_needs_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bench_refuses_the_cpu():
    out = _run(["bench.py"], REPO)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "accelerator" in out.stderr


def test_device_identity_shape():
    from swtpu.instrument.device import device_identity, nvidia_smi_identity
    d = device_identity()
    assert set(d) == {"platform", "kind", "count", "card"}
    assert d["platform"] == "cpu" and d["count"] >= 1
    json.dumps(d)
    assert isinstance(nvidia_smi_identity(), str)


def test_chip_smoke_explains_window_edge_differences():
    """The four-card phase's check of sharded vs one-card search: a
    difference passes only as a window-edge cut (the higher side is the
    exact whole-reference score and no window of the lower side holds
    the optimal alignment); the same scores under the wrong cut raise."""
    import importlib.util

    import numpy as np

    from swtpu.dist.database import pad_queries, search, window_spans
    from swtpu.dist.mesh import data_mesh

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    rng = np.random.default_rng(163)
    L, qlen, window = 4096, 32, 256
    ref = rng.integers(0, 4, L).astype(np.int8)
    one, w = window_spans(L, qlen, 1, window)
    eight, _ = window_spans(L, qlen, 8, window)

    def held(st, lo, hi):
        return bool(((st <= lo) & (st + w > hi)).any())

    p = next(p for p in range(L - 40)
             if held(eight, p, p + 39) and not held(one, p, p + 39))
    read = np.delete(ref[p: p + 40], np.arange(2, 40, 5))
    q = pad_queries([read, rng.integers(0, 4, 32).astype(np.int8)], qlen)
    h8 = search(q, ref, mesh=data_mesh(8, platform="cpu"), window=window)
    h1 = search(q, ref, window=window)
    rows = smoke._explain_differences(q, ref, h8, h1, 8, window=window)
    assert [r[:5] for r in rows] == [(0, int(h8.scores[0]),
                                      int(h8.scores[0]), int(h1.scores[0]),
                                      1)]
    assert (rows[0][5], rows[0][6]) == (p, p + 39)
    with pytest.raises(AssertionError, match="holds the alignment"):
        smoke._explain_differences(q, ref, h1, h8, 8, window=window)
