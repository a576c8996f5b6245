"""Test harness: on the CPU platform, 8 virtual devices so every
multi-device path (shard_map batch, pipeline halo exchange) is exercised
without accelerator hardware — a capability the reference lacks entirely
(its only environment detection is the GPU probe, hasGPU.cpp:17-30).

Tests marked ``gpu`` need a CUDA device; they decide inside the ``gpu``
fixture whether one is present and skip here with a reason. Run them on a
GPU machine with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if _CPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent jit cache: the test matrix compiles many distinct shapes; cache
# them across runs to keep the suite fast.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402

from swtpu.core.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()
if _CPU:
    # pin placement only when the suite runs on the CPU platform; a GPU
    # run must not silently land its gpu-marked tests on the host
    jax.config.update("jax_default_device", "cpu")


@pytest.fixture
def gpu():
    """The first CUDA device, or a skip when this process has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA GPU (runs on the card, not on the CPU)")
    return devs[0]


@pytest.fixture
def fake_gpu(monkeypatch):
    """Make dispatch see a Hopper GPU with the kernel built, while work
    still runs on the CPU: capability() reports the card, and the kernel's
    score_fn is stood in for by the scan with the same signature and
    outputs (the kernel itself is checked against the scan on the card).
    Returns the list of (m, n) shapes the stand-in was asked for."""
    import functools

    import jax.numpy as jnp

    from swtpu.core.substitution import embed_sentinels
    from swtpu.dispatch import plan as planmod
    from swtpu.kernels import gpu_fill
    from swtpu.kernels.scan_fill import scan_fill

    cap = planmod.Capability(platform="gpu",
                             device_kind="NVIDIA H100 80GB HBM3",
                             device_count=1, gpu_kernel=True)
    monkeypatch.setattr(planmod, "capability", lambda: cap)
    calls = []

    @functools.lru_cache(maxsize=None)
    def stand_in(m, n, scoring, sub_key):
        table = None if sub_key is None else jnp.asarray(embed_sentinels(
            np.frombuffer(sub_key[1], np.int32).reshape(sub_key[0])))

        @jax.jit
        def fn(a, b):
            o = scan_fill(a, b, scoring=scoring, sub_table=table)
            return o.max_score, o.max_i, o.max_j, o.last_cell
        return fn

    def score_fn(m, n, scoring=None, substitution=None, rows_per_lane=None):
        from swtpu import Scoring
        calls.append((m, n))
        key = None
        if substitution is not None:
            s32 = np.ascontiguousarray(np.asarray(substitution, np.int32))
            key = (s32.shape, s32.tobytes())
        return stand_in(m, n, scoring or Scoring(), key)

    monkeypatch.setattr(gpu_fill, "score_fn", score_fn)
    return calls
