"""Identity of the device a measurement ran on.

Every number the benchmark and the on-card smoke test print carries the
platform, device kind and count as JAX reports them, plus the card's name
and power limit as ``nvidia-smi`` reports them: a card capped below its
maximum power runs slower under load, so a number without its card and
limit cannot be compared with another.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_identity() -> str:
    """``name, power.limit`` of each GPU (one per line) exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, or a note saying nvidia-smi gave nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    text = out.stdout.strip()
    if out.returncode != 0 or not text:
        return f"nvidia-smi unavailable (exit {out.returncode})"
    return text


def device_identity() -> dict:
    """platform / device kind / count of the default backend + the
    nvidia-smi identity of the first card."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs),
            "card": nvidia_smi_identity().splitlines()[0]}
