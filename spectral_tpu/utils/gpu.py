"""The accelerator a measurement runs on.

Measurement scripts (bench.py, chip_smoke.py) run on an NVIDIA GPU or not at
all: a number taken on the host CPU must never be printed under a device's
name. These helpers refuse any other platform and name the card, with its
power limit, the way ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """The JAX devices, or RuntimeError when JAX found no GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devs[0].platform!r} "
            f"({devs[0].device_kind}); measurements need an NVIDIA GPU")
    return devs


def card_identity() -> str:
    """'name, power limit' of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it (a card set below its maximum power runs slower under load,
    so every number is reported beside it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    return lines[0]
