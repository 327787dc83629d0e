"""Which accelerator a measurement runs on.

Importing this module does not import JAX, so ``card_info`` can run
before JAX reserves the card's memory.
"""

from __future__ import annotations

import subprocess


def card_info() -> str | None:
    """``name, power.limit`` of each NVIDIA card, one line per card, as
    ``nvidia-smi`` reports them; None where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def require_gpu():
    """JAX's first device; raises RuntimeError unless it is a GPU (a
    measurement never falls back to the CPU)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is on platform {dev.platform!r}")
    return dev


def device_record(dev) -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
