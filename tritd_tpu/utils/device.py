"""The device a measurement runs on, and the refusal to measure elsewhere.

Every timed row names its device: JAX's platform, `device_kind` and device
count, and the card's name and power limit as `nvidia-smi` reports them (a
card set below its maximum power runs slower under load, so a time without
its power limit cannot be compared with another).
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)


def nvidia_smi_name_and_power() -> str:
    """`name, power.limit` of every card, one line each, read by an
    `nvidia-smi` child process (which does not touch JAX)."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=60,
        check=True,
    )
    return out.stdout.strip()


def gpu_device_info(jax) -> dict:
    """Device description for result rows; raises SystemExit unless JAX's
    first device is a GPU — a measurement never falls back to the CPU."""
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"refusing to measure on platform {platform!r}: a GPU is required"
        )
    return {
        "platform": platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "nvidia_smi": nvidia_smi_name_and_power(),
    }
