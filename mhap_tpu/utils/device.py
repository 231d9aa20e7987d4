"""The accelerator a measurement ran on.

Every timing this repository reports names its device.  A measurement
path that finds no GPU stops: a CPU number is never reported under a
device metric.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_lines() -> list[str]:
    """``name, power.limit`` of every visible card, one line each, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def gpu_device_info() -> dict:
    """platform / device_kind / count as JAX reports them, plus the first
    card's name and power limit.  Raises SystemExit (non-zero status, no
    result printed) when JAX's default device is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's default platform is {devs[0].platform!r}")
    name, limit = (f.strip() for f in nvidia_smi_lines()[0].split(",", 1))
    return dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                count=len(devs), name=name, power_limit=limit)
