"""Which device a measurement ran on.

Every result a measurement prints names its device: JAX's platform,
device kind and count, and the card's name and power limit as nvidia-smi
reports them (a card set below its maximum power runs slower under load).
A measurement that finds no GPU fails; it does not fall back to the CPU.
"""

from __future__ import annotations

import subprocess


def check_gpu(devices, count: int = 1) -> None:
    """Raise RuntimeError unless ``devices`` holds at least ``count`` GPUs
    and the first of them is a GPU."""
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX's first device is {kind}")
    n_gpu = sum(d.platform == "gpu" for d in devices)
    if n_gpu < count:
        raise RuntimeError(f"{count} GPUs needed, JAX finds {n_gpu}")


def card_lines() -> list[str]:
    """nvidia-smi's "name, power limit" of each card, read by a child
    process that does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_record(devices) -> dict:
    """The device fields every printed result carries."""
    d = devices[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(devices), "cards": card_lines()}
