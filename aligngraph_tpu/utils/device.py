"""Which device a measurement ran on.

Every timing the repository prints names its device: JAX's platform,
device kind and count, and the card's name and power limit as nvidia-smi
reports them (a card set below its maximum power runs slower under load).
"""

from __future__ import annotations

import os
import subprocess
import sys


def card_line() -> str:
    """`name, power.limit` of the GPU(s) from nvidia-smi ("" without)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def measurement_device() -> dict:
    """The device fields of a benchmark's JSON line.

    Exits non-zero when JAX finds no GPU, unless JAX_PLATFORMS=cpu was set
    explicitly (a rehearsal; the line then says "cpu")."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"no GPU: JAX's first device is {dev.platform!r} (set "
              f"JAX_PLATFORMS=cpu for a CPU rehearsal)", file=sys.stderr)
        sys.exit(2)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card_line()}
