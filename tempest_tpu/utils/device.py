"""Which device a measurement ran on.

Every number the benchmarks print names its device: JAX's platform, device
kind and device count, and the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load, so
a time without its power limit cannot be compared with another).  The card
is queried from a child process that never imports JAX.  A measurement path
that finds no GPU fails; it does not fall back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess

__all__ = ["card_info", "device_record", "require_gpu"]

SMI_QUERY = ["--query-gpu=name,power.limit", "--format=csv,noheader"]


def card_info() -> list[str]:
    """One ``"<name>, <power limit>"`` line per card, verbatim from
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``;
    ``[]`` where there is no ``nvidia-smi``."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    out = subprocess.run([smi, *SMI_QUERY], capture_output=True, text=True,
                         timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def require_gpu(what: str) -> list:
    """JAX's devices, or ``SystemExit`` (non-zero) when the first one is not
    a GPU: ``what`` measures or checks the card and has no CPU fallback."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{what} needs an NVIDIA GPU; JAX found {len(devs)} "
            f"{devs[0].platform} device(s) ({devs[0].device_kind})")
    return devs


def device_record() -> dict:
    """Platform, device kind and count as JAX reports them, plus the
    cards' names and power limits."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "count": len(devs),
        "cards": card_info(),
    }
