"""Per-kernel roofline accounting (SURVEY.md §5: the counterpart of the
reference's ad-hoc wall-clock meters is per-kernel roofline numbers).

``roofline(fn, *args)`` compiles a jittable function and reports the XLA cost
model's FLOPs and bytes accessed and the arithmetic intensity; given the
device's peaks (:func:`device_peaks`) it says which roof binds and the
speed-of-light time.  Pair with a time measured on the device to get the
achieved fraction of peak.  There is no default device: a roofline share
against an assumed peak is not a measurement.

Caveat: the XLA cost model can grossly overestimate gather traffic (it
charged ~800 B per gathered element for the flat-gather resampler); treat
``bytes`` as an upper bound and trust measured times for rankings.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PEAKS", "RooflineReport", "device_peaks", "roofline"]

# Published single-card peaks, dense rates without sparsity, keyed by
# ``jax.Device.device_kind``.  Source: NVIDIA H100 Tensor Core GPU data
# sheet (SXM part, 700 W).  A card set below 700 W (``nvidia-smi
# --query-gpu=power.limit``) cannot hold these under a matrix-heavy load, so
# report a share of them with the card's power limit beside it.
PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,
        "tf32": 495e12,
        "f32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str | None = None, compute: str = "bf16") -> dict:
    """``{"flops_per_s", "bytes_per_s"}`` for ``device_kind`` (default: the
    first JAX device's) at the ``compute`` precision ("bf16", "tf32" or
    "f32").  An unknown device is an error, not a default."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        table = PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None
    if compute not in table:
        raise ValueError(f"unknown compute precision {compute!r}; "
                         f"known: {sorted(k for k in table if k != 'hbm_bytes_per_s')}")
    return {"flops_per_s": table[compute], "bytes_per_s": table["hbm_bytes_per_s"]}


@dataclasses.dataclass
class RooflineReport:
    flops: float
    bytes_accessed: float
    transcendentals: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed else float("inf")

    def bound(self, peaks: dict) -> str:
        ridge = peaks["flops_per_s"] / peaks["bytes_per_s"]
        return "compute" if self.arithmetic_intensity >= ridge else "memory"

    def speed_of_light_s(self, peaks: dict) -> float:
        """Lower-bound execution time from whichever roof binds."""
        return max(
            self.flops / peaks["flops_per_s"],
            self.bytes_accessed / peaks["bytes_per_s"],
        )

    def achieved_fraction(self, measured_s: float, peaks: dict) -> float:
        sol = self.speed_of_light_s(peaks)
        return sol / measured_s if measured_s > 0 else 0.0

    def summary(self, peaks: dict, measured_s: float | None = None) -> str:
        parts = [
            f"{self.flops/1e9:.2f} GFLOP",
            f"{self.bytes_accessed/1e9:.3f} GB accessed",
            f"AI {self.arithmetic_intensity:.2f} flop/B",
            f"{self.bound(peaks)}-bound",
            f"speed-of-light {self.speed_of_light_s(peaks)*1e3:.3f} ms",
        ]
        if measured_s is not None:
            parts.append(
                f"measured {measured_s*1e3:.3f} ms "
                f"({100*self.achieved_fraction(measured_s, peaks):.1f}% of roof)"
            )
        return " | ".join(parts)


def roofline(fn, *args, **kwargs) -> RooflineReport:
    """Compile ``fn(*args)`` (jit-wrapping if needed) and report its cost
    analysis."""
    import jax

    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    cost = jitted.lower(*args, **kwargs).compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0] if cost else {}
    cost = cost or {}
    return RooflineReport(
        flops=float(cost.get("flops", 0.0)),
        bytes_accessed=float(cost.get("bytes accessed", 0.0)),
        transcendentals=float(cost.get("transcendentals", 0.0)),
    )
