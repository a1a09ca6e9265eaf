"""Published peak rates of the devices the benchmark reports against,
keyed by `jax.Device.device_kind`. A device missing here is an error:
a roofline share is never computed against an assumed peak."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense rates, 700 W power limit): 80 GB of
# HBM3 at 3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside
# the tensor cores. JAX reports the SXM part as "NVIDIA H100 80GB HBM3".
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                              "f64_tflops": 34.0},
}


def device_peaks(kind: str | None = None) -> dict:
    """Peak rates of `kind` (default: the first JAX device's kind)."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; add "
                       f"its data-sheet figures to utils/peaks.PEAKS") \
            from None


def peak_hbm_gbps(kind: str | None = None) -> float:
    """Published HBM bandwidth of `kind` in GB/s."""
    return device_peaks(kind)["hbm_gbps"]


def pt_sweep_bytes(cells: int, itemsize: int, pair: bool) -> int:
    """Least HBM traffic of one damped pseudo-transient sweep: read Pr,
    dPrdtau and the RHS, write Pr and dPrdtau (5 fields); the (hi, lo)
    pair sweep also reads and writes the low word (7 fields)."""
    return (7 if pair else 5) * cells * itemsize
