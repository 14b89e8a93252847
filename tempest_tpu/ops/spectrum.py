"""Spectral estimation: periodogram, Welch PSD, waterfall.

Capability parity with the reference's ``GetSpectrum`` module
(``/root/reference/src/GetSpectrum.jl:21-66``), re-designed for XLA: the Welch
and waterfall estimators reshape the signal into a (segments, fft_size) matrix
and run one *batched* FFT instead of a Julia per-segment loop — a single
batched FFT whose segment axis can also be sharded across devices (the
per-segment ``abs2`` accumulation is a plain ``psum``).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["get_spectrum", "get_welch", "get_welch_sharded", "welch_accumulate", "get_waterfall"]

_EPS = 1e-30  # keep log10 finite; 10*log10(1e-30) = -300 dB floor


def _freq_axis(n: int, fs: float) -> jnp.ndarray:
    return (jnp.arange(n) / n - 0.5) * fs


def get_spectrum(
    fs, sig: jnp.ndarray | None = None, n: int | None = None
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Periodogram in dB over a centred frequency axis
    (reference ``getSpectrum``, ``GetSpectrum.jl:21-30``).

    Accepts complex or real signals of any float/int dtype.  The fs-less
    form ``get_spectrum(sig)`` returns a normalised frequency axis in
    [-0.5, 0.5), like the reference's ``getSpectrum(sig) = getSpectrum(1,
    sig)`` (``GetSpectrum.jl:30``)."""
    if sig is None:
        fs, sig = 1.0, fs
    if n is None:
        n = sig.shape[0]
    spec = jnp.fft.fftshift(jnp.fft.fft(sig[:n]))
    power = 10.0 * jnp.log10(jnp.abs(spec) ** 2 + _EPS)
    return _freq_axis(n, fs), power


def get_welch(
    fs: float, sig: jnp.ndarray, fft_size: int = 1024
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Welch-style PSD: mean of per-segment ``|FFT|^2`` over non-overlapping
    rectangular segments, in dB (reference ``getWelch``,
    ``GetSpectrum.jl:36-52`` — which *sums* rather than averages; the constant
    offset does not change dB shape, we keep the reference's sum).
    """
    n_seg = sig.shape[0] // fft_size
    segs = sig[: n_seg * fft_size].reshape(n_seg, fft_size)
    acc = jnp.sum(jnp.abs(jnp.fft.fft(segs, axis=-1)) ** 2, axis=0)
    power = 10.0 * jnp.log10(jnp.fft.fftshift(acc) + _EPS)
    return _freq_axis(fft_size, fs), power


def welch_accumulate(segs: jnp.ndarray) -> jnp.ndarray:
    """Sum of per-segment ``|FFT|^2`` for a (n_seg, fft_size) batch — the
    reduction inside Welch, exposed so sharded callers can ``psum`` partial
    accumulations across devices."""
    return jnp.sum(jnp.abs(jnp.fft.fft(segs, axis=-1)) ** 2, axis=0)


def get_welch_sharded(
    fs: float,
    sig: jnp.ndarray,
    mesh,
    fft_size: int = 1024,
    axis: str = "blocks",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Welch PSD with the segment axis sharded across a device mesh: each
    device FFTs and accumulates its local segments, one ``psum`` combines.
    Segment counts must divide the mesh axis size (trailing samples dropped,
    like the single-device version).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = mesh.shape[axis]
    n_seg = sig.shape[0] // fft_size
    n_seg -= n_seg % n_dev
    if n_seg == 0:
        raise ValueError("signal too short for one segment per device")
    segs = sig[: n_seg * fft_size].reshape(n_seg, fft_size)
    segs = jax.device_put(segs, NamedSharding(mesh, P(axis, None)))

    def local(s):
        return jax.lax.psum(welch_accumulate(s), axis)[None]

    # Replicated output (the psum already makes every device's row equal;
    # out_shardings makes that addressable from EVERY process in a
    # multi-controller run — indexing a P(axis)-sharded row would only be
    # readable from the process owning device 0).
    acc = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis)
        ),
        out_shardings=NamedSharding(mesh, P()),
    )(segs)[0]
    power = 10.0 * jnp.log10(jnp.fft.fftshift(acc) + _EPS)
    return _freq_axis(fft_size, fs), power


def get_waterfall(
    fs: float, sig: jnp.ndarray, fft_size: int = 1024
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Time × frequency power matrix (reference ``getWaterfall``,
    ``GetSpectrum.jl:54-66``).  Returns (time_axis, freq_axis, power) with
    ``power[f, t]`` matching the reference's (fft_size, n_seg) layout."""
    n_seg = sig.shape[0] // fft_size
    segs = sig[: n_seg * fft_size].reshape(n_seg, fft_size)
    power = jnp.abs(jnp.fft.fftshift(jnp.fft.fft(segs, axis=-1), axes=-1)) ** 2
    t_ax = jnp.arange(n_seg) * (fft_size / fs)
    return t_ax, _freq_axis(fft_size, fs), power.T
