"""Demodulation kernels.

Capability parity with the reference's ``Demodulation.jl``
(``/root/reference/src/Demodulation.jl:17-35``): AM envelope, inverted
normalised AM, and the FM discriminator.  These are pure element-wise jnp ops —
XLA fuses them into whatever consumes them (the envelope feeds straight into
the resampler in the jitted pipeline, so no extra device-memory round trip
happens), replacing the reference's ``@inbounds @simd`` loops.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "am_demod",
    "am_demod_power",
    "am_envelope_from_iq",
    "am_envelope_from_iq_planar",
    "am_power_from_iq",
    "fm_demod_from_iq",
    "fm_demod_from_iq_planar",
    "fm_demod_rows",
    "invert_am_demod",
    "fm_demod",
    "to_planar_iq",
]

# One-hot lane matrices for de-interleaving a 128-word row as a matmul
# instead of a strided minor-axis access (``x.reshape(-1, 2)[:, 0]``), a
# formulation chosen for an accelerator whose strided access lowered badly;
# which one the GPU prefers is not measured yet.  A one-hot matmul is a pure
# data movement only at full precision (MOVE_PRECISION): at DEFAULT the GPU
# runs it as a TF32 GEMM, which keeps 10 mantissa bits of I^2 and Q^2, and
# the resampler's later bf16 cast of the envelope turns those small errors
# into whole-ulp flips of the cast samples.  On an H100 at 1080p60 that
# alone moved the default streaming step 0.650% of the image range from the
# "highest" oracle (0.131% with exact moves; the chain's TF32 budget is
# 0.5%), and forcing TF32 on these dots gave the same 0.650%.  At full
# precision the movement is exact on every backend, and it is a small
# (128, 64) contraction.
MOVE_PRECISION = jax.lax.Precision.HIGHEST

_PAIRSUM = np.zeros((128, 64), np.float32)
_PAIRSUM[np.arange(128), np.arange(128) // 2] = 1.0
_EVEN = np.zeros((128, 64), np.float32)
_EVEN[np.arange(0, 128, 2), np.arange(64)] = 1.0
_ODD = np.zeros((128, 64), np.float32)
_ODD[np.arange(1, 128, 2), np.arange(64)] = 1.0


def _rows128(iq: jnp.ndarray) -> tuple[jnp.ndarray, int]:
    """Pad a flat word vector to a multiple of 128 and shape to (R, 128)."""
    n_words = iq.shape[0]
    pad = (-n_words) % 128
    if pad:
        iq = jnp.concatenate([iq, jnp.zeros((pad,), iq.dtype)])
    return iq.astype(jnp.float32).reshape(-1, 128), n_words // 2


def am_envelope_from_iq(iq: jnp.ndarray, scale: float = 1.0) -> jnp.ndarray:
    """AM envelope straight from an *interleaved* I/Q vector (int16 or
    float32, shape (2N,)) — no complex dtype on the device.

    SDR hardware delivers interleaved int16 I/Q (the reference's ``:short``
    capture format, ``DatBinaryFiles.jl:47-49``); converting to complex64 on
    the host doubles the host→device transfer and forces complex arithmetic
    on the device.  The pair sum ``I^2 + Q^2`` runs as one (128, 64) one-hot
    matmul over squared 128-word rows (see ``_PAIRSUM``).
    """
    rows, n = _rows128(iq)
    e2 = jnp.dot(rows * rows, jnp.asarray(_PAIRSUM),
                 preferred_element_type=jnp.float32, precision=MOVE_PRECISION)
    return scale * jnp.sqrt(e2).reshape(-1)[:n]


def am_power_from_iq(iq: jnp.ndarray) -> jnp.ndarray:
    """Squared envelope ``I^2 + Q^2`` from interleaved words — what the
    timing estimators feed the autocorrelation (``GUI.jl:70``); no sqrt."""
    rows, n = _rows128(iq)
    e2 = jnp.dot(rows * rows, jnp.asarray(_PAIRSUM),
                 preferred_element_type=jnp.float32, precision=MOVE_PRECISION)
    return e2.reshape(-1)[:n]


def am_envelope_from_iq_planar(iq2: jnp.ndarray, scale: float = 1.0) -> jnp.ndarray:
    """AM envelope from *planar* I/Q — shape (2, N), row 0 = I, row 1 = Q.

    The interleaved wire format needs a stride-2 minor-axis de-interleave on
    the device.  De-interleave once on the HOST instead (``to_planar_iq`` —
    a cheap numpy transpose while the device computes the previous block)
    and the device does only contiguous elementwise work."""
    xf = iq2.astype(jnp.float32)
    return scale * jnp.sqrt(xf[0] ** 2 + xf[1] ** 2)


def fm_demod_from_iq_planar(iq2: jnp.ndarray) -> jnp.ndarray:
    """FM discriminator from planar (2, N) I/Q words (see
    :func:`fm_demod_from_iq`)."""
    xf = iq2.astype(jnp.float32)
    re, im = xf[0], xf[1]
    re0, im0 = re[:-1], im[:-1]
    re1, im1 = re[1:], im[1:]
    disc = jnp.arctan2(im1 * re0 - re1 * im0, re1 * re0 + im1 * im0)
    return jnp.concatenate([jnp.zeros((1,), disc.dtype), disc])


def to_planar_iq(words: "np.ndarray") -> "np.ndarray":
    """Host-side de-interleave: (2N,) interleaved I/Q words → contiguous
    (2, N).  Accepts int16/float32 interleaved words or complex64 (viewed as
    float32 words, zero-copy)."""
    if np.iscomplexobj(words):
        words = np.ascontiguousarray(words, np.complex64).view(np.float32)
    return np.ascontiguousarray(words.reshape(-1, 2).T)


def am_demod(sig: jnp.ndarray) -> jnp.ndarray:
    """AM envelope ``|z|`` (reference ``amDemod``, ``Demodulation.jl:26-28``)."""
    return jnp.abs(sig)


def am_demod_power(sig: jnp.ndarray) -> jnp.ndarray:
    """Squared envelope ``|z|^2`` — what the reference feeds the
    autocorrelation estimator (``GUI.jl:70``).  Cheaper than ``|z|`` (no sqrt)
    and monotone in it, so peak positions are unchanged."""
    return jnp.real(sig) ** 2 + jnp.imag(sig) ** 2


def invert_am_demod(sig: jnp.ndarray) -> jnp.ndarray:
    """Inverted, max-normalised envelope ``1 - |z|/max|z|``
    (reference ``invert_amDemod``, ``Demodulation.jl:31-35``)."""
    env = jnp.abs(sig)
    return 1.0 - env / jnp.max(env)


def fm_demod_from_iq(iq: jnp.ndarray) -> jnp.ndarray:
    """FM discriminator straight from interleaved I/Q words (real ops only):
    ``arg(z[n] conj(z[n-1])) = atan2(im_n re_{n-1} - re_n im_{n-1},
    re_n re_{n-1} + im_n im_{n-1})``, out[0] = 0.  The de-interleave runs as
    two one-hot lane matmuls (see ``_EVEN``/``_ODD``) instead of a strided
    access."""
    rows, n = _rows128(iq)
    re = jnp.dot(rows, jnp.asarray(_EVEN), preferred_element_type=jnp.float32,
                 precision=MOVE_PRECISION).reshape(-1)[:n]
    im = jnp.dot(rows, jnp.asarray(_ODD), preferred_element_type=jnp.float32,
                 precision=MOVE_PRECISION).reshape(-1)[:n]
    re0, im0 = re[:-1], im[:-1]
    re1, im1 = re[1:], im[1:]
    disc = jnp.arctan2(im1 * re0 - re1 * im0, re1 * re0 + im1 * im0)
    return jnp.concatenate([jnp.zeros((1,), disc.dtype), disc])


def fm_demod_rows(chans: jnp.ndarray) -> jnp.ndarray:
    """Batched FM discriminator over complex rows — shape (..., M) complex
    in, (..., M) float32 out with column 0 zeroed (the reference's
    ``fmDemod`` convention, ``Demodulation.jl:17-23``, vectorised over a
    bank of channels).

    This is the per-channel demodulator of the FM harmonic-combining front
    (``ops.combine.combine_core(demod="fm")``): the channeliser's complex
    channels stay on-device (no complex dtype crosses the host boundary)
    and the discriminator is pure real elementwise ops —
    XLA fuses it into whatever consumes the rows."""
    re, im = jnp.real(chans), jnp.imag(chans)
    cross = im[..., 1:] * re[..., :-1] - re[..., 1:] * im[..., :-1]
    dotp = re[..., 1:] * re[..., :-1] + im[..., 1:] * im[..., :-1]
    disc = jnp.arctan2(cross, dotp).astype(jnp.float32)
    return jnp.concatenate(
        [jnp.zeros(disc.shape[:-1] + (1,), disc.dtype), disc], axis=-1)


def fm_demod(sig: jnp.ndarray) -> jnp.ndarray:
    """FM discriminator ``arg(z[n] * conj(z[n-1]))`` with out[0] = 0
    (reference ``fmDemod``, ``Demodulation.jl:17-23``, which writes
    out[n+1] = arg(sig[n+1] conj(sig[n])) leaving out[1] zero)."""
    prod = sig[1:] * jnp.conj(sig[:-1])
    disc = jnp.arctan2(jnp.imag(prod), jnp.real(prod))
    return jnp.concatenate([jnp.zeros((1,), disc.dtype), disc])
