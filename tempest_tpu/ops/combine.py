"""Multi-harmonic combining: fuse the SAME screen's emission from several
carriers of one wideband capture into one higher-SNR envelope.

A display leaks at every harmonic of its pixel clock (and at intermodulation
products); each carrier carries the same video envelope with its own
strength, independent RF phase, and possibly inverted modulation polarity.
The reference tunes to ONE carrier and ignores the rest of the capture
(``/root/reference/src/GUI.jl:594-605`` — the operator types a single
frequency).  Since the carriers ride one time base, their demodulated
envelopes are sample-aligned by construction — no frame registration is
needed to combine them, and the SNR gain happens BEFORE the nonlinear
sync/alignment stages, exactly where it helps timing estimation too.

Design: ONE jitted program channelises the capture (the scan
module's big-FFT + static band slices + batched IFFT), takes per-channel
amplitude envelopes, scores each channel's screen-content power by the
refresh-comb mass the scanner already uses, detects per-channel modulation
polarity against the strongest channel (one matmul of mean-removed
envelopes), solves maximal-ratio weights from the comb/variance statistics,
and emits the weighted sum — nothing leaves the device but the combined
envelope and the per-channel diagnostics.

MRC weight derivation: with mean-removed envelopes ``e_k = a_k·v + n_k``,
screen content is FRAME-periodic while receiver noise, CW envelope beats,
hum and other interference are not.  Per channel the comb dots at the known
frame lags minus the same dots at half-frame offsets isolate the screen
power (``s_k ≈ ρ·a_k²·σ_v²`` with the content persistence ρ common to all
channels — interference contributes equally to both dot sets and cancels),
the remainder ``N_k = c0_k − s_k`` is noise+interference, and the
SNR-optimal weights are ``w_k = √s_k / N_k`` (matched-filter MRC) — no
cross-channel calibration needed.  A pure-noise channel has s≈0 ⇒ w≈0, so
combining over a blind carrier list is safe; gates on comb evidence zero
channels outright (see ``combine_core``).  History: a lag-1 decorrelation
split (``s=c1``, ``N=c0−c1``) shipped first and is kept as
``refresh_hz=None`` — it mis-reads coherent in-channel interference as
signal (a CW's envelope beat is sample-correlated; measured weight 0.43 on
a channel it should crush to 0.015, fusion −6 dB).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .autocorr import autocorrelation
from .demod import fm_demod_rows
from .scan import _channelize_complex, _channel_geometry, _selection_prominence

__all__ = ["CombineResult", "combine_core", "combine_harmonics"]


@dataclasses.dataclass(frozen=True)
class CombineResult:
    """A combined envelope plus the per-channel evidence behind it."""

    envelope: np.ndarray        # combined envelope, float32 [M]
    fs_channel: float           # its sample rate [Hz]
    centers_hz: np.ndarray      # the carriers combined (input order)
    weights: np.ndarray         # MRC weight per channel (sums to 1)
    polarity: np.ndarray        # +1/-1 modulation polarity vs the anchor
    mass_db: np.ndarray         # refresh-comb mass per channel (dB)
    refresh_hz: np.ndarray      # per-channel refresh estimate

    def best_channel(self) -> int:
        return int(np.argmax(self.mass_db))


def combine_core(words, fs, centers, chan_bw, fs_chan, corr_seconds,
                 rate_min, rate_max, weighting, refresh_hz=None,
                 demod="am", excise_db=None):
    """Traceable combine: channelise → polarity → MRC weights → fusion.

    ``(env, weights, polarity, mass_db, refresh)`` with everything but
    ``words`` static — composable inside larger programs (the streaming
    runtime fuses this in front of its reconstruction step).

    ``refresh_hz`` (static float): when the screen's refresh is already
    known (the streaming runtime's video mode), the per-channel comb mass is
    read directly at the known frame lags — 15 dot products per channel
    (harmonics 1–5 × a box-3 lag neighbourhood absorbing ppm-level drift)
    instead of a full FFT autocorrelation + period search per channel.
    The mass scale differs from the offline
    estimator (no band-median removal / peak widening), which is irrelevant
    for its only use here: the 40 dB relative gate between channels of ONE
    program.  ``None`` (offline default) keeps the full search and honest
    per-channel refresh estimates.

    ``demod`` (static): ``"am"`` (default — amplitude envelope per channel)
    or ``"fm"`` (per-channel FM discriminator, ``ops.demod.fm_demod_rows``).
    Some targets leak the video in the carrier's FREQUENCY rather than its
    amplitude (the reference exposes ``fmDemod`` for exactly this,
    ``Demodulation.jl:17-23`` — but only ever on the single tuned carrier);
    every downstream stage (comb mass, polarity, frame-periodic MRC) works
    on the mean-removed demodulated rows and is demod-agnostic.

    ``excise_db`` (static float | None): null narrowband interference
    louder than each channel's own carrier peak by this margin in the
    channel spectra before demodulation (``ops.scan._excise_spikes``) —
    RECOVERS a CW-hit channel where the robust MRC alone can only refuse
    to weight it.  AM only — the carrier-relative criterion is unsound for
    wideband FM (:func:`tempest_tpu.ops.scan.check_excise_demod`)."""
    from .scan import check_excise_demod

    check_excise_demod(demod, excise_db)
    chans, _ = _channelize_complex(words, fs, np.asarray(centers), chan_bw,
                                   excise_db=excise_db)
    if demod == "fm":
        amp = fm_demod_rows(chans)                    # (K, M) discriminator
    else:
        amp = jnp.abs(chans).astype(jnp.float32)      # (K, M) AM envelopes
    mean = jnp.mean(amp, axis=1, keepdims=True)
    env0 = amp - mean
    var = jnp.mean(env0 * env0, axis=1)               # σ_k²

    if refresh_hz is not None:
        spf_c = fs_chan / float(refresh_hz)
        m = env0.shape[1]

        def comb_dots(e, half_off):
            acc = jnp.zeros(())
            cnt = 0
            for k in range(1, 6):
                lag0 = int(round(k * spf_c + half_off * spf_c / 2.0))
                if lag0 + 1 >= m:
                    break
                # box-3 max over neighbouring lags: tolerates the known
                # refresh being ppm-off the emission's crystal.
                vals = [jnp.mean(e[: m - L] * e[L:])
                        for L in (lag0 - 1, lag0, lag0 + 1) if 0 < L < m]
                acc = acc + jnp.max(jnp.stack(vals))
                cnt += 1
            return acc / max(cnt, 1)

        comb = jax.vmap(lambda e: comb_dots(e, 0))(env0)
        # Off-comb null at half-frame lag offsets: any NON-frame-periodic
        # correlated power (a CW interferer's envelope beat, hum, receiver
        # artifacts) contributes to both on- and off-comb dots alike, while
        # screen content is frame-periodic and does not — the difference
        # isolates SCREEN power for the MRC weights below.
        comb_off = jax.vmap(lambda e: comb_dots(e, 1))(env0)
        mass_db = 10.0 * jnp.log10(jnp.maximum(comb, 1e-30))
        fv = jnp.full_like(var, float(refresh_hz))
        # Raw envelope dots scale as amplitude² where the offline linear-
        # autocorrelation mass scales as amplitude⁴: the offline 40 dB gate
        # is 20 dB here.  Second gate: the selection-biased noise null of a
        # max-of-3 mean-of-5 dot estimate is O(1-3)·c0/√M (measured 1.3-3.4
        # on pure-noise channels; weakest real emission ≥ 20, 6 dB SNR at
        # 0.15 s) — 6× clears noise even when the anchor itself is weak.
        gate = ((comb > jnp.max(comb) * 1e-2)
                & (comb * np.sqrt(env0.shape[1]) > 6.0 * var))
    else:
        def comb_one(e):
            lin, _ = autocorrelation(e, fs_chan, 0.0, corr_seconds,
                                     scale="linear")
            return _selection_prominence(lin, fs_chan, rate_min, rate_max, 5)

        mass_db, _, fv = jax.vmap(comb_one)(env0)
    anchor = jnp.argmax(mass_db)
    # Modulation polarity: sign of the correlation against the anchor
    # channel's envelope (intermodulation regularly inverts video).
    dots = env0 @ env0[anchor]
    pol = jnp.where(dots >= 0.0, 1.0, -1.0).astype(jnp.float32)
    if weighting == "equal":
        w = jnp.ones_like(var)
    elif refresh_hz is not None:
        # Interference-robust MRC: signal power = frame-PERIODIC correlated
        # power (on-comb minus off-comb — a CW beat, hum, or any correlated
        # non-screen power cancels in the difference); noise = everything
        # else, interference included.  Measured: a CW interferer 9 dB
        # above a channel's emission drives that channel's weight
        # 0.43 → 0.015 where the lag-1 split WRONGLY raised it
        # (tests/test_combine.py::test_interferer_hit_channel_downweighted).
        s = jnp.maximum(comb - comb_off, 0.0)
        noise = jnp.maximum(var - s, 1e-6 * var)
        w = jnp.sqrt(s) / noise
        w = jnp.where(gate, w, 0.0)
    else:
        # MRC from the lag-1 decorrelation split (estimate_snr's separation):
        # signal power s = c1 (correlated), noise N = c0 - c1 (white).
        # Assumes WHITE receiver noise — coherent interference inside a
        # channel is misread as signal; the refresh_hz path above is the
        # robust estimator (the public wrappers run it by default).
        c1 = jnp.mean(env0[:, :-1] * env0[:, 1:], axis=1)
        s = jnp.maximum(c1, 0.0)
        noise = jnp.maximum(var - c1, 1e-6 * var)
        w = jnp.sqrt(s) / noise
        # Zero out channels with no refresh-comb evidence (correlated
        # interference is not screen signal).
        w = jnp.where(mass_db > mass_db[anchor] - 40.0, w, 0.0)
    w = w / jnp.maximum(jnp.sum(w), 1e-30)
    # Deterministic output polarity: ``pol`` is measured relative to the
    # data-dependent anchor (the strongest channel), which may itself carry
    # INVERTED modulation — equal-strength harmonics then make the fused
    # video's sense an arbitrary draw (measured: an FM fixture whose pass-2
    # anchor landed on the inverted carrier reconstructed at 6.0 dB vs 14.1
    # for the flip).  Re-base to the first carrier that survives gating, so
    # the contract is "the fused envelope carries centers_hz[0]'s
    # modulation sense" — reproducible, and the operator's existing
    # ``invert`` knob handles the (physically unknowable) absolute sense.
    first = jnp.argmax(w > 0.0)
    pol = pol * pol[first]
    env = jnp.einsum("k,km->m", w * pol, env0,
                     preferred_element_type=jnp.float32)
    # Re-add the combined DC so the output looks like a standard positive
    # envelope to downstream consumers (blanking-polarity detection etc.).
    env = env + jnp.sum(w * mean[:, 0])
    return env, w, pol, mass_db, fv


_combine_kernel = partial(jax.jit, static_argnames=(
    "fs", "centers", "chan_bw", "fs_chan", "corr_seconds", "rate_min",
    "rate_max", "weighting", "refresh_hz", "demod",
    "excise_db"))(combine_core)


def combine_harmonics(
    iq: np.ndarray | jnp.ndarray,
    fs: float,
    centers_hz: np.ndarray | list[float],
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    refresh_hz: float | str | None = "auto",
    demod: str = "am",
    excise_db: float | None = None,
) -> CombineResult:
    """Extract and fuse the emission at each carrier of ``centers_hz`` from
    one wideband capture.

    ``iq``: host complex64 (viewed as words) or interleaved float32 I/Q.
    Returns a :class:`CombineResult` whose ``envelope`` (at ``fs_channel``)
    feeds the standard pipeline via ``ReconstructionConfig(
    input_format="envelope")`` — see ``pipeline.offline.combined_reconstruct``
    for the one-call wrapper.  ``weighting``: ``"mrc"`` (default, measured
    winner) or ``"equal"``.

    ``refresh_hz``: ``"auto"`` (default) runs TWO passes — a scoring pass
    estimates each channel's refresh, then the fusion pass re-weights with
    the interference-robust frame-periodic MRC at the anchor's refresh
    (``combine_core(refresh_hz=...)``).  A float skips the scoring pass
    (the streaming runtime's mode of use); ``None`` keeps the single-pass
    lag-1 MRC, which misreads coherent in-channel interference as signal —
    kept for comparison only.

    ``demod``: ``"am"`` (envelope) or ``"fm"`` (per-channel discriminator,
    for targets that leak the video in carrier frequency — the reference's
    ``fmDemod`` path, single-carrier only there).

    ``excise_db``: opt-in spectral excision of in-channel CW interference
    (bins louder than the channel's carrier peak by this margin, nulled
    before demod — 0.0 is a good setting; see ``combine_core``)."""
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    iq = jnp.asarray(iq)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    _, _, fs_chan = _channel_geometry(int(iq.shape[0]) // 2, fs, chan_bw)
    args = (iq, float(fs), tuple(float(c) for c in centers), float(chan_bw),
            float(fs_chan), float(corr_seconds), float(rate_min),
            float(rate_max), weighting)
    two_pass = refresh_hz == "auto" and weighting == "mrc"
    env, w, pol, mass_db, fv = _combine_kernel(
        *args, refresh_hz=None if refresh_hz == "auto" else refresh_hz,
        demod=demod, excise_db=excise_db)
    if two_pass:
        mass1, fv1 = mass_db, fv  # honest per-channel diagnostics (pass 1)
        fv_anchor = float(np.asarray(fv)[int(np.argmax(np.asarray(mass_db)))])
        # refresh_hz is a STATIC arg (it bakes the comb lags into the
        # program): quantise to an integer frame period so the estimator's
        # sub-mHz jitter cannot mint a fresh XLA compile per capture — the
        # box-3 lag neighbourhood absorbs the ≤0.5-sample rounding.
        fv_anchor = fs_chan / round(fs_chan / fv_anchor)
        env, w, pol, _, _ = _combine_kernel(*args, refresh_hz=fv_anchor,
                                            demod=demod, excise_db=excise_db)
        mass_db, fv = mass1, fv1
    return CombineResult(
        envelope=np.asarray(env, np.float32),
        fs_channel=float(fs_chan),
        centers_hz=centers,
        weights=np.asarray(w, np.float64),
        polarity=np.asarray(pol, np.float64),
        mass_db=np.asarray(mass_db, np.float64),
        refresh_hz=np.asarray(fv, np.float64),
    )
