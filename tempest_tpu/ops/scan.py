"""Carrier-frequency scan: find TEMPEST emissions across a wideband capture.

The reference has no counterpart — its operator types a carrier frequency and
hunts by eye on the waterfall (``/root/reference/src/GUI.jl:594-605`` carrier
textbox; the docs tell the user to look for "suspicious wide peaks").  This
module automates the hunt in ONE program that channelises a wideband
capture into K candidate basebands (frequency-domain slicing — one big FFT,
K static slices, one batched inverse FFT) and scores every channel's
"screen-ness" by the refresh-band autocorrelation comb that the timing
estimator already relies on.  All K channels are processed batched; nothing
is data-dependent, so XLA fuses the whole sweep.

Scoring: a display emission's envelope autocorrelates at every multiple of
the frame period — a comb in the 50–90 Hz repetition band.  Channels with an
emission show a sharp peak over the band's median; empty/noise channels are
flat.  ``score = max − median`` of the zoomed refresh-band autocorrelation
(dB) is monotone in emission strength and costs two reductions per channel.

Live counterpart (hardware sources): :meth:`tempest_tpu.runtime.stream.
StreamingRuntime.scan` retunes across dwell frequencies and scores each dwell
with the same metric.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .autocorr import (
    _lerp,
    _widen_peaks,
    autocorrelation,
    estimate_refresh,
)
from .demod import am_power_from_iq

__all__ = ["ScanResult", "carrier_score", "channelize", "scan_band",
           "scan_centers"]


@dataclasses.dataclass(frozen=True)
class ScanResult:
    """Ranked carrier candidates from a band scan.

    ``scores_db`` is the absolute structured comb mass — it scales with how
    much of the emission the channel captured, so it localises the carrier.
    ``prominence_db`` is the scale-free comb-over-MAD ratio — noise's
    selection floor measures ~6-12 dB at any gain (the comb estimator picks
    the best of thousands of candidate periods even in noise), emissions
    measure well above it; it is the detection confidence."""

    centers_hz: np.ndarray      # candidate channel centers (input order)
    scores_db: np.ndarray       # structured comb mass per channel (ranking)
    prominence_db: np.ndarray   # comb/floor screen-ness per channel
    refresh_hz: np.ndarray      # detected refresh-band peak per channel
    fs_channel: float           # sample rate of each extracted channel
    # Measured noise selection floor [dB] for this sweep's window geometry:
    # the identical estimator run on white-noise surrogate envelopes of the
    # same length/window (see _noise_floor), one value broadcast per channel.
    # Detection thresholds on prominence - floor, so the criterion tracks
    # the window geometry automatically instead of hardcoding a constant.
    floor_db: np.ndarray | None = None

    def ranking(self) -> np.ndarray:
        """Channel indices, best first."""
        return np.argsort(-self.scores_db)

    def best(self) -> tuple[float, float, float]:
        """(center_hz, score_db, refresh_hz) of the top channel."""
        i = int(self.ranking()[0])
        return (float(self.centers_hz[i]), float(self.scores_db[i]),
                float(self.refresh_hz[i]))

    def emissions(self, min_margin_db: float = 5.0,
                  min_prominence_db: float | None = None):
        """Group detected channels into distinct emissions.

        A wide emission lights up EVERY overlapping channel (prominence is
        scale-free), so the channel list alone over-counts: this merges
        contiguous above-threshold channels into one emission each and
        reports, per emission, the mass-weighted centroid frequency, the
        span of detecting channels, the best channel's center and its
        refresh estimate.  Returns a list of dicts ordered by peak mass,
        e.g. two monitors in one capture → two entries.

        Detection: ``prominence >= floor + min_margin_db``, where ``floor``
        is the sweep's MEASURED noise selection floor (the identical
        estimator on white-noise surrogates at this window geometry, see
        ``_noise_floor``).  For noise channels, prominence sits within a
        couple dB of the floor (draws of the same selection max); an
        emission clears it by 8+ dB — so the criterion holds at ANY window
        length, where a fixed threshold split only the one measured
        geometry (measured floors: 11.2 dB at 0.02 s vs 6.1 dB at 0.25 s).

        ``min_prominence_db``: legacy absolute override (used instead of
        the margin test when given, and as the fallback when the result
        carries no floors)."""
        order = np.argsort(self.centers_hz)
        c = self.centers_hz[order]
        prom = self.prominence_db[order]
        mass = self.scores_db[order]
        fv = self.refresh_hz[order]
        if min_prominence_db is not None or self.floor_db is None:
            thr = min_prominence_db if min_prominence_db is not None else 14.0
            hot = prom >= thr
            floor = np.full_like(prom, np.nan)
        else:
            floor = self.floor_db[order]
            hot = prom >= floor + min_margin_db
        groups: list[list[int]] = []
        for i, h in enumerate(hot):
            if not h:
                continue
            if groups and groups[-1][-1] == i - 1:
                groups[-1].append(i)
            else:
                groups.append([i])
        out = []
        for g in groups:
            w = 10.0 ** (mass[g] / 10.0)     # linear structured mass
            peak = g[int(np.argmax(mass[g]))]
            out.append({
                "center_hz": float(np.sum(c[g] * w) / np.sum(w)),
                "span_hz": (float(c[g[0]]), float(c[g[-1]])),
                "best_channel_hz": float(c[peak]),
                "refresh_hz": float(fv[peak]),
                "score_db": float(mass[peak]),
                "prominence_db": float(prom[peak]),
                "floor_db": float(floor[peak]),
                "n_channels": len(g),
            })
        out.sort(key=lambda e: -e["score_db"])
        return out


def _noise_floor(fs, n_env: int, corr_seconds, rate_min, rate_max,
                 harmonics: int = 5, draws: int = 4,
                 demod: str = "am") -> jnp.ndarray:
    """Measured noise selection floor [dB] for ONE window geometry.

    The comb estimator maximises over thousands of candidate periods, so
    even pure noise scores a positive prominence — and that selection floor
    depends on the window geometry (number of candidate lags, harmonics in
    range): measured means 11.2 dB at a 0.02 s window vs 6.1 dB at 0.25 s.
    Rather than modelling the order statistic of a multi-stage estimator,
    this MEASURES it: run the identical scoring on ``draws`` white-noise
    surrogate envelopes (|CN(0,1)|², the exact null of an empty channel) of
    the same length and window, and take the worst (max) draw.  Detection
    then thresholds ``prominence >= floor + margin``, which tracks window
    length by construction.

    Deterministic (fixed PRNG key, threefry — identical on every backend) and
    channel-independent: ONE floor per sweep geometry, a ``draws``-channel
    extra scoring next to the K real channels.

    A per-channel surrogate (lag-scrambled own correlation) was tried first
    and REJECTED, measured: an emission's line-period comb puts hundreds of
    large values in the band, which the scrambled null reassembles into a
    14-17 dB floor on exactly the channels that matter — margins collapsed
    to the noise channels' own fluctuation (1.5 vs 4.3 dB)."""
    import jax.random as jrandom

    z = jrandom.normal(jrandom.PRNGKey(7), (int(draws), 2, int(n_env)),
                       jnp.float32)
    if demod == "fm":
        # The exact null of an empty channel under the FM discriminator:
        # phase increments of complex white noise (run through the identical
        # demodulator the real channels get).
        from .demod import fm_demod_rows

        env = fm_demod_rows(jax.lax.complex(z[:, 0, :], z[:, 1, :]))
    else:
        env = z[:, 0, :] ** 2 + z[:, 1, :] ** 2

    def one(e):
        e0 = e - jnp.mean(e)
        lin, _ = autocorrelation(e0, fs, 0.0, corr_seconds, scale="linear")
        return _selection_prominence(lin, fs, rate_min, rate_max,
                                     harmonics)[1]

    return jnp.max(jax.vmap(one)(env))


def _comb_contrast(env, fs, corr_seconds, rate_min, rate_max,
                   harmonics: int = 5):
    """Harmonic-comb prominence + refined refresh of one envelope [dB].

    Two measured design points:

    * The mean MUST come off the envelope first: a channel that captures
      the emission's full band carries the envelope's large DC term, whose
      autocorrelation pedestal (≈ N·mean² at every lag) flattens the band
      in dB and erases the comb — the full-emission channel scored 1.3 dB
      against 7.0 for a half-band cut until the mean removal.
    * A bare max−median of the band is NOT a discriminator: over ~10⁴–10⁵
      lags the extreme value of a noise autocorrelation sits 12–16 dB over
      its median by order statistics alone.  A screen emission is the only
      signal whose correlation mass repeats at k·P for all k
      simultaneously, so the score is the k-averaged comb mass at the
      detected period over the band's fluctuation scale (MAD) — noise's
      selection floor measures ~6-12 dB (the estimator maximises over
      thousands of candidate periods), emissions well above it.  The floor
      is window-geometry dependent; :func:`_noise_floor` measures it so
      detection can threshold on the margin over it.
    """
    env0 = env - jnp.mean(env)
    lin, _ = autocorrelation(env0, fs, 0.0, corr_seconds, scale="linear")
    return _selection_prominence(lin, fs, rate_min, rate_max, harmonics)


def _selection_prominence(lin, fs, rate_min, rate_max, harmonics):
    """Comb mass/prominence + refresh for ONE linear autocorrelation array —
    shared verbatim by the real channel score and the noise-surrogate null
    (the floor is only honest if the null runs the exact same selection)."""
    fv = estimate_refresh(lin, fs, rate_min, rate_max, scale="linear")
    n = lin.shape[0]
    linw = _widen_peaks(lin)
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    band = linw[pos_lo : pos_hi + 1]
    med = jnp.median(band)
    # Robust positive scale, NOT the raw median: the mean-removed LINEAR
    # autocorrelation of noise fluctuates around zero, so its band median
    # can land arbitrarily close to 0 and a comb/median ratio explodes —
    # measured 41-44 dB on pure noise blocks whose median happened to be
    # tiny.  The MAD is the band's fluctuation magnitude, which is exactly
    # the null the comb must beat.
    mad = jnp.median(jnp.abs(band - med))
    lag = fs / fv
    mass = jnp.zeros((), linw.dtype)
    count = jnp.zeros((), linw.dtype)
    for k in range(1, harmonics + 1):
        p = k * lag
        valid = p < n - 1
        mass = mass + jnp.where(valid, _lerp(linw, p[None])[0], 0.0)
        count = count + valid.astype(linw.dtype)
    comb = mass / jnp.maximum(count, 1.0)
    # Two statistics, two jobs: PROMINENCE ((comb−med)/MAD, scale-free)
    # detects "there is a screen in this channel" with a bounded noise
    # floor (the selection max over candidate periods of a ~unit-MAD null);
    # absolute structured MASS (comb − med) scales with how much of the
    # emission the channel actually captured, so it LOCALISES the carrier
    # (prominence alone is flat across any sub-band of a wide emission —
    # measured: a 4 MHz emission scored equal prominence from every
    # overlapping channel, 3 through 6 MHz).
    excess = jnp.maximum(comb - med, 1e-30)
    prominence = 10.0 * (jnp.log10(excess)
                         - jnp.log10(jnp.maximum(mad, 1e-30)))
    mass_db = 10.0 * jnp.log10(excess)
    return mass_db, prominence, fv


@partial(jax.jit,
         static_argnames=("fs", "corr_seconds", "rate_min", "rate_max"))
def _score_kernel(words, fs, corr_seconds, rate_min, rate_max):
    return _comb_contrast(am_power_from_iq(words), fs, corr_seconds,
                          rate_min, rate_max)


def carrier_score(
    iq: np.ndarray | jnp.ndarray,
    fs: float,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
) -> tuple[float, float]:
    """Screen-ness of ONE baseband capture: ``(comb prominence dB, refresh
    Hz)`` — the per-dwell metric of a live retune scan.  Prominence (the
    scale-free statistic) is returned because successive hardware dwells may
    see different gains; noise's selection floor is ~6-12 dB at any gain
    (window-length dependent), emissions measure well above it."""
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    _, prom, fv = _score_kernel(jnp.asarray(iq), float(fs),
                                float(corr_seconds), float(rate_min),
                                float(rate_max))
    return float(prom), float(fv)


def scan_centers(fs: float, step_hz: float, guard_hz: float = 0.0) -> np.ndarray:
    """Candidate centers covering the capture's (−fs/2, fs/2) span on a
    ``step_hz`` grid, keeping ``guard_hz`` clear of the band edges."""
    half = fs / 2.0 - guard_hz
    k = int(np.floor(half / step_hz))
    return np.arange(-k, k + 1, dtype=np.float64) * step_hz


def _fft_pow2_len(n: int) -> int:
    return 1 << (max(int(n), 2).bit_length() - 1)


def _channel_geometry(n_samples: int, fs: float, chan_bw: float):
    """(N, M, fs_channel): capture FFT length (power of two, rounded down),
    channel length (power of two, rounded up from ``chan_bw``), and the
    resulting channel sample rate — shared by the channeliser and its
    callers so the shape math cannot drift."""
    N = _fft_pow2_len(n_samples)
    M = 1 << max(int(np.ceil(chan_bw / fs * N)) - 1, 1).bit_length()
    M = min(M, N)
    return N, M, fs * M / N


def _excise_spikes(bands: jnp.ndarray, margin_db: float,
                   guard_bins: int = 2, dilate_bins: int = 256) -> jnp.ndarray:
    """Null narrowband interference in channel spectra (K, M), carrier at
    bin 0 — bins louder than the channel's own carrier peak.

    A CW interferer inside a channel beats against the emission's carrier
    and the AM envelope picks the beat up as sample-correlated power; the
    robust MRC already refuses to *weight* such a channel
    (``combine_core``), but excision *recovers* it.  A naive spike notch is
    WRONG here — the emission's own spectrum is a forest of narrow lines
    (the raster is near-periodic: carrier ± k·line-rate comb), so "null
    everything spiky" deletes the signal.  The criterion that protects the
    comb grid by construction: the carrier line is always the STRONGEST
    line of an AM screen emission (unit DC vs depth·env sidebands spread
    over many lines), so only bins exceeding the carrier peak by
    ``margin_db`` are presumed interference.  ``guard_bins`` protects the
    carrier's own leakage skirt (±bins around DC); ``dilate_bins`` widens
    each detection to swallow the interferer's sinc skirt — rectangular-
    window leakage decays only ~1/Δ, and the residual still beats: on the
    CW fixture ±8 bins left the residual at −6 dB vs the carrier (beat
    ~37% of the envelope DC, weight recovery stalled at 0.08 of 0.28);
    ±256 cuts it another ~10×, and nulling 512 of 2M bins costs the
    emission nothing measurable."""
    p = jnp.real(bands) ** 2 + jnp.imag(bands) ** 2
    m = bands.shape[-1]
    idx = jnp.arange(m)
    prot = (idx <= guard_bins) | (idx >= m - guard_bins)
    ref = jnp.max(jnp.where(prot, p, 0.0), axis=-1, keepdims=True)
    hit = (~prot) & (p > ref * 10.0 ** (margin_db / 10.0))
    # Circular box dilation in O(M): box-sum the hit indicator via one
    # cumsum over a circularly padded copy (W rolls would be W fused
    # passes; the prefix sum is two).
    w = int(dilate_bins)
    hf = hit.astype(jnp.float32)
    ext = jnp.concatenate([hf[..., -w:], hf, hf[..., :w]], axis=-1)
    cz = jnp.concatenate(
        [jnp.zeros(ext.shape[:-1] + (1,), ext.dtype),
         jnp.cumsum(ext, axis=-1)], axis=-1)
    box = cz[..., 2 * w + 1:] - cz[..., : -(2 * w + 1)]   # (…, M)
    # The dilation must never swallow the protected carrier bins: a CW
    # within ``dilate_bins`` of DC would otherwise null the channel's own
    # carrier line — destroying the channel instead of recovering it.
    return jnp.where((box > 0.0) & ~prot, 0.0, bands)


def _channelize_complex(
    iq_words: jnp.ndarray,
    fs: float,
    centers_hz: np.ndarray,
    chan_bw: float,
    excise_db: float | None = None,
) -> tuple[jnp.ndarray, float]:
    """Traceable core of :func:`channelize` — returns the (K, M) complex64
    channels for on-device consumption (the complex values stay inside the
    program; no complex dtype crosses the host boundary).

    ``excise_db``: when set, narrowband interference above each channel's
    carrier peak by this margin is nulled in the spectrum before the
    inverse FFT (see :func:`_excise_spikes`)."""
    n_c = iq_words.shape[0] // 2
    N, M, fs_chan = _channel_geometry(n_c, fs, chan_bw)
    ri = iq_words[: 2 * N].reshape(N, 2)
    z = jax.lax.complex(ri[:, 0], ri[:, 1])
    spec = jnp.fft.fft(z)
    # Circular band slices: bin b covers frequency b/N·fs (negative
    # frequencies wrap into the upper half); duplicating the first M bins
    # turns every slice into a static one.
    spec_w = jnp.concatenate([spec, spec[:M]])
    starts = [
        int(np.round(float(fc) / fs * N)) % N for fc in np.asarray(centers_hz)
    ]
    bands = jnp.stack([
        jax.lax.slice(spec_w, ((s - M // 2) % N,), ((s - M // 2) % N + M,))
        for s in starts
    ])                                            # (K, M), centered at DC+M/2
    # Rotate so each channel's center lands at bin 0 (DC) of its own FFT.
    bands = jnp.roll(bands, -(M // 2), axis=1)
    if excise_db is not None:
        bands = _excise_spikes(bands, excise_db)
    return jnp.fft.ifft(bands, axis=1) * (M / N), fs_chan


def channelize(
    iq_words: np.ndarray | jnp.ndarray,
    fs: float,
    centers_hz: np.ndarray,
    chan_bw: float,
) -> tuple[jnp.ndarray, float]:
    """Extract K baseband channels of ≈``chan_bw`` from a wideband capture.

    ``iq_words`` is interleaved float32 I/Q (or host complex64, viewed) of
    2·N words.  Frequency-domain channelisation: one N-point FFT, a static
    M-bin circular slice per (host-known) center, one batched M-point
    inverse FFT — K channels at ``fs·M/N`` each, no per-channel mixing or
    filtering passes.  Returns ``(channels (K, 2·M) interleaved float32,
    fs_channel)`` — the device boundary stays real (no complex dtype
    crosses it); view the materialised rows as complex64 on the host.

    Static shapes: N is the capture rounded down to a power of two, M the
    channel width rounded UP to a power of two (so the channel FFTs stay
    smooth for the downstream autocorrelation, ops/autocorr.py).
    """
    if isinstance(iq_words, np.ndarray) and np.iscomplexobj(iq_words):
        iq_words = np.ascontiguousarray(iq_words, np.complex64).view(np.float32)
    chans, fs_chan = _channelize_complex(jnp.asarray(iq_words), fs,
                                         centers_hz, chan_bw)
    words = jnp.stack(
        [jnp.real(chans).astype(jnp.float32),
         jnp.imag(chans).astype(jnp.float32)], axis=-1
    ).reshape(chans.shape[0], -1)
    return words, fs_chan


def check_excise_demod(demod: str, excise_db: float | None) -> None:
    """Refuse the unsound knob combination loudly (every public entry point
    calls this): the excision criterion nulls bins louder than the channel's
    carrier line, which is safe for AM (the carrier is always the strongest
    emission line) but NOT for wideband FM — the carrier line nulls entirely
    at J₀ zeros of the modulation index and Carson sidebands can exceed it,
    so excision could null the emission itself.  The robust frame-periodic
    MRC (``ops.combine``) still downweights interfered FM channels."""
    if excise_db is not None and demod == "fm":
        raise ValueError(
            "excise_db with demod='fm' is unsupported: wideband FM can null "
            "its own carrier line (J0 zeros), so 'louder than the carrier' "
            "no longer identifies interference — excision could delete the "
            "emission. Disable excision for FM; the robust MRC weighting "
            "already rejects interfered channels."
        )


@partial(jax.jit, static_argnames=("fs", "centers", "chan_bw", "fs_chan",
                                   "corr_seconds", "rate_min", "rate_max",
                                   "demod", "excise_db"))
def _sweep_kernel(words, fs, centers, chan_bw, fs_chan, corr_seconds,
                  rate_min, rate_max, demod="am", excise_db=None):
    """Module-level jitted sweep: a per-call ``jax.jit`` closure would
    re-trace and re-lower on EVERY invocation.

    ``demod`` picks the per-channel detection statistic: ``"am"`` scores the
    squared envelope (AM leakage), ``"fm"`` the discriminator output (FM
    leakage — an FM emission's AMPLITUDE is flat, so the AM sweep is blind
    to it); the noise floor runs the matching null surrogate."""
    chans, _ = _channelize_complex(words, fs, np.asarray(centers), chan_bw,
                                   excise_db=excise_db)

    if demod == "fm":
        from .demod import fm_demod_rows

        envs = fm_demod_rows(chans)
    else:
        envs = jnp.real(chans) ** 2 + jnp.imag(chans) ** 2

    mass, prom, fv = jax.vmap(
        lambda env: _comb_contrast(env, fs_chan, corr_seconds,
                                   rate_min, rate_max))(envs)
    floor = _noise_floor(fs_chan, chans.shape[1], corr_seconds,
                         rate_min, rate_max, demod=demod)
    return mass, prom, fv, floor


def scan_band(
    iq_words: np.ndarray | jnp.ndarray,
    fs: float,
    centers_hz: np.ndarray,
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    demod: str = "am",
    excise_db: float | None = None,
) -> ScanResult:
    """Score every candidate carrier in a wideband capture (ONE program).

    ``iq_words``: interleaved float32 I/Q words, or host complex64 (viewed).
    Per channel: envelope power → FFT autocorrelation over ``corr_seconds``
    → refresh-band zoom → comb contrast (max − median, dB) and the refined
    refresh estimate.  Returns a :class:`ScanResult` over ``centers_hz``.

    ``demod="fm"`` scores the per-channel FM discriminator instead of the
    squared envelope — an FM emission rides at constant amplitude, so the
    AM statistic is blind to it (and vice versa: run both to survey a band
    for both leakage modes).

    ``excise_db``: opt-in CW excision per channel before scoring (margin
    over the carrier peak, dB — :func:`_excise_spikes`); AM only.
    """
    check_excise_demod(demod, excise_db)
    if isinstance(iq_words, np.ndarray) and np.iscomplexobj(iq_words):
        iq_words = np.ascontiguousarray(iq_words, np.complex64).view(np.float32)
    iq_words = jnp.asarray(iq_words)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))

    # fs_chan is shape-derived (static, shared geometry helper): the jitted
    # sweep needs it as a hashable plain float.
    _, _, fs_chan = _channel_geometry(int(iq_words.shape[0]) // 2, fs,
                                      chan_bw)

    scores, proms, fvs, floor = _sweep_kernel(
        iq_words, float(fs), tuple(float(c) for c in centers),
        float(chan_bw), float(fs_chan), float(corr_seconds),
        float(rate_min), float(rate_max), demod=demod,
        excise_db=None if excise_db is None else float(excise_db))
    return ScanResult(
        centers_hz=centers,
        scores_db=np.asarray(scores, np.float64),
        prominence_db=np.asarray(proms, np.float64),
        refresh_hz=np.asarray(fvs, np.float64),
        fs_channel=fs_chan,
        floor_db=np.full(len(centers), float(floor)),
    )
