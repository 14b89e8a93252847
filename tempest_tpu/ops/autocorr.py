"""FFT autocorrelation and screen-timing estimators (refresh rate, line count).

Capability parity with the reference's ``Autocorrelations`` module
(``/root/reference/src/Autocorrelations.jl:23-53``) plus fully-automated
refresh/line-count estimation that the reference does half-interactively
(argmax over a zoom window in ``GUI.jl:73-81`` for the refresh; a *user click*
or the offline script's first-500-lags argmax for the line count,
``production/investigate_data.jl:69-82``).

Design notes:

* The envelope is real, so we use ``rfft``/``irfft`` — half the FFT work of
  the reference's complex FFT pair.
* Lag index 0 of the returned array always corresponds to lag
  ``round(min_delay * fs)`` samples.  With ``min_delay=0`` (every live call in
  the reference) the conventions coincide exactly; note the reference's
  ``zoom_autocorr`` labels 1-indexed position ``pos`` with rate ``Fs/pos``,
  a one-sample axis skew that our 0-indexed convention removes.
* Peak positions are refined by parabolic interpolation over the correlation
  peak, giving sub-sample lag (hence sub-Hz refresh and sub-line count)
  resolution — important because one lag at 20 Msps is 0.36 lines at 1080p60.
* Everything is shape-static and jittable; the estimators return traced
  scalars so they can live inside a fused end-to-end pipeline.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "autocorrelation",
    "zoom_autocorr",
    "parabolic_peak",
    "estimate_refresh",
    "estimate_line_count",
    "estimate_snr",
    "suggest_alpha",
    "top_line_period_peaks",
]

_EPS = 1e-30


def autocorrelation(
    x: jnp.ndarray,
    fs: float,
    min_delay: float,
    max_delay: float,
    scale: str = "log",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Circular autocorrelation magnitude over lags in ``[min_delay, max_delay)``
    seconds (reference ``calculate_autocorrelation``,
    ``Autocorrelations.jl:23-37``).

    Returns ``(gamma, lags)`` where ``gamma[k]`` is ``10*log10(|corr|^2)`` (or
    ``|corr|^2`` for ``scale="linear"``) at lag ``lags[k]`` seconds, starting
    at lag index ``round(min_delay * fs)``.

    FFT length: the reference uses ``min(2 * round(max_delay*fs), len(x))``
    (``Autocorrelations.jl:27``); we round that to a power of two, the
    fastest FFT size on every backend (a non-smooth size was once lowered
    as a dense DFT matmul — an O(n²) matrix for n in the millions).  The
    slightly shorter correlation window is statistically irrelevant.
    """
    i_lo = int(round(min_delay * fs))
    i_hi = int(round(max_delay * fs))  # exclusive lag bound
    n_raw = min(2 * i_hi, x.shape[0])
    # Prefer the next power of two ABOVE n_raw (more signal, keeps ≥50%
    # circular overlap at the longest lags); fall back to the largest power
    # of two the signal can supply.
    n_up = 1 << max(n_raw - 1, 1).bit_length()
    n = n_up if n_up <= x.shape[0] else 1 << (max(x.shape[0], 2).bit_length() - 1)
    # Lags past n/2 of a CIRCULAR autocorrelation are mirrors of low lags
    # (corr[k] == corr[n-k]), not measurements: when a short signal forces
    # n below 2·i_hi, returning them feeds mirrored near-zero-lag energy to
    # the comb estimators as fake long-lag peaks (measured: pure-noise
    # blocks scoring 44 dB screen-ness at "60.000 Hz" through exactly this
    # path).  Long signals keep n ≥ 2·i_hi, where this cap is a no-op.
    i_hi = min(i_hi, n // 2)
    xw = x[:n]
    if jnp.iscomplexobj(xw):
        spec = jnp.fft.fft(xw)
        corr = jnp.fft.ifft(spec * jnp.conj(spec))
        power = jnp.abs(corr[i_lo:i_hi]) ** 2
    else:
        spec = jnp.fft.rfft(xw.astype(jnp.float32))
        corr = jnp.fft.irfft(jnp.abs(spec) ** 2, n=n)
        power = corr[i_lo:i_hi] ** 2
    lags = jnp.arange(i_lo, i_hi) / fs
    if scale == "log":
        return 10.0 * jnp.log10(power + _EPS), lags
    return power, lags


def zoom_autocorr(
    gamma: jnp.ndarray, fs: float, rate_min: float = 20.0, rate_max: float = 100.0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Re-window an autocorrelation (lag k ↔ k/fs, i.e. ``min_delay=0``) to
    the band of repetition rates ``[rate_min, rate_max]`` Hz (reference
    ``zoom_autocorr``, ``Autocorrelations.jl:42-53``).

    Returns ``(rates, gamma_slice)`` with ``rates`` descending from near
    ``rate_max`` to ``rate_min``.
    """
    n = gamma.shape[0]
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    pos = jnp.arange(pos_lo, pos_hi + 1)
    return fs / pos, gamma[pos_lo : pos_hi + 1]


def parabolic_peak(y: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Sub-sample peak location: fit a parabola through ``y[idx-1:idx+2]`` and
    return the refined fractional index.  Falls back to ``idx`` at the array
    edges or for a degenerate (flat) vertex."""
    n = y.shape[0]
    i = jnp.clip(idx, 1, n - 2)
    ym1, y0, yp1 = y[i - 1], y[i], y[i + 1]
    denom = ym1 - 2.0 * y0 + yp1
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    refined = i + delta
    return jnp.where((idx >= 1) & (idx <= n - 2), refined, idx.astype(refined.dtype))


def _lerp(values: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation of a 1-D array at fractional positions."""
    n = values.shape[0]
    pos = jnp.clip(pos, 0.0, n - 1.000001)
    i0 = jnp.floor(pos).astype(jnp.int32)
    frac = pos - i0
    return values[i0] * (1.0 - frac) + values[i0 + 1] * frac


def _widen_peaks(lin: jnp.ndarray) -> jnp.ndarray:
    """Box-3 energy accumulation over the linear correlation.

    The envelope's correlation peaks are effectively sub-sample deltas whose
    mass splits between two bins when the true lag is fractional; point reads
    (even linearly interpolated) then under-estimate true peaks that straddle
    bins while flattering impostors that land on-bin — a systematic comb bias
    measured at ~11% on 1080p60/20 Msps signals.  Summing each bin with its
    two neighbours makes any read within ±1 sample of the true lag return the
    peak's *full mass* regardless of straddle (the floor scales by 3
    uniformly, preserving comparisons).

    Edge handling must NOT wrap: a circular roll folds the zero-lag peak
    (c0, orders of magnitude above everything) into the LAST lag's widened
    value, and any comb whose k-th harmonic lands on that index then scores
    a spurious mountain — measured as pure-noise blocks "detecting" a
    period at exactly half the lag window with 48 dB prominence."""
    prev = jnp.concatenate([lin[:1], lin[:-1]])
    nxt = jnp.concatenate([lin[1:], lin[-1:]])
    return lin + prev + nxt


def refine_period(
    lin: jnp.ndarray,
    lag0: jnp.ndarray,
    half_window: int,
    harmonics: int = 5,
    step: float = 0.125,
) -> jnp.ndarray:
    """Fractional-period refinement by an interpolated harmonic comb.

    The true repetition period is generically a *non-integer* number of
    samples and the envelope's correlation peaks are ~1 sample wide, so
    comparisons between discrete bins are dominated by sub-sample straddle.
    This scores every candidate period on a ``step``-sample grid around
    ``lag0`` by the *k-weighted* mean of the linearly-interpolated correlation
    at its first ``harmonics`` multiples: only the true period keeps all its
    harmonics on peak tops simultaneously, harmonic k narrows the alignment
    tolerance by 1/k, and weighting by k emphasises the most discriminative
    harmonics — a one-line-period impostor's k-th harmonic is shifted k lines
    and decays monotonically, so late harmonics separate P from P±L even for
    content with highly similar adjacent rows.  Returns the refined
    fractional lag.
    """
    n = lin.shape[0]
    lin = _widen_peaks(lin)
    offs = jnp.arange(-half_window / step, half_window / step + 1) * step
    cand = lag0.astype(jnp.float32) + offs.astype(jnp.float32)
    score = jnp.zeros(cand.shape, lin.dtype)
    wsum = jnp.zeros(cand.shape, lin.dtype)
    for k in range(1, harmonics + 1):
        pos = k * cand
        valid = pos < n - 1
        score = score + jnp.where(valid, k * _lerp(lin, pos), 0.0)
        wsum = wsum + jnp.where(valid, float(k), 0.0)
    return cand[jnp.argmax(score / jnp.maximum(wsum, 1.0))]


def estimate_refresh(
    gamma: jnp.ndarray,
    fs: float,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    harmonics: int = 5,
    scale: str = "log",
) -> jnp.ndarray:
    """Refresh rate fv [Hz] from the autocorrelation (automates
    ``GUI.jl:73-81``), with two robustness upgrades over the reference's bare
    argmax:

    * a screen emanation's autocorrelation peaks at every ``k·P + m·L``
      (P frame period, L line period); when adjacent rows are similar the
      ``m = ±1`` side peaks rival the true one and a bare integer argmax can
      land a full line period off (tens of mHz of refresh error, one line of
      skew per frame);
    * the true P is a non-integer number of samples, so discrete-bin peak
      values are corrupted by sub-sample straddle.

    Both are fixed by ``refine_period``'s fractional interpolated comb seeded
    from the coarse argmax; a prominence-based octave descent additionally
    rejects 2P/3P locks so wide search bands (20–130 Hz) are safe.  Pass the
    same ``gamma`` the display path uses (log scale by default); the comb
    internally works on linear power.
    """
    n = gamma.shape[0]
    lin = 10.0 ** (gamma / 10.0) if scale == "log" else gamma
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    window = lin[pos_lo : pos_hi + 1]
    lag0 = pos_lo + jnp.argmax(window)
    # Octave disambiguation (for wide search bands): every multiple of 2P is
    # also a repetition lag, so the argmax can land on 2P/3P (half/third the
    # true refresh).  Prominence-comb the subdivided periods and descend when
    # they score comparably — same rule as estimate_line_count's line-period
    # descent, using the widened (box-3) reads.
    linw = _widen_peaks(lin)
    floor = jnp.median(linw[pos_lo : pos_hi + 1])

    def comb_prom(pos_f):
        score = jnp.zeros(pos_f.shape, linw.dtype)
        count = jnp.zeros(pos_f.shape, linw.dtype)
        for k in range(1, harmonics + 1):
            p = k * pos_f
            valid = p < n - 1
            score = score + jnp.where(valid, _lerp(linw, p) - floor, 0.0)
            count = count + valid.astype(linw.dtype)
        return score / jnp.maximum(count, 1.0)

    lag_f = lag0.astype(jnp.float32)
    best_score = comb_prom(lag_f[None])[0]
    for k in (3, 2):
        sub = lag_f / k
        sub_score = comb_prom(sub[None])[0]
        take = (sub >= pos_lo) & (sub_score >= 0.7 * best_score)
        lag_f = jnp.where(take, sub, lag_f)
        best_score = jnp.where(take, sub_score, best_score)
    # Comb window: generously covers ±3 line periods for any plausible mode
    # (L ≤ fs / (50 Hz · 200 lines)); static because fs is static.
    half = max(int(3 * fs / 10000), 8)
    lag = refine_period(lin, lag_f, half, harmonics)
    return fs / lag


def estimate_snr(env: jnp.ndarray) -> jnp.ndarray:
    """Envelope-domain SNR proxy [dB] via one-lag decorrelation: receiver
    noise is white (dies within one sample of lag) while screen content is
    strongly correlated sample-to-sample, so with the mean removed,
    ``SNR ≈ c1 / (c0 − c1)`` where ``c_k`` is the lag-k autocovariance.
    Monotone in the true IQ SNR over at least [−5, 30] dB (measured) and
    cheap (two dot products).  Drives automatic frame-averaging strength —
    no reference equivalent: the user turns the LPF slider until the image
    looks right (``GUI.jl:617-620``)."""
    env0 = env - jnp.mean(env)
    c0 = jnp.mean(env0 * env0)
    c1 = jnp.mean(env0[:-1] * env0[1:])
    ratio = jnp.maximum(c1, 1e-12) / jnp.maximum(c0 - c1, 1e-12)
    return 10.0 * jnp.log10(ratio)


def suggest_alpha(snr_db: jnp.ndarray | float) -> jnp.ndarray:
    """EMA coefficient from the envelope-domain SNR proxy: noisy signals
    average harder (alpha→0.9, ~10-frame memory), clean signals stay
    responsive (alpha→0.1).  Ramp spans proxy +2 dB (clean) → −15 dB
    (very noisy), matching the measured proxy range for 30 → −5 dB IQ SNR."""
    t = jnp.clip((2.0 - jnp.asarray(snr_db, jnp.float32)) / 17.0, 0.0, 1.0)
    return 0.1 + 0.8 * t


def top_line_period_peaks(
    gamma: np.ndarray,
    fs: float,
    fv: float,
    k: int = 5,
    y_min: int = 200,
    y_max: int = 2500,
    harmonics: int = 6,
    scale: str = "log",
    rate_min: float = 50.0,
    rate_max: float = 90.0,
) -> np.ndarray:
    """Ranked line-period candidates — the *operator override* for when the
    automatic lock lands on the wrong peak (strong interferer, pathological
    content).  The reference handles this interactively: the human clicks a
    different peak of the zoomed autocorrelation and ``delay2yt`` converts
    the clicked delay to a line count (``/root/reference/src/GUI.jl:512-523,
    238-252``).  Here the full ranked list is first-class: every local
    maximum of the same prominence-comb score ``estimate_line_count``
    maximises, refined to fractional lag, deduplicated, ordered by score.

    Host-side numpy (an evidence/diagnostic surface, not a hot path).
    Returns an (m, 3) float array of rows ``(lag_samples, y_t, score)``,
    ``m ≤ k``, best first; row 0 is (up to refinement details) the automatic
    estimate's choice.
    """
    g = np.asarray(gamma, np.float64)
    n = g.shape[0]
    lin_raw = 10.0 ** (g / 10.0) if scale == "log" else g
    # Box-3 widen WITHOUT wrapping (the numpy mirror of _widen_peaks — a
    # circular roll folds the zero-lag peak into lin[n-1] and any comb
    # harmonic reading near the last index then ranks a spurious candidate
    # first; same bug class fixed in the jax copy).
    lin = (lin_raw
           + np.concatenate([lin_raw[:1], lin_raw[:-1]])
           + np.concatenate([lin_raw[1:], lin_raw[-1:]]))
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    floor = np.median(lin[lag_lo : lag_hi + 1])
    cand = np.arange(lag_lo, lag_hi + 1, dtype=np.float64)

    def comb(pos: np.ndarray) -> np.ndarray:
        score = np.zeros_like(pos)
        count = np.zeros_like(pos)
        xs = np.arange(n, dtype=np.float64)
        for h in range(1, harmonics + 1):
            p = h * pos
            valid = p < n - 1
            score += np.where(valid, np.interp(p, xs, lin) - floor, 0.0)
            count += valid
        return score / np.maximum(count, 1.0)

    scores = comb(cand)
    # Local maxima of the comb score, ranked.
    locmax = np.r_[False, (scores[1:-1] > scores[:-2])
                   & (scores[1:-1] >= scores[2:]), False]
    order = np.argsort(scores[locmax])[::-1]
    lags = cand[locmax][order]
    peak_scores = scores[locmax][order]

    picked: list[tuple[float, float, float]] = []
    for lag, sc in zip(lags, peak_scores):
        # Fractional refinement (numpy mirror of refine_period, k-weighted).
        offs = np.arange(-3 / 0.125, 3 / 0.125 + 1) * 0.125
        fine = lag + offs
        fs_score = np.zeros_like(fine)
        wsum = np.zeros_like(fine)
        xs = np.arange(n, dtype=np.float64)
        for h in range(1, harmonics + 1):
            p = h * fine
            valid = p < n - 1
            fs_score += np.where(valid, h * np.interp(p, xs, lin), 0.0)
            wsum += np.where(valid, float(h), 0.0)
        lag_f = float(fine[np.argmax(fs_score / np.maximum(wsum, 1.0))])
        y_t = fs / (fv * lag_f)
        if any(abs(y_t - y) < 2.0 for _, y, _ in picked):
            continue  # refines into an already-listed candidate
        picked.append((lag_f, y_t, float(sc)))
        if len(picked) == k:
            break
    return np.array(picked, np.float64).reshape(-1, 3)


def estimate_line_count(
    gamma: jnp.ndarray,
    fs: float,
    fv: jnp.ndarray | float,
    y_min: int = 200,
    y_max: int = 2500,
    harmonics: int = 6,
    scale: str = "log",
    rate_min: float = 50.0,
    rate_max: float = 90.0,
) -> jnp.ndarray:
    """Total line count y_t: the autocorrelation peaks at the *line* period
    ``L = fs / (fv * y_t)``; find L and return ``fs / (fv * L)``.

    Replaces the reference's interactive click on the zoomed correlation
    (``GUI.jl:512-523``, ``delay2yt``) / the offline script's windowed argmax
    (``production/investigate_data.jl:69-82``), with two estimator upgrades:

    * **harmonic comb** over integer candidates (like ``estimate_refresh``);
    * **subharmonic disambiguation**: every multiple of 2L is also a peak, so
      a comb can lock an octave low (y_t halved) when aliasing weakens the
      fundamental.  The test uses *prominence over the noise floor* (median of
      the window): for a candidate locked at 2L, the true L's multiples are
      all peaks (prominence ratio ≈ 1); for a candidate already at the true L,
      L/2's multiples only hit peaks at even k (ratio ≈ 0.5) — so a 0.7
      threshold separates the cases even at low SNR, where raw-mean ratios
      collapse toward 1.

    Static slice bounds come from the static (fs, y_min, y_max) so the
    function stays jittable; traced ``fv`` enters only the final division.
    """
    n = gamma.shape[0]
    lin_raw = 10.0 ** (gamma / 10.0) if scale == "log" else gamma
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    lin = _widen_peaks(lin_raw)
    cand = jnp.arange(lag_lo, lag_hi + 1)
    floor = jnp.median(lin[lag_lo : lag_hi + 1])

    def comb(pos_f: jnp.ndarray) -> jnp.ndarray:
        """Mean floor-subtracted (prominence) correlation over K multiples."""
        score = jnp.zeros(pos_f.shape, lin.dtype)
        count = jnp.zeros(pos_f.shape, lin.dtype)
        for k in range(1, harmonics + 1):
            p = k * pos_f
            valid = p < n - 1
            score = score + jnp.where(valid, _lerp(lin, p) - floor, 0.0)
            count = count + valid.astype(lin.dtype)
        return score / jnp.maximum(count, 1.0)

    scores = comb(cand.astype(jnp.float32))
    best = jnp.argmax(scores)
    lag = cand[best].astype(jnp.float32)
    best_score = scores[best]
    # Subharmonic descent: a ratio ≥ 0.7 of the best prominence means the
    # subdivided period's multiples are all real peaks — descend.
    for k in (3, 2):
        sub = lag / k
        sub_score = comb(sub[None])[0]
        take = (sub >= lag_lo) & (sub_score >= 0.7 * best_score)
        lag = jnp.where(take, sub, lag)
        best_score = jnp.where(take, sub_score, best_score)
    # Fractional (sub-sample) refinement around the chosen period — pass the
    # *un-widened* correlation: refine_period applies the box-3 energy read
    # itself (double widening flattens the comb optimum).
    lag = refine_period(lin_raw, lag, 3, harmonics)
    return fs / (fv * lag)
