"""Golden-signal unit tests for the DSP kernels (SURVEY.md §4 test pyramid):
each kernel is checked against a NumPy oracle and/or the synthetic generator's
ground truth."""

import numpy as np
import jax.numpy as jnp
import pytest

from tempest_tpu.io.synthetic import generate_iq
from tempest_tpu.ops.autocorr import (
    autocorrelation,
    estimate_line_count,
    estimate_refresh,
    zoom_autocorr,
)
from tempest_tpu.ops.demod import am_demod, am_demod_power, fm_demod, invert_am_demod
from tempest_tpu.ops.framesync import (
    align_frame,
    align_frame_subpixel,
    blank_scores,
    frame_sync,
    frame_sync_subpixel,
    sync_spec_for_axis,
)
from tempest_tpu.ops.resample import (
    downgrade_image,
    frame_to_screen,
    linear_resample,
    naive_upsample,
    polyphase_resample,
    sig_to_image,
    upsample_fft,
)
from tempest_tpu.ops.spectrum import get_spectrum, get_waterfall, get_welch
from tempest_tpu.video.modes import ALL_VIDEO_MODES

RNG = np.random.default_rng(42)


# ---------------------------------------------------------------- demodulation
def test_am_demod():
    z = (RNG.standard_normal(1000) + 1j * RNG.standard_normal(1000)).astype(
        np.complex64
    )
    np.testing.assert_allclose(np.asarray(am_demod(z)), np.abs(z), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(am_demod_power(z)), np.abs(z) ** 2, rtol=1e-5
    )


def test_invert_am_demod():
    z = (RNG.standard_normal(512) + 1j * RNG.standard_normal(512)).astype(np.complex64)
    out = np.asarray(invert_am_demod(z))
    expected = 1.0 - np.abs(z) / np.abs(z).max()
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-6)
    assert out.min() >= -1e-6


def test_fm_demod_recovers_tone():
    """FM discriminator of a pure tone = constant 2*pi*f/fs."""
    fs, f = 1e6, 12345.0
    n = 4096
    z = np.exp(2j * np.pi * f / fs * np.arange(n)).astype(np.complex64)
    out = np.asarray(fm_demod(z))
    assert out[0] == 0.0
    np.testing.assert_allclose(out[1:], 2 * np.pi * f / fs, rtol=1e-3)


# -------------------------------------------------------------------- spectrum
def test_spectrum_tone_peak():
    fs = 1e6
    n = 4096
    f = fs / 8
    z = np.exp(2j * np.pi * f / fs * np.arange(n)).astype(np.complex64)
    freq, power = get_spectrum(fs, jnp.asarray(z))
    peak = float(freq[int(np.argmax(np.asarray(power)))])
    assert abs(peak - f) < fs / n


def test_welch_tone_peak():
    fs = 1e6
    f = fs / 4
    z = np.exp(2j * np.pi * f / fs * np.arange(16384)).astype(np.complex64)
    freq, power = get_welch(fs, jnp.asarray(z), fft_size=1024)
    assert abs(float(freq[int(np.argmax(np.asarray(power)))]) - f) < fs / 1024


def test_spectrum_fs_less_form_and_real_welch():
    """Parity conveniences: get_spectrum(sig) normalises the axis to
    [-0.5, 0.5) (GetSpectrum.jl:30) and get_welch accepts real signals of any
    float dtype (GetSpectrum.jl:37)."""
    n = 2048
    tone = np.cos(2 * np.pi * 0.125 * np.arange(n))
    freq, power = get_spectrum(jnp.asarray(tone.astype(np.float32)))
    assert float(freq[0]) == -0.5 and float(freq[-1]) < 0.5
    assert abs(abs(float(freq[int(np.argmax(np.asarray(power)))])) - 0.125) < 1e-3
    freq, power = get_welch(1e6, jnp.asarray(tone.astype(np.float64)), fft_size=512)
    assert abs(abs(float(freq[int(np.argmax(np.asarray(power)))])) - 0.125e6) < 2e3


def test_waterfall_shapes():
    z = (RNG.standard_normal(8192) + 1j * RNG.standard_normal(8192)).astype(
        np.complex64
    )
    t_ax, f_ax, mat = get_waterfall(1e6, jnp.asarray(z), fft_size=1024)
    assert mat.shape == (1024, 8)
    assert t_ax.shape == (8,) and f_ax.shape == (1024,)


# ------------------------------------------------------------- autocorrelation
def test_autocorrelation_matches_numpy_oracle():
    fs = 1e5
    x = RNG.standard_normal(8192).astype(np.float32)
    gamma, lags = autocorrelation(jnp.asarray(x), fs, 0.0, 0.01)
    i_hi = round(0.01 * fs)
    n_raw = min(2 * i_hi, len(x))
    n_up = 1 << (n_raw - 1).bit_length()
    n = n_up if n_up <= len(x) else 1 << (len(x).bit_length() - 1)
    spec = np.fft.fft(x[:n])
    corr = np.fft.ifft(spec * np.conj(spec))
    expected = 10 * np.log10(np.abs(corr[:i_hi]) ** 2 + 1e-30)
    np.testing.assert_allclose(np.asarray(gamma), expected, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(lags), np.arange(i_hi) / fs)


def test_autocorrelation_periodic_signal_peak():
    """A periodic pulse train must produce a correlation peak at its period."""
    fs = 1e5
    period = 400
    x = np.zeros(40000, np.float32)
    x[::period] = 1.0
    gamma, _ = autocorrelation(jnp.asarray(x), fs, 0.0, 0.02, scale="linear")
    g = np.asarray(gamma)
    assert abs(int(np.argmax(g[period // 2 : 3 * period // 2])) + period // 2
               - period) <= 1


def test_autocorrelation_short_signal_caps_lags_at_half_window():
    """When the signal is too short for the requested lag range, lags past
    n_fft/2 of the CIRCULAR autocorrelation are mirrors of low lags (corr[k]
    == corr[n-k]) and must not be returned: they fed mirrored near-zero-lag
    energy to the comb estimators as fake long-lag peaks (pure-noise blocks
    scored 44 dB screen-ness through this path)."""
    fs = 4e6
    x = RNG.standard_normal(400000).astype(np.float32)
    gamma, lags = autocorrelation(jnp.asarray(x), fs, 0.0, 0.05)
    # n_fft falls back to 2^18 = 262144 (< 2 * 200000 requested lags).
    assert gamma.shape[0] == 262144 // 2
    assert float(np.asarray(lags)[-1]) < (262144 // 2) / fs


def test_widen_peaks_does_not_wrap_edges():
    """The box-3 widening must not roll circularly: wrapping folds the
    zero-lag peak (orders of magnitude above everything) into the LAST
    lag's widened value, and any comb harmonic landing there scores a
    spurious mountain."""
    from tempest_tpu.ops.autocorr import _widen_peaks

    lin = np.ones(100, np.float32)
    lin[0] = 1e6          # the c0-like peak
    lin[60] = 5.0
    w = np.asarray(_widen_peaks(jnp.asarray(lin)))
    assert w[-1] < 10.0, w[-1]          # no c0 contamination at the edge
    assert w[0] > 1e6                   # the peak itself keeps its mass
    np.testing.assert_allclose(w[59:62], [7.0, 7.0, 7.0])


def test_zoom_autocorr_axis():
    fs = 1e5
    gamma = jnp.asarray(RNG.standard_normal(5000).astype(np.float32))
    rates, sl = zoom_autocorr(gamma, fs, rate_min=50, rate_max=90)
    r = np.asarray(rates)
    assert r[0] == pytest.approx(fs / round(fs / 90))
    assert r[-1] == pytest.approx(fs / round(fs / 50))
    assert sl.shape == r.shape


def test_refresh_and_line_count_from_synthetic():
    """End-to-end estimator check on the generator's ground truth."""
    mode = ALL_VIDEO_MODES["1024x768 @ 60Hz"]  # 1344x806 total
    fs = 16e6
    n = int(fs * 0.35)  # ~21 frames
    cap = generate_iq(mode, fs, n, snr_db=20.0, seed=7)
    env = am_demod_power(jnp.asarray(cap.iq))
    gamma, _ = autocorrelation(env, fs, 0.0, 0.1)
    fv = float(estimate_refresh(gamma, fs, 50.0, 90.0))
    assert abs(fv - 60.0) < 0.05
    y_t = float(estimate_line_count(gamma, fs, fv))
    assert abs(y_t - mode.height) < 3.0


# ------------------------------------------------------------------ resampling
def test_linear_resample_identity_and_line():
    x = jnp.arange(100, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(linear_resample(x, 100)), np.asarray(x))
    up = np.asarray(linear_resample(x, 400))
    # A linear ramp must stay (piecewise) linear under linear interpolation.
    assert np.max(np.abs(np.diff(up)[2:-2] - 0.25)) < 1e-5


def test_sig_to_image_shape_and_rows():
    """A signal that is constant per scan line maps to constant image rows."""
    y_t, x_t = 20, 32
    sig = np.repeat(np.arange(y_t, dtype=np.float32), x_t)
    img = np.asarray(sig_to_image(jnp.asarray(sig), y_t, x_t))
    assert img.shape == (y_t, x_t)
    # Row medians must be monotone in the line index.
    med = np.median(img, axis=1)
    assert np.all(np.diff(med) > 0)


def test_frame_to_screen_matches_two_stage():
    """The fused gather must agree with sig_to_image + downgrade_image on
    band-limited content (the two compositions are equal up to interpolation
    error, which only vanishes for smooth signals)."""
    y_t, x_t = 150, 200
    t = np.arange(7000)
    sig = (
        np.sin(2 * np.pi * t / 800.0) + 0.5 * np.cos(2 * np.pi * t / 173.0)
    ).astype(np.float32)
    fused = np.asarray(frame_to_screen(jnp.asarray(sig), y_t, x_t, (60, 80)))
    two = np.asarray(
        downgrade_image(sig_to_image(jnp.asarray(sig), y_t, x_t), (60, 80))
    )
    assert fused.shape == two.shape == (60, 80)
    err = np.abs(fused - two) / (np.abs(two).max() + 1e-9)
    assert np.percentile(err, 95) < 0.02
    assert err.max() < 0.06


def test_naive_upsample():
    x = jnp.asarray([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(
        np.asarray(naive_upsample(x, 3)), [1, 1, 1, 2, 2, 2, 3, 3, 3]
    )


def test_upsample_fft_tone():
    """FFT upsampling of a tone must reproduce the denser tone."""
    n, up = 256, 4
    t = np.arange(n)
    x = np.cos(2 * np.pi * 5 * t / n).astype(np.float32)
    out = np.asarray(upsample_fft(jnp.asarray(x), up))
    dense = np.cos(2 * np.pi * 5 * np.arange(n * up) / (n * up))
    # Ignore edge taper from the windowed filter.
    core = slice(n, n * up - n)
    assert np.max(np.abs(out[core] - dense[core])) < 0.05


def test_polyphase_resample_tone():
    """Fractional resampling of a tone by an irrational-ish ratio."""
    fs = 1000.0
    f = 40.0
    n_in = 4096
    ratio = 0.7371
    x = np.sin(2 * np.pi * f / fs * np.arange(n_in)).astype(np.float32)
    n_out = int((n_in - 16) / ratio)
    out = np.asarray(polyphase_resample(jnp.asarray(x), n_out, ratio))
    expected = np.sin(2 * np.pi * f / fs * ratio * np.arange(n_out))
    core = slice(32, n_out - 32)
    assert np.max(np.abs(out[core] - expected[core])) < 0.02


# ------------------------------------------------------------------ frame sync
def _image_with_blank(y_t, x_t, blank_row, blank_col, bw_y=12, bw_x=24, seed=0):
    """Bright content with a dark wrap-around blanking cross, then inverted
    (blanking bright) as after invert_amDemod."""
    rng = np.random.default_rng(seed)
    img = 0.5 + 0.2 * rng.standard_normal((y_t, x_t)).astype(np.float32)
    rows = (np.arange(-bw_y, bw_y + 1) + blank_row) % y_t
    cols = (np.arange(-bw_x, bw_x + 1) + blank_col) % x_t
    img[rows, :] = 1.0
    img[:, cols] = 1.0
    return img


def test_blank_scores_matches_reference_oracle():
    """blank_scores must equal a direct O(n*w) transcription of fill_β!."""
    n = 64
    profile = RNG.standard_normal(n).astype(np.float32)
    spec = sync_spec_for_axis(n, 0.05)
    beta = np.asarray(blank_scores(jnp.asarray(profile), spec))
    total = profile.sum()
    expected = np.zeros_like(beta)
    for ci in range(n):
        for wi, w in enumerate(range(spec.w_min, spec.w_max + 1)):
            s = 2 * sum(profile[(ci + k) % n] for k in range(-w, w + 1))
            expected[wi, ci] = ((total - s) / (2 * (n - w)) + s / (2 * w)) ** 2
    np.testing.assert_allclose(beta, expected, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("blank_row,blank_col", [(37, 101), (0, 0), (580, 790)])
def test_frame_sync_finds_blanking(blank_row, blank_col):
    img = _image_with_blank(600, 800, blank_row, blank_col)
    s_y, s_x, score = frame_sync(jnp.asarray(img))
    # Any position inside the (synthetically flat) blanking band is a valid
    # lock — the contrast score ties across windows fully inside the band.
    d_y = min((int(s_y) - blank_row) % 600, (blank_row - int(s_y)) % 600)
    d_x = min((int(s_x) - blank_col) % 800, (blank_col - int(s_x)) % 800)
    assert d_y <= 12 and d_x <= 24
    assert float(score) > 0


def test_align_frame_rolls_blank_to_border():
    img = _image_with_blank(120, 160, 30, 50, bw_y=5, bw_x=8)
    s_y, s_x, _ = frame_sync(jnp.asarray(img))
    aligned = np.asarray(align_frame(jnp.asarray(img), s_y, s_x))
    # After alignment the blanking centre sits at (0, 0).
    assert aligned[0].mean() > np.median(aligned)
    assert aligned[:, 0].mean() > np.median(aligned)


def _image_with_smooth_blank(h, w, cy, cx, sy=4.0, sx=6.0):
    """Bright field with smooth (Gaussian) dark bands crossing at the
    fractional centre (cy, cx) — circular on both axes."""
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    dy = (yy - cy + h / 2) % h - h / 2
    dx = (xx - cx + w / 2) % w - w / 2
    band_y = np.exp(-0.5 * (dy / sy) ** 2)
    band_x = np.exp(-0.5 * (dx / sx) ** 2)
    return (1.0 - 0.8 * np.maximum(band_y, band_x)).astype(np.float32)


@pytest.mark.parametrize("cy,cx", [(30.4, 50.7), (70.0, 100.25)])
def test_frame_sync_subpixel_accuracy(cy, cx):
    """Parabolic refinement must recover a smooth blanking band's centre to a
    fraction of a pixel (the integer argmax is only exact to ±0.5)."""
    img = _image_with_smooth_blank(120, 160, cy, cx)
    s_y, s_x, score = frame_sync_subpixel(jnp.asarray(img))
    d_y = abs((float(s_y) - cy + 60) % 120 - 60)
    d_x = abs((float(s_x) - cx + 80) % 160 - 80)
    assert d_y < 0.3 and d_x < 0.3, (float(s_y), float(s_x))
    assert float(score) > 0


def test_frame_sync_subpixel_reference_scorer():
    """The sub-pixel refinement must also work on the reference's fill_β!
    scorer (method='reference'), staying consistent with its integer argmax."""
    from tempest_tpu.ops.framesync import find_blank, find_blank_subpixel

    img = _image_with_smooth_blank(120, 160, 30.4, 50.7)
    profile = np.asarray(img).sum(axis=1).astype(np.float32)
    spec = sync_spec_for_axis(120, 0.01)
    c_int, s_int = find_blank(jnp.asarray(profile), spec, method="reference")
    c_sub, s_sub = find_blank_subpixel(
        jnp.asarray(profile), spec, method="reference")
    assert abs(float(c_sub) - float(c_int)) <= 0.5
    np.testing.assert_allclose(float(s_sub), float(s_int), rtol=1e-5)


def test_align_frame_subpixel_integer_matches_roll():
    img = RNG.standard_normal((24, 32)).astype(np.float32)
    for interp in ("linear", "cubic"):
        out = np.asarray(
            align_frame_subpixel(jnp.asarray(img), jnp.float32(3.0),
                                 jnp.float32(5.0), interp)
        )
        ref = np.asarray(align_frame(jnp.asarray(img), 3, 5))
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_align_frame_subpixel_matmul_matches_rolls():
    """The shift-operator matmul registration (S_y @ img @ S_x^T built on
    device from the traced offsets) must equal the roll formulation on CPU
    f32 for both kernels and any shift sign/magnitude."""
    from tempest_tpu.ops.framesync import align_frame_subpixel_matmul

    img = jnp.asarray(RNG.standard_normal((48, 64)).astype(np.float32))
    for interp in ("linear", "cubic"):
        for sy, sx in ((3.25, -7.8), (0.0, 0.5), (47.9, 63.1), (-1.3, 2.0)):
            a = np.asarray(align_frame_subpixel(
                img, jnp.float32(sy), jnp.float32(sx), interp))
            b = np.asarray(align_frame_subpixel_matmul(
                img, jnp.float32(sy), jnp.float32(sx), interp))
            np.testing.assert_allclose(a, b, atol=2e-5)


@pytest.mark.parametrize("interp,tol", [("linear", 0.02), ("cubic", 0.005)])
def test_align_frame_subpixel_fractional_shift(interp, tol):
    """A fractional roll of a low-frequency sinusoid must match the analytic
    shift (linear interpolation attenuates slightly; cubic less)."""
    h, w = 48, 64
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sy, sx = 2.6, -1.3

    def field(y0, x0):
        return (np.cos(2 * np.pi * (yy - y0) / h)
                * np.cos(2 * np.pi * (xx - x0) / w)).astype(np.float32)

    out = np.asarray(
        align_frame_subpixel(jnp.asarray(field(0.0, 0.0)), jnp.float32(sy),
                             jnp.float32(sx), interp)
    )
    np.testing.assert_allclose(out, field(-sy, -sx), atol=tol)


def test_frame_to_screen_variants_agree():
    """rows / mxu variants must match the reference gather path."""
    from tempest_tpu.ops.resample import frame_to_screen_mxu, frame_to_screen_rows

    y_t, x_t, n_in, shape = 525, 800, 66666, (600, 800)
    t = np.arange(n_in)
    sig = jnp.asarray(
        (np.sin(2 * np.pi * t / 797.0) + 0.3 * np.cos(2 * np.pi * t / 91.0)).astype(
            np.float32
        )
    )
    ref = np.asarray(frame_to_screen(sig, y_t, x_t, shape))
    scale = np.abs(ref).max()
    rows = np.asarray(frame_to_screen_rows(sig, y_t, x_t, shape))
    assert np.abs(ref - rows).max() / scale < 1e-5
    mxu = np.asarray(frame_to_screen_mxu(sig, y_t, x_t, shape))
    # mxu quantises the scanline phase; interior accuracy bound.
    assert np.abs(ref - mxu)[1:-1].max() / scale < 2e-2
    # One-hot-einsum permutation must equal the gather permutation exactly
    # (both select the same rows; f32 one-hot matmul is exact).
    mxu2 = np.asarray(frame_to_screen_mxu(sig, y_t, x_t, shape, perm="einsum"))
    assert np.abs(mxu - mxu2).max() / scale < 1e-5
    # Zero-gather variant: same values up to the bf16 envelope cast (~0.4%).
    from tempest_tpu.ops.resample import frame_to_screen_mxu3

    mxu3 = np.asarray(frame_to_screen_mxu3(sig, y_t, x_t, shape))
    assert np.abs(mxu - mxu3).max() / scale < 2e-2
    assert np.abs(ref - mxu3)[1:-1].max() / scale < 2e-2


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_frames_to_screens_mxu_segments_agree(segments):
    """The batched MXU resampler (pre-sorted gather, any segment split) must
    match the per-frame gather path to phase-quantisation accuracy."""
    from tempest_tpu.ops.resample import frames_to_screens_mxu

    y_t, x_t, shape = 525, 800, (600, 800)
    frame_len, n_frames = 66666, 2
    n_in = frame_len * n_frames + 64
    t = np.arange(n_in)
    sig = jnp.asarray(
        (np.sin(2 * np.pi * t / 797.0) + 0.3 * np.cos(2 * np.pi * t / 91.0)).astype(
            np.float32
        )
    )
    starts = np.array([0, frame_len], np.int32)
    got = np.asarray(
        frames_to_screens_mxu(
            sig, starts, frame_len, y_t, x_t, shape,
            compute_dtype=jnp.float32, segments=segments,
        )
    )
    for f, s in enumerate(starts):
        ref = np.asarray(frame_to_screen(sig[s : s + frame_len], y_t, x_t, shape))
        scale = np.abs(ref).max()
        assert np.abs(ref - got[f])[1:-1].max() / scale < 2e-2


def test_frames_to_screens_fft_agrees_with_gather():
    """The gather-free spectral resampler must match the reference gather
    path on band-limited content (sinc vs linear interpolation differ only
    at the interpolation-error level there; frame-edge rows wrap
    circularly, so compare the interior)."""
    from tempest_tpu.ops.resample import frames_to_screens_fft

    y_t, x_t, shape = 525, 800, (600, 800)
    frame_len, n_frames = 66666, 2
    n_in = frame_len * n_frames + 8
    t = np.arange(n_in)
    sig = jnp.asarray(
        (np.sin(2 * np.pi * t / 797.0) + 0.3 * np.cos(2 * np.pi * t / 91.0)).astype(
            np.float32
        )
    )
    starts = np.array([0, frame_len], np.int32)
    got = np.asarray(
        frames_to_screens_fft(sig, starts, frame_len, y_t, x_t, shape)
    )
    assert got.shape == (n_frames, *shape)
    for f, s in enumerate(starts):
        ref = np.asarray(
            frame_to_screen(sig[s : s + frame_len], y_t, x_t, shape)
        )
        scale = np.abs(ref).max()
        assert np.abs(ref - got[f])[2:-2].max() / scale < 5e-3


@pytest.mark.parametrize("w_out", [800, 1200, 1600])
def test_mxu3_wide_render_grids_match_gather(w_out):
    """Output grids wider than the raster (w_out > x_t) must render
    correctly — the geometry helper used to derive the column step from
    edge-clipped positions, silently corrupting every wide grid."""
    rng = np.random.default_rng(5)
    n = 133333
    env = rng.random(n).astype(np.float32)
    spec = np.fft.rfft(env)
    spec[len(spec) // 6:] = 0
    sig = jnp.asarray(np.fft.irfft(spec, n).astype(np.float32))
    from tempest_tpu.ops.resample import frame_to_screen_mxu3

    a = np.asarray(frame_to_screen_mxu3(sig, 628, 1056, (600, w_out)))
    g = np.asarray(frame_to_screen(sig, 628, 1056, (600, w_out)))
    # Row 0 differs by boundary semantics (gather clips, mxu clamps).
    err = np.abs(a - g)[1:] / (g.max() - g.min())
    assert err.max() < 0.01, err.max()


def test_frames_to_screens_mxu3_exact_matches_gather():
    """The block-level exact-cut mxu3 (static per-frame fractional offsets
    folded into host-built tables) must agree with the gather resampler
    interpolating at the same offsets, on band-limited signal."""
    from tempest_tpu.ops.resample import frames_to_screens_mxu3_exact

    y_t, x_t, frame_len = 525, 800, 66666
    rng = np.random.default_rng(7)
    env_np = rng.random(frame_len * 3 + 2000).astype(np.float32)
    spec = np.fft.rfft(env_np)
    spec[len(spec) // 6:] = 0  # band-limit: interpolation families agree
    env_np = np.fft.irfft(spec, len(env_np)).astype(np.float32)
    env = jnp.asarray(env_np)
    starts = np.array([0, 66666, 133333], np.int64)
    fracs = np.array([0.0, 0.33, 0.77], np.float32)
    shape = (600, 800)
    got = np.asarray(frames_to_screens_mxu3_exact(
        env, starts, fracs, frame_len, y_t, x_t, shape))
    assert got.shape == (3, 600, 800)
    for f, (s, fr) in enumerate(zip(starts, fracs)):
        ref = np.asarray(frame_to_screen(
            env[s : s + frame_len], y_t, x_t, shape, offset=float(fr)))
        scale = np.abs(ref).max()
        assert np.abs(ref - got[f])[2:-2].max() / scale < 5e-3, f


def test_phase_weights_catmull_rom_beats_linear():
    """interp_taps=4 (Catmull-Rom) must interpolate band-limited signal far
    more accurately than taps=2 (linear) at the same matrix shape — the
    'higher order for free' claim, checked against the analytic truth."""
    from tempest_tpu.ops.resample import _phase_weights

    span, w_out, P = 256, 200, 16
    cols = np.arange(w_out) * 0.9
    w2 = _phase_weights(cols, span, w_out, P, taps=2)
    w4 = _phase_weights(cols, span, w_out, P, taps=4)

    def sig(t):
        return (np.sin(2 * np.pi * 0.05 * t)
                + 0.5 * np.sin(2 * np.pi * 0.11 * t + 1.0))

    x = sig(np.arange(span)).astype(np.float32)
    err2 = err4 = 0.0
    for p in range(P):
        pos = (p + 0.5) / P + cols
        truth = sig(pos)
        # skip the edge columns (tap -1 clamps at the span start)
        err2 = max(err2, np.abs((x @ w2[p]) - truth)[2:-2].max())
        err4 = max(err4, np.abs((x @ w4[p]) - truth)[2:-2].max())
    assert err4 < 0.25 * err2, (err2, err4)
    # Each weight column sums to 1 (DC exactness) for both orders.
    assert np.allclose(w4.sum(axis=1), 1.0, atol=1e-5)


def test_mxu3_interp_taps4_matches_linear_on_bandlimited():
    """Wiring check: mxu3 with interp_taps=4 agrees with taps=2 on smooth
    content (both approximate the same band-limited resample) while sharing
    every other table."""
    from tempest_tpu.ops.resample import frame_to_screen_mxu3

    n = 66666
    env_np = np.random.default_rng(11).random(n).astype(np.float32)
    spec = np.fft.rfft(env_np)
    spec[len(spec) // 6:] = 0
    sig = jnp.asarray(np.fft.irfft(spec, n).astype(np.float32))
    a = np.asarray(frame_to_screen_mxu3(sig, 525, 800, (600, 800)))
    b = np.asarray(frame_to_screen_mxu3(sig, 525, 800, (600, 800),
                                        interp_taps=4))
    scale = a.max() - a.min()
    # Bounds are interpolation-family differences (cubic vs linear) on
    # band-limited noise — ~1% pointwise.
    assert np.abs(a - b)[1:].max() / scale < 0.015
    # and against the analytic gather reference
    g = np.asarray(frame_to_screen(sig, 525, 800, (600, 800)))
    assert np.abs(b - g)[1:].max() / scale < 0.015


def test_mxu3_einsum_bf16_and_phase_count_close():
    """The weight-streaming levers (bf16 einsum operands, halved phase
    count) must stay within fractions of a percent of the f32/64-phase
    output even on white-noise input (the worst case for phase
    quantisation)."""
    from tempest_tpu.ops.resample import frame_to_screen_mxu3

    sig = jnp.asarray(RNG.random(66666).astype(np.float32))
    a = np.asarray(frame_to_screen_mxu3(sig, 525, 800, (600, 800)))
    scale = a.max() - a.min()
    b = np.asarray(frame_to_screen_mxu3(sig, 525, 800, (600, 800),
                                        einsum_bf16=True))
    assert np.abs(a - b).max() / scale < 5e-3
    c = np.asarray(frame_to_screen_mxu3(sig, 525, 800, (600, 800),
                                        num_phases=32))
    assert np.abs(a - c).max() / scale < 2e-2


def test_fm_demod_from_iq_matches_complex():
    from tempest_tpu.ops.demod import fm_demod_from_iq

    z = (RNG.standard_normal(512) + 1j * RNG.standard_normal(512)).astype(
        np.complex64
    )
    ref = np.asarray(fm_demod(jnp.asarray(z)))
    got = np.asarray(fm_demod_from_iq(jnp.asarray(z.view(np.float32))))
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("n", [64, 500, 4096, 333])  # incl. non-128-multiples
def test_iq_ingest_formulations_match_oracle(n):
    """The one-hot-matmul de-interleave kernels (am_envelope_from_iq,
    am_power_from_iq, fm_demod_from_iq, planar variants) must equal the
    direct numpy computation for any length."""
    from tempest_tpu.ops.demod import (
        am_envelope_from_iq,
        am_envelope_from_iq_planar,
        am_power_from_iq,
        fm_demod_from_iq,
        fm_demod_from_iq_planar,
        to_planar_iq,
    )

    words = RNG.integers(-16384, 16384, 2 * n).astype(np.int16)
    i = words[0::2].astype(np.float64)
    q = words[1::2].astype(np.float64)
    env_ref = np.sqrt(i * i + q * q)
    np.testing.assert_allclose(
        np.asarray(am_envelope_from_iq(jnp.asarray(words))), env_ref,
        rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(am_power_from_iq(jnp.asarray(words))), i * i + q * q,
        rtol=1e-6)
    planar = to_planar_iq(words)
    assert planar.shape == (2, n) and planar.flags["C_CONTIGUOUS"]
    np.testing.assert_allclose(
        np.asarray(am_envelope_from_iq_planar(jnp.asarray(planar))), env_ref,
        rtol=1e-6)
    z = i + 1j * q
    fm_ref = np.concatenate([[0.0], np.angle(z[1:] * np.conj(z[:-1]))])
    np.testing.assert_allclose(
        np.asarray(fm_demod_from_iq(jnp.asarray(words))), fm_ref, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(fm_demod_from_iq_planar(jnp.asarray(planar))), fm_ref,
        atol=1e-5)


def test_frames_to_screens_aligned_matches_reference():
    from tempest_tpu.ops.resample import frames_to_screens_aligned

    y_t, x_t, spf = 525, 800, 66666.7
    rng = np.random.default_rng(3)
    env = rng.random(int(spf * 3) + 2000).astype(np.float32)
    spec = np.fft.rfft(env)
    spec[len(spec) // 6 :] = 0
    env = np.fft.irfft(spec).astype(np.float32)
    starts = np.round(np.arange(3) * spf).astype(np.int32)
    frame_len = int(spf)
    outs = np.asarray(
        frames_to_screens_aligned(jnp.asarray(env), starts, frame_len, y_t, x_t)
    )
    for f in range(3):
        ref = np.asarray(
            frame_to_screen(
                jnp.asarray(env[starts[f] : starts[f] + frame_len]), y_t, x_t
            )
        )
        d = np.abs(outs[f] - ref) / np.abs(ref).max()
        # Interior exact; first/last 2 rows differ by edge-clip semantics.
        assert d[2:-2].max() < 1e-5


@pytest.mark.parametrize("name", ["am_envelope_from_iq", "am_power_from_iq",
                                  "fm_demod_from_iq"])
def test_one_hot_moves_run_at_full_precision(name):
    """At DEFAULT precision a GPU runs these one-hot de-interleave dots in
    TF32, which rounds the moved I/Q values; they must ask for HIGHEST."""
    import jax

    from tempest_tpu.ops import demod

    fn = getattr(demod, name)
    with jax.default_matmul_precision("tensorfloat32"):
        text = jax.jit(fn).lower(jnp.zeros(256, jnp.float32)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots and all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)
