"""Offline end-to-end reconstruction pipeline — the framework's flagship chain.

Automates the reference's canonical offline analysis
(``/root/reference/production/investigate_data.jl:37-206``) and live consumer
loop (``coreProcessing``, ``/root/reference/src/GUI.jl:120-205``) as two jitted
stages:

1. ``estimate_timing`` — envelope power → FFT autocorrelation → refresh rate
   fv and total line count y_t (sub-sample refined).
2. ``reconstruct`` — envelope → per-frame signal slices → fused
   signal→screen resampling → frame synchronisation → alignment →
   exponentially-averaged frame.

A thin host orchestrator (``auto_reconstruct``) runs stage 1, snaps the
estimates to the video-mode database (a host-side table lookup, as in
``GUI.jl:568-580``), then runs stage 2 with the chosen static geometry.  Stage
boundaries are where static shapes change, so this is the natural XLA
decomposition — *not* a port of the reference's reactive Observable graph.

Design details:
* The whole of stage 2 is one fusion chain per frame batch; the EMA across
  frames is a closed-form weighted reduction over the frame axis (the
  reference's ``imageOut = α·imageOut + (1-α)·image``, ``GUI.jl:175``).
* Frames are cut by *fractional* frame period: frame n starts at
  ``round(n * fs / fv)`` rather than ``n * round(fs / fv)``, fixing the
  cumulative drift of the reference's integer rounding
  (``GUI.jl:98,108`` — SURVEY.md §7 hard part (3)).
* Per-frame blanking offsets are detected independently (vmapped) and the
  roll is applied with dynamic shifts; all shapes stay static.
"""

from __future__ import annotations

import collections
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.autocorr import (
    autocorrelation,
    estimate_line_count,
    estimate_refresh,
    estimate_snr,
    suggest_alpha,
)
from ..ops.demod import (
    am_demod,
    am_envelope_from_iq,
    am_envelope_from_iq_planar,
    am_power_from_iq,
    fm_demod,
    fm_demod_from_iq,
    fm_demod_from_iq_planar,
    to_planar_iq,
)
from ..ops.framesync import (
    align_frame,
    align_frame_subpixel,
    frame_sync,
    frame_sync_subpixel,
)
from ..ops.resample import (
    RENDER_SIZE,
    frame_to_screen,
    frame_to_screen_mxu,
    frame_to_screen_mxu3,
    frame_to_screen_mxu4,
    frame_to_screen_rows,
    frames_to_screens_aligned,
    frames_to_screens_fft,
    frames_to_screens_mxu,
    frames_to_screens_mxu3_exact,
)
from ..video.modes import VideoMode, find_closest_mode

__all__ = [
    "RESAMPLERS",
    "STAGES",
    "TimingEstimate",
    "TimingEvidence",
    "ReconstructionConfig",
    "Reconstruction",
    "estimate_timing",
    "timing_evidence",
    "pick_line_peak",
    "make_reconstruct_fn",
    "make_batched_reconstruct_fn",
    "reconstruct_frames",
    "auto_reconstruct",
]

# Valid ``ReconstructionConfig.resampler`` values (see its comment).
RESAMPLERS = ("mxu3", "mxu", "mxu2", "mxu4", "gather", "rows", "fft",
              "mxu_batched", "aligned")

# Named scopes (``jax.named_scope``) that label the stages of the one-card
# step programs in the compiled HLO and hence in device traces
# (``utils.profiling.stage_times``); nested scopes count for the innermost.
STAGES = ("demod", "resample", "sync", "ema")


@dataclasses.dataclass(frozen=True)
class TimingEstimate:
    refresh_hz: float
    line_count: float
    mode_name: str
    mode: VideoMode
    snr_db: float = float("nan")  # autocorrelation contrast proxy

    @property
    def suggested_alpha(self) -> float:
        """EMA coefficient matched to the measured SNR (see suggest_alpha)."""
        import numpy as _np

        return float(suggest_alpha(self.snr_db)) if _np.isfinite(self.snr_db) else 0.1


@dataclasses.dataclass(frozen=True)
class ReconstructionConfig:
    """Static parameters of a reconstruction program.  A distinct config is a
    distinct XLA executable (cached by jit)."""

    sample_rate: float
    mode: VideoMode
    n_frames: int
    render_size: tuple[int, int] = RENDER_SIZE
    invert: bool = False      # blanking dark (False) or use inverted envelope
    do_align: bool = True     # per-frame blanking alignment (GUI.jl:170-173)
    # Sub-pixel alignment: refine each frame's sync offset with a parabolic
    # fit of the contrast score and register with a fractional (2-tap
    # interpolated) roll instead of an integer circshift.  The EMA then
    # accumulates frames at sub-pixel registration — shift-and-add
    # super-resolution over the averaged image (the reference stops at
    # integer circshift, GUI.jl:172).  Measured on the judged 1080p60 /
    # 20 Msps synthetic capture: +0.3-0.6 dB PSNR on deep averages.
    align_subpixel: bool = False
    # Interpolation kernel for the fractional registration roll: "linear"
    # (2-tap) or "cubic" (4-tap Catmull-Rom — sharper under deep averaging).
    align_interp: str = "linear"
    # How the fractional registration is applied: "matmul" builds circulant
    # shift operators on device from the traced offsets and applies
    # S_y @ frame @ S_x^T as matmuls; "roll" applies 4-8 dynamic full-image
    # rolls per frame.  Same separable interpolation (equal up to f32
    # reassociation; CPU agreement ≤1.5e-7).  On a GPU the DEFAULT-precision
    # f32 matmuls run in TF32, so "matmul" rounds the frame to 10 mantissa
    # bits per pass (chip_smoke.py checks the agreement on the card).
    align_impl: str = "matmul"
    # "complex64": iq is complex [block_samples];
    # "envelope": iq is float32 [block_samples], ALREADY demodulated (e.g.
    # the multi-harmonic fusion of ops.combine) — demod is a pass-through;
    # "iq_interleaved": iq is int16/float32 [2*block_samples] raw I/Q words —
    # half the host->device bandwidth, no complex math on device;
    # "iq_planar": iq is int16/float32 [2, block_samples] (row 0 = I) — the
    # interleaved words de-interleaved on the HOST (ops.demod.to_planar_iq),
    # so the device does only contiguous elementwise demod.
    input_format: str = "complex64"
    # Demodulator: "am" envelope (the TEMPEST standard) or "fm"
    # discriminator (reference defines fmDemod, Demodulation.jl:17-23).
    demod: str = "am"
    # Resampler variant (one of RESAMPLERS): "mxu3" zero-gather one-hot
    # matmuls + static slices (DEFAULT; selection in bf16 — exact selection,
    # the envelope's f32->bf16 cast costs ~0.4%, far below capture noise),
    # "mxu" per-frame phase-quantised matmuls with a span gather (full f32),
    # "mxu2" = mxu with a matmul phase-sort, "mxu4" = mxu3 with a depthwise
    # conv alignment, "gather" flat 4-tap gather (the plain reference the
    # others are tested against), "fft" gather-free spectral line
    # rectification (sinc interpolation; wants a 2*3*5-smooth frame_len),
    # "rows" span gather + take_along_axis, "mxu_batched" one cross-frame
    # einsum, "aligned" chunk gather + take_along_axis.  Which one wins on
    # the GPU is not measured yet.
    resampler: str = "mxu3"
    # Column segments per scan line for the batched-mxu resampler: higher
    # values shrink the gathered span (less padding waste) and the per-phase
    # weight matrices (~1/segments² of the HBM traffic).  Must divide
    # render_size[1].
    segments: int = 1
    # Fractional-phase quantisation of the mxu resamplers: the envelope's
    # sub-sample cut offset is rounded to 1/num_phases of a sample (64 →
    # ±1/128 sample ≈ ±0.02 render px at 1080p).  Halving it halves the
    # per-phase weight tensor — the resample stage's HBM traffic driver.
    num_phases: int = 64
    # bf16 operands for the interpolation einsum (f32 accumulation): halves
    # the weight streaming at ~0.2% coefficient rounding (mxu3 only).
    einsum_bf16: bool = False
    # Interpolation order of the matmul resamplers' phase weight matrices: 2 =
    # linear (the reference's imresize class, Resampler.jl:117-126), 4 =
    # Catmull-Rom cubic — SAME einsum shapes (the span is 128-padded), i.e.
    # higher interpolation order at no extra matmul cost.  Honoured by the
    # mxu/mxu2/mxu3/mxu4 resamplers, the exact-cut tables and the streaming
    # fidelity plan; the gather/rows/aligned/fft variants keep their own
    # kernels (fft is already sinc).
    interp_taps: int = 2
    # Per-frame loop structure for the per-frame resamplers ("gather", "rows",
    # "mxu"): "vmap" batches all frames into wide ops; "scan" compiles the
    # per-frame chain once and iterates (flat compile size in n_frames, no
    # cross-frame batching).
    frame_loop: str = "vmap"
    # Sub-sample-exact frame cuts: fold each frame boundary's fractional
    # residual into the resampling positions instead of rounding to the
    # nearest sample (a 3-tap traced-weight read; requires
    # resampler='gather').  Measured on synthetic 640x480/4 Msps, 40 frames,
    # alpha .9: +0.61 dB PSNR over rounded cuts when per-frame sync is off,
    # and 15.48 vs 15.43 dB against the best do_align=True config — i.e. the
    # highest-fidelity mode is exact cuts + drift-locked timing with the
    # per-frame sync stage (and its integer-pixel roll quantisation) skipped.
    # With do_align=True the sync roll already compensates cut jitter at
    # pixel granularity (measured delta ~0).
    subsample_align: bool = False
    # With carry_phase, step() takes an extra traced fractional sample offset
    # of the first frame boundary inside the block, so a streaming caller can
    # keep frame cuts continuous across block boundaries (the reference cuts
    # buffer-aligned and drifts, GUI.jl:165-166; SURVEY.md §5).  The block
    # must then hold one extra frame period of slack.
    carry_phase: bool = False
    # Streaming fidelity at matmul speed: with carry_phase + subsample_align
    # + resampler='mxu3', the block's fractional carry phase is quantised to
    # 1/phase_bins of a sample and the exact-cut grouping tables for that bin
    # are fed to ONE compiled program as small int32 inputs (one-hots rebuilt
    # on device) — see ops.resample.StreamingExactPlan.  0 disables (that
    # combination then requires resampler='gather', the traced-offset path).
    phase_bins: int = 0
    # Fused demod+cut for the quantised streaming chain: slice the raw
    # interleaved int16 words FIRST and demodulate per-frame rows
    # (StreamingExactPlan.cut_words_am) — bit-identical values (slicing
    # commutes with the pointwise pair demod).  Off by default: one
    # contiguous whole-block demod pass is expected to fuse better than F
    # overlapping per-frame passes (not measured on the GPU yet).  Needs
    # demod='am', invert=False, input_format='iq_interleaved'.
    fuse_demod_cut: bool = False

    def __post_init__(self) -> None:
        if self.resampler not in RESAMPLERS:
            raise ValueError(
                f"unknown resampler {self.resampler!r}; valid resamplers: "
                f"{', '.join(RESAMPLERS)}")

    @property
    def samples_per_frame(self) -> float:
        return self.sample_rate / self.mode.refresh

    @property
    def block_samples(self) -> int:
        """IQ samples consumed per call: n_frames frame periods plus slack —
        one sample for fractional cuts, plus a whole frame period of phase
        headroom when ``carry_phase`` is on."""
        slack = 1 + (int(np.ceil(self.samples_per_frame)) if self.carry_phase else 0)
        return int(np.ceil(self.samples_per_frame * self.n_frames)) + slack


@dataclasses.dataclass
class Reconstruction:
    image: np.ndarray        # EMA-averaged aligned frame (render_size)
    frames: np.ndarray       # per-frame aligned screens (n_frames, *render_size)
    sync: np.ndarray         # per-frame (s_y, s_x)
    score: np.ndarray        # per-frame sync contrast score
    # When MTF restoration ran (auto_reconstruct(restore=True)), ``image`` is
    # the restored screen and this keeps the raw EMA it was computed from.
    image_raw: np.ndarray | None = None

    @property
    def blanking_is_dark(self) -> bool:
        """Detected blanking polarity: after alignment the blanking interval
        sits along the top/left border; compare its level to the interior.
        True ⇒ blanking darker than content (display the image as-is);
        False ⇒ blanking brighter (real TEMPEST intermodulation often inverts
        video — render with ``invert=True`` for a natural-looking screen).
        The reference leaves this choice to a hardcoded ``findmax`` + manual
        squinting (``FrameSynchronisation.jl:51-53``)."""
        h, w = self.image.shape
        bh, bw = max(h // 40, 2), max(w // 40, 2)
        border = float(
            np.concatenate(
                [self.image[:bh].ravel(), self.image[:, :bw].ravel()]
            ).mean()
        )
        interior = float(self.image[h // 4 : -h // 4, w // 4 : -w // 4].mean())
        return border < interior


@partial(jax.jit, static_argnames=("fs", "corr_seconds", "interleaved",
                                   "rate_min", "rate_max", "envelope"))
def _timing_kernel(iq: jnp.ndarray, fs: float, corr_seconds: float,
                   interleaved: bool = False,
                   rate_min: float = 50.0, rate_max: float = 90.0,
                   envelope: bool = False):
    if envelope:
        env = iq.astype(jnp.float32)  # already demodulated (ops.combine)
    elif interleaved:
        env = am_power_from_iq(iq)
    else:
        env = jnp.real(iq) ** 2 + jnp.imag(iq) ** 2  # |z|^2 envelope (GUI.jl:70)
    gamma, _ = autocorrelation(env, fs, 0.0, corr_seconds)
    fv = estimate_refresh(gamma, fs, rate_min, rate_max)
    y_t = estimate_line_count(gamma, fs, fv, rate_min=rate_min, rate_max=rate_max)
    snr = estimate_snr(env)
    return fv, y_t, snr


def estimate_timing(
    iq: np.ndarray | jnp.ndarray,
    fs: float,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    envelope: bool = False,
) -> TimingEstimate:
    """Stage 1: refresh rate + line count from ~``corr_seconds`` of signal,
    snapped to the closest known video mode (automates ``GUI.jl:49-88`` +
    the interactive y_t pick).

    ``iq`` may be complex64 or raw interleaved I/Q words (int16/float32, even
    length) — or, with ``envelope=True``, an already-demodulated real
    envelope (e.g. the multi-harmonic fusion of ``ops.combine``).  Host
    complex input is reinterpreted as interleaved float32 (zero-copy view)
    before the device transfer, keeping every host→device boundary real
    (half the bytes of a complex upload for int16 words, and no complex
    dtype at the boundary).
    """
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    iq = jnp.asarray(iq)
    interleaved = not envelope and not jnp.iscomplexobj(iq)
    fv, y_t, snr = _timing_kernel(
        iq, float(fs), float(corr_seconds), interleaved,
        float(rate_min), float(rate_max), envelope,
    )
    fv_f, y_f = float(fv), float(y_t)
    name, mode = find_closest_mode(y_f, fv_f)
    # Keep the *measured* refresh (the true pixel clock differs from nominal —
    # e.g. 60.14 Hz on the reference's demo capture, docs/src/gui.md:29) but
    # the mode's pixel geometry.
    refined = VideoMode(mode.width, mode.height, fv_f)
    return TimingEstimate(fv_f, y_f, name, refined, float(snr))


@dataclasses.dataclass(frozen=True)
class TimingEvidence:
    """The correlation evidence behind a :class:`TimingEstimate` — what the
    reference GUI plots live in its two interactive panels
    (``GUI.jl:296-356``, ``ScreenRenderer.jl:131-139``): the zoomed
    autocorrelation over the refresh band with the detected peak, and the
    line-period lag window with the detected line-rate peak."""

    rates_hz: np.ndarray       # refresh-band axis (descending, Hz)
    gamma_rates: np.ndarray    # 10log10|Γ|² over the refresh band
    refresh_hz: float          # detected peak (marked on the panel)
    line_lags: np.ndarray      # line-period lag axis [samples]
    gamma_lines: np.ndarray    # 10log10|Γ|² over the line-lag window
    line_lag: float            # detected line period [samples]
    line_count: float          # fs / (fv * line_lag)
    # Ranked alternative line-period peaks, rows (lag, y_t, comb score) —
    # the operator's recovery path when the automatic lock is wrong (the
    # reference's click on the other peak, GUI.jl:512-523).
    line_peaks: np.ndarray | None = None

    def rate_mark(self) -> float:
        """Fractional x position of the refresh peak ON THE DRAWN PANEL.

        The panels plot the gamma arrays against INDEX, and the rates axis
        is 1/lag-spaced (rate = fs/lag over a linear lag window) — so the
        mark must be the peak's index fraction, not its rate-linear
        fraction (which sat up to a few percent off the plotted peak, found
        when the web click-to-pick mapped clicks through the same
        geometry)."""
        r = np.asarray(self.rates_hz)
        i = int(np.argmin(np.abs(r - self.refresh_hz)))
        return i / max(len(r) - 1, 1)

    def line_mark(self) -> float:
        """Fractional x position of the line-period peak on the drawn
        panel (index space, same convention as :meth:`rate_mark`; the lag
        axis is uniform so this equals the lag-linear fraction)."""
        lags = np.asarray(self.line_lags)
        i = int(np.argmin(np.abs(lags - self.line_lag)))
        return i / max(len(lags) - 1, 1)


@partial(jax.jit, static_argnames=("fs", "corr_seconds", "interleaved",
                                   "rate_min", "rate_max", "envelope"))
def _evidence_kernel(iq: jnp.ndarray, fs: float, corr_seconds: float,
                     interleaved: bool,
                     rate_min: float, rate_max: float,
                     envelope: bool = False):
    if envelope:
        env = iq.astype(jnp.float32)  # already demodulated
    elif interleaved:
        env = am_power_from_iq(iq)
    else:
        env = jnp.real(iq) ** 2 + jnp.imag(iq) ** 2
    gamma, _ = autocorrelation(env, fs, 0.0, corr_seconds)
    fv = estimate_refresh(gamma, fs, rate_min, rate_max)
    y_t = estimate_line_count(gamma, fs, fv, rate_min=rate_min, rate_max=rate_max)
    snr = estimate_snr(env)
    return gamma, fv, y_t, snr


def timing_evidence(
    iq: np.ndarray | jnp.ndarray,
    fs: float,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    y_min: int = 200,
    y_max: int = 2500,
    envelope: bool = False,
) -> tuple[TimingEstimate, TimingEvidence]:
    """Stage 1 with its evidence: the timing estimate plus the correlation
    windows it was read from, for rendering (``analyze --plots`` / the stream
    HUD sparkline).  Same input conventions as :func:`estimate_timing`
    (incl. ``envelope=True`` for an already-demodulated real signal)."""
    from ..ops.autocorr import zoom_autocorr

    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    iq = jnp.asarray(iq)
    interleaved = not envelope and not jnp.iscomplexobj(iq)
    gamma, fv, y_t, snr = _evidence_kernel(
        iq, float(fs), float(corr_seconds), interleaved,
        float(rate_min), float(rate_max), envelope,
    )
    fv_f, y_f = float(fv), float(y_t)
    name, mode = find_closest_mode(y_f, fv_f)
    timing = TimingEstimate(
        fv_f, y_f, name, VideoMode(mode.width, mode.height, fv_f), float(snr)
    )
    rates, g_rates = zoom_autocorr(gamma, fs, rate_min, rate_max)
    # Line-period window: the same static bounds estimate_line_count searches.
    n = int(gamma.shape[0])
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    from ..ops.autocorr import top_line_period_peaks

    evidence = TimingEvidence(
        rates_hz=np.asarray(rates),
        gamma_rates=np.asarray(g_rates),
        refresh_hz=fv_f,
        line_lags=np.arange(lag_lo, lag_hi + 1, dtype=np.float64),
        gamma_lines=np.asarray(gamma[lag_lo : lag_hi + 1]),
        line_lag=float(fs / (fv_f * y_f)),
        line_count=y_f,
        line_peaks=top_line_period_peaks(
            np.asarray(gamma), fs, fv_f,
            rate_min=rate_min, rate_max=rate_max,
            y_min=y_min, y_max=y_max,
        ),
    )
    return timing, evidence


def pick_line_peak(
    timing: TimingEstimate, evidence: TimingEvidence, n: int
) -> TimingEstimate:
    """Adopt ranked line-period peak ``n`` (0-based) from the evidence: the
    operator override for a wrong automatic lock — the reference's
    click-the-other-peak + ``delay2yt`` (``GUI.jl:512-523,238-252``), made
    scriptable.  Returns a new TimingEstimate snapped to the closest video
    mode at the picked line count (measured refresh kept)."""
    if evidence.line_peaks is None or not len(evidence.line_peaks):
        raise ValueError("evidence carries no ranked line peaks")
    if not 0 <= n < len(evidence.line_peaks):
        raise IndexError(
            f"peak {n} out of range (have {len(evidence.line_peaks)})"
        )
    y = float(evidence.line_peaks[n][1])
    name, mode = find_closest_mode(y, timing.refresh_hz)
    return TimingEstimate(
        refresh_hz=timing.refresh_hz,
        line_count=y,
        mode_name=name,
        mode=VideoMode(mode.width, mode.height, timing.refresh_hz),
        snr_db=timing.snr_db,
    )


def demodulate(iq: jnp.ndarray, config: ReconstructionConfig) -> jnp.ndarray:
    """Demodulation stage shared by the single-chip and sharded pipelines."""
    if config.input_format == "envelope":
        # Pre-demodulated real envelope (e.g. ops.combine's multi-harmonic
        # fusion): pass through, honouring only the polarity inversion.
        env = iq.astype(jnp.float32)
        if config.invert:
            env = 1.0 - env / jnp.max(env)
        return env
    if config.input_format == "iq_planar":
        env = (
            fm_demod_from_iq_planar(iq) if config.demod == "fm"
            else am_envelope_from_iq_planar(iq)
        )
    elif config.input_format == "iq_interleaved":
        env = (
            fm_demod_from_iq(iq) if config.demod == "fm"
            else am_envelope_from_iq(iq)
        )
    else:
        env = (
            fm_demod(iq) if config.demod == "fm"
            else am_demod(iq)
        ).astype(jnp.float32)
    if config.invert:
        env = 1.0 - env / jnp.max(env)
    return env


def _make_sync_one(config: ReconstructionConfig):
    """Per-frame sync+align stage (vmapped by callers) — the reference's
    ``vsync`` + ``circshift`` (``GUI.jl:171-173``) as a pure function."""

    def sync_one(screen):
        with jax.named_scope("sync"):
            return _sync_one(screen)

    def _sync_one(screen):
        if config.do_align and config.align_subpixel:
            s_y, s_x, score = frame_sync_subpixel(screen)
            if config.align_impl == "matmul":
                from ..ops.framesync import align_frame_subpixel_matmul

                aligned = align_frame_subpixel_matmul(
                    screen, s_y, s_x, config.align_interp)
            else:
                aligned = align_frame_subpixel(
                    screen, s_y, s_x, config.align_interp)
            return aligned, jnp.stack([s_y, s_x]), score
        if config.do_align:
            s_y, s_x, score = frame_sync(screen)
            return align_frame(screen, s_y, s_x), jnp.stack([s_y, s_x]), score
        zero = jnp.zeros((), jnp.int32)
        return screen, jnp.stack([zero, zero]), jnp.zeros(())

    return sync_one


def process_frames(
    env: jnp.ndarray,
    frame_starts: jnp.ndarray,
    config: ReconstructionConfig,
    frame_len: int,
    frac_offsets: jnp.ndarray | None = None,
):
    """Resample + sync + align all frames of one envelope block — the stage-2
    core shared by the single-chip and sharded pipelines.  Returns
    ``(frames, sync, score)`` with shapes ((F,h,w), (F,2), (F,)).

    ``frac_offsets`` (per-frame, in [0, 1)) enables sub-sample-exact cuts:
    each frame's slice is interpolated at its true fractional boundary
    before resampling (``config.subsample_align``)."""
    mode = config.mode
    h, w = config.render_size
    sync_one = _make_sync_one(config)

    if (
        config.resampler == "mxu3"
        and frac_offsets is not None
        and isinstance(frac_offsets, np.ndarray)
    ):
        # Sub-sample-exact cuts at full matmul speed: static per-frame
        # boundary residuals fold into host-built geometry tables (the
        # offline fidelity path; traced offsets fall through to 'gather').
        screens = frames_to_screens_mxu3_exact(
            env, np.asarray(frame_starts), frac_offsets, frame_len,
            mode.height, mode.width, (h, w),
            num_phases=config.num_phases, einsum_bf16=config.einsum_bf16,
            interp_taps=config.interp_taps,
        )
        return jax.vmap(sync_one)(screens)

    if config.resampler == "aligned":
        # Chunk-aligned gather + small-extent take_along_axis: gathers whole
        # 128-sample rows instead of arbitrary-offset elements.
        screens = frames_to_screens_aligned(
            env, frame_starts, frame_len, mode.height, mode.width, (h, w)
        )
    elif config.resampler == "mxu_batched":
        # All frames through ONE phase-sorted einsum; the phase permutation
        # is folded into the gather indices (no post-gather relayout).
        # Combine with config.segments > 1 to shrink spans and weight
        # traffic.
        screens = frames_to_screens_mxu(
            env, frame_starts, frame_len, mode.height, mode.width, (h, w),
            num_phases=config.num_phases, segments=config.segments,
        )
    elif config.resampler == "fft":
        # Gather-free spectral line rectification: bandlimited-resample each
        # frame to an integer per-line stride (rfft -> pad -> irfft), reshape,
        # one shared matmul for columns.  Sinc interpolation — exact for
        # band-limited content — and no span gather at all.  Wants frame_len
        # and y_t*l_pad 2*3*5-smooth (choose fs so that fs/fv is smooth, e.g.
        # 19.44 Msps at 60 Hz -> 324000) for fast FFT sizes.
        screens = frames_to_screens_fft(
            env, frame_starts, frame_len, mode.height, mode.width, (h, w)
        )
    else:
        np_ = config.num_phases
        taps = config.interp_taps
        resample = {
            "gather": frame_to_screen,
            "rows": frame_to_screen_rows,
            "mxu": partial(frame_to_screen_mxu, num_phases=np_,
                           interp_taps=taps),
            # mxu with the phase-sort permutation as a one-hot matmul
            # instead of a row gather.
            "mxu2": partial(frame_to_screen_mxu, num_phases=np_, perm="einsum",
                            interp_taps=taps),
            # zero-gather variant: chunk-select/align/regroup as one-hot
            # matmuls + static slices.
            "mxu3": partial(frame_to_screen_mxu3, num_phases=np_,
                            einsum_bf16=config.einsum_bf16, interp_taps=taps),
            # mxu3 with the alignment as one depthwise delta-kernel conv
            # (no slice stack, no regroup matmul).
            "mxu4": partial(frame_to_screen_mxu4, num_phases=np_,
                            interp_taps=taps),
        }[config.resampler]

        def cut_frame(start, frac=None):
            sig = jax.lax.dynamic_slice(env, (start,), (frame_len,))
            if frac is None:
                return resample(sig, mode.height, mode.width, (h, w))
            # Sub-sample-exact cut: fold the boundary residual into the
            # interpolation positions (3-tap traced-weight read) — the same
            # linear interpolation as the base path, no extra low-pass (a
            # windowed-sinc pre-shift measurably blurs the undersampled
            # envelope instead).
            return frame_to_screen(sig, mode.height, mode.width, (h, w),
                                   offset=frac)

        if config.frame_loop == "scan":
            # Compile the per-frame chain once and iterate: compile time is
            # flat in n_frames, so large blocks (which amortise the per-block
            # fixed cost) stay compile-light.  Frames are sequential on one
            # chip anyway; the scan only removes XLA's cross-frame batching.
            if frac_offsets is None:
                xs = jnp.asarray(frame_starts)
                body = lambda _, s: (None, sync_one(cut_frame(s)))
            else:
                xs = (jnp.asarray(frame_starts), jnp.asarray(frac_offsets))
                body = lambda _, x: (None, sync_one(cut_frame(*x)))
            _, (frames, sync, score) = jax.lax.scan(body, None, xs)
            return frames, sync, score
        if frac_offsets is None:
            if isinstance(frame_starts, np.ndarray):
                # Static starts: cut with static slices (XLA folds
                # slice/stack families) and batch the resampler over the
                # stacked frames.
                frames_sig = jnp.stack([
                    jax.lax.slice(env, (int(s),), (int(s) + frame_len,))
                    for s in frame_starts
                ])
                screens = jax.vmap(
                    lambda s: resample(s, mode.height, mode.width, (h, w))
                )(frames_sig)
            else:
                screens = jax.vmap(lambda s: cut_frame(s))(frame_starts)
        else:
            screens = jax.vmap(cut_frame)(frame_starts, frac_offsets)

    return jax.vmap(sync_one)(screens)


def ema_fold(ema: jnp.ndarray, frames: jnp.ndarray, alpha) -> jnp.ndarray:
    """EMA over the frame axis (``imageOut = α·imageOut + (1-α)·image``,
    GUI.jl:175), in closed form:

        out = α^F · ema + (1-α) · Σ_n α^(F-1-n) · frame_n

    — one weighted reduction instead of a ``lax.scan`` (no per-iteration
    loop overhead).  ``alpha`` may be traced: the weights are computed on
    device.
    """
    n = frames.shape[0]
    k = jnp.arange(n - 1, -1, -1, dtype=jnp.float32)
    w = (1.0 - alpha) * alpha ** k
    return alpha ** n * ema + jnp.einsum(
        "f,fhw->hw", w, frames, preferred_element_type=jnp.float32
    )


_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_PLAN_CACHE_MAX = 8   # a plan is ~17 MB of int16 grouping keys at 1080p/36f
                      # (index tables build lazily per bin) — 8 lets an
                      # operator bounce between nudged line counts for free
                      # without leaking under a long scanning session


def _get_plan(config: ReconstructionConfig, frame_len: int):
    """Cache StreamingExactPlan builds (~0.2 s of vectorised geometry at
    36f/64 bins; the per-bin index tables build lazily on first use) so
    fidelity hot-swaps and repeated program builds under the same config are
    free — the host-side analogue of the jit cache.  LRU-bounded: an
    operator nudging lines/refresh produces a fresh key per change."""
    from ..ops.resample import StreamingExactPlan

    mode = config.mode
    key = (frame_len, round(config.samples_per_frame, 6), config.n_frames,
           mode.height, mode.width, config.render_size, config.num_phases,
           config.phase_bins, config.interp_taps, config.einsum_bf16)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = StreamingExactPlan(
            frame_len, config.samples_per_frame, config.n_frames,
            mode.height, mode.width, config.render_size,
            num_phases=config.num_phases, phase_bins=config.phase_bins,
            interp_taps=config.interp_taps, einsum_bf16=config.einsum_bf16,
        )
        _PLAN_CACHE[key] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    else:
        _PLAN_CACHE.move_to_end(key)
    return plan


def _make_quantised_fidelity_fn(config: ReconstructionConfig, frame_len: int):
    """Streaming fidelity chain at matmul speed: carry-phase sub-sample-exact
    cuts through one compiled program with per-bin grouping tables passed as
    traced int32 inputs (see ``ops.resample.StreamingExactPlan``).

    Returns the same ``step(iq, ema, alpha, phase)`` surface as the traced
    carry_phase step; ``phase`` must be host-known (it is — the streaming
    runtime derives it from the absolute sample position)."""
    h, w = config.render_size
    plan = _get_plan(config, frame_len)
    sync_one = _make_sync_one(config)

    fused = config.fuse_demod_cut
    if fused and not (config.demod == "am" and not config.invert
                      and config.input_format == "iq_interleaved"):
        raise ValueError(
            "fuse_demod_cut=True needs demod='am', invert=False and "
            "input_format='iq_interleaved' (the word-level cut commutes "
            "only with the pointwise AM pair demod)"
        )

    @jax.jit
    def _table_step(iq, ema, alpha, m, sel_src, reg_src, blend_idx):
        if fused:
            with jax.named_scope("demod"):
                slices = plan.cut_words_am(iq, m)
            with jax.named_scope("resample"):
                screens = plan.resample_frames(slices, sel_src, reg_src,
                                               blend_idx)
        else:
            with jax.named_scope("demod"):
                env = demodulate(iq, config)
            with jax.named_scope("resample"):
                screens = plan.resample(env, m, sel_src, reg_src, blend_idx)
        frames, sync, score = jax.vmap(sync_one)(screens)
        with jax.named_scope("ema"):
            ema_out = ema_fold(ema, frames, alpha)
        return ema_out, frames, sync, score

    dev_tables: dict[int, tuple] = {}

    def _args(iq, ema, alpha, phase):
        k, m = plan.bin_for_phase(float(phase))
        tabs = dev_tables.get(k)
        if tabs is None:
            tabs = tuple(jnp.asarray(t) for t in plan.tables(k))
            dev_tables[k] = tabs
        return (iq, ema, alpha, jnp.int32(m), *tabs)

    def step(iq, ema, alpha, phase):
        return _table_step(*_args(iq, ema, alpha, phase))

    step.plan = plan  # exposed for tests / warmup introspection
    # The compiled program's arguments for a step call (bin tables added).
    step.args = _args
    step.lower = lambda *args: _table_step.lower(*_args(*args))
    return step


def make_reconstruct_fn(config: ReconstructionConfig):
    """Build the jitted stage-2 program for a fixed config.

    Returns ``step(iq, ema, alpha) -> (ema', frames, sync, score)`` where
    ``iq`` has ``config.block_samples`` complex samples and ``ema`` carries the
    averaged image across calls (the streaming state pytree).  Every step
    also offers ``step.lower(*args)`` (ahead-of-time lowering, as on a
    jitted function: memory analysis and the compiled HLO).
    """
    n_frames = config.n_frames
    spf = config.samples_per_frame
    frame_len = int(np.floor(spf))  # samples fed to the resampler per frame
    sub = config.subsample_align
    if sub and config.resampler not in ("gather", "mxu3"):
        raise ValueError(
            "subsample_align needs a resampler that takes the boundary "
            "residual — 'mxu3' (static cuts, full matmul speed) or "
            "'gather' (works with traced offsets / carry_phase)"
        )
    if sub and config.resampler == "mxu3" and config.carry_phase:
        if config.phase_bins <= 0:
            raise ValueError(
                "subsample_align with carry_phase traces the offsets — set "
                "phase_bins>0 (quantised static tables at matmul speed) or "
                "resampler='gather' (exact traced offsets, ~5x slower)"
            )
        return _make_quantised_fidelity_fn(config, frame_len)
    # Fractional frame-start offsets (static table, no cumulative drift).
    exact = np.arange(n_frames) * spf
    starts = (np.floor(exact) if sub else np.round(exact)).astype(np.int32)
    fracs = (exact - starts).astype(np.float32) if sub else None

    def _body(iq, ema, alpha, frame_starts, frac_offsets=None):
        with jax.named_scope("demod"):
            env = demodulate(iq, config)
        with jax.named_scope("resample"):   # sync_one scopes its own stage
            frames, sync, score = process_frames(
                env, frame_starts, config, frame_len, frac_offsets
            )
        with jax.named_scope("ema"):
            ema_out = ema_fold(ema, frames, alpha)
        return ema_out, frames, sync, score

    if config.carry_phase:

        @jax.jit
        def step(iq, ema, alpha, phase):
            # phase: fractional sample offset (float32) of the first frame
            # boundary within this block, in [0, spf).
            exact_t = phase + spf * jnp.arange(n_frames, dtype=jnp.float32)
            if sub:
                fstarts = jnp.floor(exact_t).astype(jnp.int32)
                return _body(iq, ema, alpha, fstarts,
                             exact_t - fstarts.astype(jnp.float32))
            fstarts = jnp.floor(exact_t + 0.5).astype(jnp.int32)
            return _body(iq, ema, alpha, fstarts)

    else:

        @jax.jit
        def step(iq, ema, alpha):
            # starts/fracs stay as static numpy arrays: process_frames routes
            # static-offset subsample_align to the exact-cut mxu3 tables.
            return _body(iq, ema, alpha, starts, fracs if sub else None)

    return step


def _make_fused_batched_fn(config: ReconstructionConfig):
    """Serving batch with the frame axis FUSED across streams: all B·F
    frames of a dispatch go through ONE batched resample/sync, and the EMA
    folds per stream with a single einsum — instead of vmapping the whole
    single-stream program (which batches stage by stage and re-tiles the
    small einsums per stream).  Same math to f32 reassociation."""
    n_frames = config.n_frames
    spf = config.samples_per_frame
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(n_frames) * spf).astype(np.int32)
    sync_one = _make_sync_one(config)
    mode = config.mode
    h, w = config.render_size
    taps = config.interp_taps
    resample = {
        "gather": frame_to_screen,
        "rows": frame_to_screen_rows,
        "mxu": partial(frame_to_screen_mxu, num_phases=config.num_phases,
                       interp_taps=taps),
        "mxu2": partial(frame_to_screen_mxu, num_phases=config.num_phases,
                        perm="einsum", interp_taps=taps),
        "mxu3": partial(frame_to_screen_mxu3, num_phases=config.num_phases,
                        einsum_bf16=config.einsum_bf16, interp_taps=taps),
        "mxu4": partial(frame_to_screen_mxu4, num_phases=config.num_phases,
                        interp_taps=taps),
    }[config.resampler]

    @jax.jit
    def step(iq_b, ema_b, alpha):
        env_b = jax.vmap(lambda iq: demodulate(iq, config))(iq_b)
        B = env_b.shape[0]
        frames_sig = jnp.stack([
            jax.lax.slice(env_b, (0, int(s)), (B, int(s) + frame_len))
            for s in starts
        ])                                       # (F, B, frame_len)
        flat = frames_sig.reshape(n_frames * B, frame_len)
        screens = jax.vmap(
            lambda s: resample(s, mode.height, mode.width, (h, w))
        )(flat)
        frames, sync, score = jax.vmap(sync_one)(screens)
        frames = frames.reshape(n_frames, B, h, w)
        k = jnp.arange(n_frames - 1, -1, -1, dtype=jnp.float32)
        wgt = (1.0 - alpha) * alpha ** k
        ema_out = alpha ** n_frames * ema_b + jnp.einsum(
            "f,fbhw->bhw", wgt, frames, preferred_element_type=jnp.float32)
        return (
            ema_out,
            frames.transpose(1, 0, 2, 3),
            sync.reshape(n_frames, B, 2).transpose(1, 0, 2),
            score.reshape(n_frames, B).transpose(1, 0),
        )

    return step


def _make_batched_quantised_fidelity_fn(config: ReconstructionConfig,
                                        frame_len: int):
    """Batched serving of the streaming fidelity chain: B independent
    carry-phase streams, each quantised to its own bin, all B·F frames
    through ONE tables graph.

    All K bins' grouping tables live device-resident as (K, F, …) int32
    arrays built once; each block, the per-stream bin indices (traced)
    gather their (F, …) slabs on device — no per-block table uploads at all.
    The integer phases become B contiguous dynamic-slice re-bases."""
    h, w = config.render_size
    F = config.n_frames
    plan = _get_plan(config, frame_len)
    sync_one = _make_sync_one(config)
    sel_all = jnp.asarray(plan.sel_src)      # (K, F, G_o) int32
    reg_all = jnp.asarray(plan.reg_src)      # (K, F, G_p)
    blend_all = jnp.asarray(plan.blend_idx)  # (K, F, n_lines)

    @jax.jit
    def inner(iq_b, ema_b, alpha, m_b, k_b):
        env_b = jax.vmap(lambda iq: demodulate(iq, config))(iq_b)
        B = env_b.shape[0]
        frames_sig = jnp.concatenate([
            plan.cut(env_b[b], m_b[b]) for b in range(B)
        ])                                        # (B*F, pad_len)
        screens = plan.resample_frames(
            frames_sig,
            sel_all[k_b].reshape(B * F, -1),
            reg_all[k_b].reshape(B * F, -1),
            blend_all[k_b].reshape(B * F, -1),
        )
        frames, sync, score = jax.vmap(sync_one)(screens)
        frames = frames.reshape(B, F, h, w)
        kk = jnp.arange(F - 1, -1, -1, dtype=jnp.float32)
        wgt = (1.0 - alpha) * alpha ** kk
        ema_out = alpha ** F * ema_b + jnp.einsum(
            "f,bfhw->bhw", wgt, frames, preferred_element_type=jnp.float32)
        return (ema_out, frames, sync.reshape(B, F, 2), score.reshape(B, F))

    def step(iq_b, ema_b, alpha, phases):
        km = [plan.bin_for_phase(float(p)) for p in np.asarray(phases)]
        k_b = jnp.asarray([k for k, _ in km], jnp.int32)
        m_b = jnp.asarray([m for _, m in km], jnp.int32)
        return inner(iq_b, ema_b, alpha, m_b, k_b)

    step.plan = plan
    return step


def make_batched_reconstruct_fn(config: ReconstructionConfig, fuse: bool | None = None):
    """Multi-stream variant: B independent IQ channels (different carriers,
    antennas, or targets) reconstruct concurrently on one chip — production
    serving batching with no reference counterpart.

    Returns ``step(iq[B, ...], ema[B, h, w], alpha) -> (ema', frames, sync,
    score)`` (alpha shared; add a per-stream alpha by vmapping it too).

    ``fuse=True`` fuses the frame axis across streams into one resample/sync
    batch (:func:`_make_fused_batched_fn`) at the price of a much heavier
    compile; XLA already batches the vmapped program's einsums across
    streams, so the default stays the vmap.
    """
    if (
        config.carry_phase
        and config.subsample_align
        and config.resampler == "mxu3"
    ):
        if config.phase_bins <= 0:
            raise ValueError(
                "batched carry-phase fidelity needs phase_bins>0 (per-stream "
                "quantised bin tables) or resampler='gather' (traced offsets)"
            )
        return _make_batched_quantised_fidelity_fn(
            config, int(np.floor(config.samples_per_frame)))
    fusable = (
        not config.carry_phase
        and not config.subsample_align
        and config.frame_loop == "vmap"
        and config.resampler in ("gather", "rows", "mxu", "mxu2", "mxu3", "mxu4")
    )
    if fuse is None:
        fuse = False
    if fuse:
        if not fusable:
            raise ValueError(
                "fuse=True needs static cuts and a per-frame resampler "
                "(no carry_phase/subsample_align, frame_loop='vmap')"
            )
        return _make_fused_batched_fn(config)
    inner = make_reconstruct_fn(config)
    if config.carry_phase:
        return jax.jit(jax.vmap(inner, in_axes=(0, 0, None, 0)))
    return jax.jit(jax.vmap(inner, in_axes=(0, 0, None)))


def reconstruct_frames(
    iq: np.ndarray | jnp.ndarray,
    config: ReconstructionConfig,
    alpha: float = 0.1,
    ema: np.ndarray | None = None,
) -> Reconstruction:
    """Run stage 2 over one IQ block.

    Host complex64 input is reinterpreted as interleaved float32 (zero-copy
    view) and run through the interleaved kernel, keeping the host→device
    boundary real (see ``estimate_timing``)."""
    if config.input_format == "iq_planar" and (
        getattr(iq, "ndim", 1) == 1
    ):
        # Host-side de-interleave of complex or interleaved-word input.
        iq = to_planar_iq(np.asarray(iq))
    if config.input_format == "complex64" and not (
        isinstance(iq, np.ndarray) and np.iscomplexobj(iq)
        or jnp.iscomplexobj(iq)
    ):
        # Real input under a complex config is interleaved I/Q words (the
        # convention estimate_timing documents) — silently demodulating the
        # word stream as complex samples would corrupt the image.
        config = dataclasses.replace(config, input_format="iq_interleaved")
    if (
        config.input_format == "complex64"
        and isinstance(iq, np.ndarray)
        and np.iscomplexobj(iq)
    ):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        config = dataclasses.replace(config, input_format="iq_interleaved")
    step = make_reconstruct_fn(config)
    h, w = config.render_size
    if ema is None:
        ema0 = jnp.zeros((h, w), jnp.float32)
    else:
        ema0 = jnp.asarray(ema, jnp.float32)
    n = config.block_samples
    if config.input_format == "iq_interleaved":
        n *= 2  # raw I/Q words, two per complex sample
    iq = jnp.asarray(iq)
    if config.input_format == "iq_planar":
        if iq.shape[-1] < n:
            raise ValueError(
                f"need {n} samples for {config.n_frames} frames, got {iq.shape[-1]}"
            )
        block = iq[:, :n]
    else:
        if iq.shape[0] < n:
            raise ValueError(
                f"need {n} samples for {config.n_frames} frames, got {iq.shape[0]}"
            )
        block = iq[:n]
    ema_out, frames, sync, score = step(block, ema0, jnp.float32(alpha))
    return Reconstruction(
        image=np.asarray(ema_out),
        frames=np.asarray(frames),
        sync=np.asarray(sync),
        score=np.asarray(score),
    )


# Alias: auto_reconstruct's `pick_line_peak` *parameter* shadows the function.
_pick_line_peak_fn = pick_line_peak


def auto_reconstruct(
    iq: np.ndarray,
    fs: float,
    n_frames: int | None = None,
    alpha: float | str = 0.1,
    invert: bool = False,
    corr_seconds: float = 0.1,
    refine_with_search: bool = False,
    search_tol_hz: float = 1.0,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    # Sub-pixel registration is the default: it leads integer-roll sync on
    # PSNR (+0.4-0.5 dB on synthetic captures).
    align_subpixel: bool = True,
    pick_line_peak: int | None = None,
    # Wiener-invert the chain's KNOWN resampling/registration MTF on the
    # final average (ops.enhance) — measured +0.45 dB on the judged
    # 1080p60/20 Msps point, +1.1-2.2 dB on deep/oversampled averages,
    # neutral at 10 dB SNR.  The raw EMA stays in Reconstruction.image_raw.
    restore: bool = True,
    restore_nsr: float = 0.002,
    demod: str = "am",
) -> tuple[TimingEstimate, Reconstruction]:
    """Fully automatic capture → image: the end-to-end equivalent of the
    reference's offline script (``production/investigate_data.jl``), with the
    interactive steps (refresh pick, line-count click) automated.

    ``demod="fm"`` drives the whole auto chain off the FM discriminator
    (the reference GUI's demodulation selector includes ``fmDemod`` on its
    main path, ``Demodulation.jl:17-23``): timing estimation, the optional
    mode search, and the reconstruction all run on/for the discriminator
    output instead of the AM envelope — a constant-amplitude FM capture has
    a FLAT envelope, so the AM statistic cannot even find its refresh.

    ``refine_with_search=True`` additionally scores every video mode within
    ``search_tol_hz`` of the measured refresh by sync contrast (sharded across
    all visible devices) and keeps the winner — a safety net when the
    line-count estimate is ambiguous at low SNR.

    ``pick_line_peak=N`` adopts ranked line-period peak N from the
    correlation evidence instead of the automatic lock — the reference's
    interactive click on the other peak (``GUI.jl:512-523``), for when an
    interferer or pathological content fools the comb."""
    iq = np.asarray(iq)
    # Real input is interleaved I/Q words (the convention estimate_timing /
    # reconstruct_frames document): two words per complex sample.
    interleaved = not np.iscomplexobj(iq)
    n_complex = len(iq) // 2 if interleaved else len(iq)
    env_fm = None
    if demod == "fm":
        # One discriminator pass feeds timing estimation and (below) the
        # mode search; the reconstruction chain re-demodulates internally
        # (ReconstructionConfig.demod="fm"), which is negligible offline.
        from ..ops.demod import fm_demod_from_iq

        words = (iq if interleaved
                 else np.ascontiguousarray(iq, np.complex64).view(np.float32))
        env_fm = np.asarray(fm_demod_from_iq(jnp.asarray(words)), np.float32)
    sig = env_fm if env_fm is not None else iq
    if pick_line_peak is not None:
        timing, ev = timing_evidence(sig, fs, corr_seconds, rate_min,
                                     rate_max, envelope=env_fm is not None)
        timing = _pick_line_peak_fn(timing, ev, pick_line_peak)
    else:
        timing = estimate_timing(sig, fs, corr_seconds, rate_min, rate_max,
                                 envelope=env_fm is not None)
    if alpha == "auto":
        alpha = timing.suggested_alpha
    if refine_with_search:
        from ..parallel.sharded import mode_search_static
        from ..video.modes import candidate_modes

        cands = candidate_modes(timing.refresh_hz, tol_hz=search_tol_hz)
        if len(cands) > 1:
            if env_fm is not None:
                env = env_fm
            elif interleaved:
                # Demodulate the word stream before the search — a raw real
                # array would be scored as an already-demodulated envelope.
                w = np.ascontiguousarray(iq, np.float32)
                env = np.hypot(w[0::2], w[1::2])
            else:
                env = np.abs(iq).astype(np.float32)
            # Static-table search: same two-axis frame_sync scoring as
            # sharded_mode_search, but batched einsums over stacked
            # per-candidate tables instead of dynamic-geometry gathers.
            res = mode_search_static(env, fs, timing.refresh_hz, cands)
            best = res.best_mode
            timing = TimingEstimate(
                refresh_hz=timing.refresh_hz,
                line_count=timing.line_count,
                mode_name=res.names[res.best_index],
                mode=VideoMode(best.width, best.height, timing.refresh_hz),
                snr_db=timing.snr_db,
            )
    spf = fs / timing.mode.refresh
    if n_frames is None:
        n_frames = max(int((n_complex - 1) / spf), 1)
    # Interpolation-order auto rule (measured PSNR on synthetic captures):
    # Catmull-Rom wins only when the envelope is NOT undersampled relative
    # to the raster (≥ 1 sample per raster pixel, e.g. 32 MHz captures);
    # below that it preserves alias energy that linear's stronger roll-off
    # suppresses (the judged 20 Msps 1080p60 point is 0.13 — linear).
    taps = 4 if spf / timing.mode.pixels_per_frame >= 1.0 else 2
    config = ReconstructionConfig(
        sample_rate=fs, mode=timing.mode, n_frames=n_frames, invert=invert,
        align_subpixel=align_subpixel, interp_taps=taps, demod=demod,
    )
    recon = reconstruct_frames(iq, config, alpha=alpha)
    if restore:
        from ..ops.enhance import restore_image

        recon.image_raw = recon.image
        recon.image = restore_image(recon.image, config, nsr=restore_nsr)
    return timing, recon


def combined_reconstruct(
    iq: np.ndarray,
    fs: float,
    centers_hz: np.ndarray | list[float] | None = None,
    chan_bw: float = 4e6,
    n_frames: int | None = None,
    alpha: float | str = 0.1,
    invert: bool = False,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    restore: bool = True,
    restore_nsr: float = 0.002,
    min_margin_db: float = 5.0,
    mode: VideoMode | None = None,
    demod: str = "am",
    excise_db: float | None = None,
):
    """Multi-harmonic capture → image: find (or take) the screen's carriers
    in ONE wideband capture, fuse their envelopes at maximal ratio
    (``ops.combine``), and reconstruct from the combined envelope.

    ``centers_hz=None`` auto-discovers the carriers: a band scan
    (``ops.scan.scan_band``) groups detected channels into emissions, and
    every emission whose refresh estimate matches the strongest one's
    (±0.25 Hz — same screen, different harmonic) contributes its best
    channel.  Returns ``(timing, reconstruction, combine_result)``.

    Beyond the reference: its operator tunes to one carrier at a time
    (``GUI.jl:594-605``); combining K equal-strength harmonics buys up to
    ``10·log10(K)`` dB of envelope SNR before the sync stages (measured
    gains in tests/test_combine.py).

    ``demod="fm"`` runs the per-channel FM discriminator instead of the
    amplitude envelope — both the discovery sweep and the fusion — for
    targets that leak the video in carrier frequency (the reference's
    ``fmDemod``, ``Demodulation.jl:17-23``, is single-carrier only).

    ``excise_db`` (e.g. ``0.0``): null in-channel CW interference louder
    than each channel's carrier peak by this margin before demodulation —
    RECOVERS a hit channel (measured: weight 0.018 → 0.258 vs clean 0.279,
    fused PSNR back to the clean 13.5) where the robust MRC alone can only
    refuse to weight it (13.2).  See ``ops.scan._excise_spikes`` for why
    the carrier-relative criterion cannot touch the emission's own comb."""
    from ..ops.combine import combine_harmonics

    iq = np.asarray(iq)
    if np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    if centers_hz is None:
        screens = discover_screens(iq, fs, chan_bw, corr_seconds,
                                   rate_min, rate_max, min_margin_db,
                                   demod=demod)
        if not screens:
            raise ValueError(
                "no emissions detected in the band; pass centers_hz "
                "explicitly or lower min_margin_db")
        centers_hz = [e["best_channel_hz"] for e in screens[0]]
    comb = combine_harmonics(iq, fs, centers_hz, chan_bw, corr_seconds,
                             rate_min, rate_max, weighting, demod=demod,
                             excise_db=excise_db)
    return _reconstruct_from_combine(comb, n_frames, alpha, invert,
                                     corr_seconds, rate_min, rate_max,
                                     restore, restore_nsr, mode)


def _reconstruct_from_combine(comb, n_frames, alpha, invert, corr_seconds,
                              rate_min, rate_max, restore, restore_nsr,
                              mode=None):
    """Shared tail of combined_reconstruct / reconstruct_all_emissions:
    combined envelope → timing → reconstruction (+ optional restoration).
    ``mode`` overrides the detected video mode (the manual-mode path of the
    plain chain, for captures too degraded to auto-detect)."""
    timing = estimate_timing(comb.envelope, comb.fs_channel, corr_seconds,
                             rate_min, rate_max, envelope=True)
    if mode is not None:
        from ..video.modes import find_configuration

        name = (find_configuration(mode)
                or f"{mode.width}x{mode.height} @ {mode.refresh:g}Hz")
        timing = dataclasses.replace(timing, mode=mode, mode_name=name)
    if alpha == "auto":
        alpha = timing.suggested_alpha
    spf = comb.fs_channel / timing.mode.refresh
    if n_frames is None:
        n_frames = max(int((len(comb.envelope) - 1) / spf), 1)
    taps = 4 if spf / timing.mode.pixels_per_frame >= 1.0 else 2
    config = ReconstructionConfig(
        sample_rate=comb.fs_channel, mode=timing.mode, n_frames=n_frames,
        invert=invert, align_subpixel=True, interp_taps=taps,
        input_format="envelope",
    )
    recon = reconstruct_frames(comb.envelope, config, alpha=alpha)
    if restore:
        from ..ops.enhance import restore_image

        recon.image_raw = recon.image
        recon.image = restore_image(recon.image, config, nsr=restore_nsr)
    return timing, recon, comb


def discover_screens(
    iq: np.ndarray,
    fs: float,
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    min_margin_db: float = 5.0,
    refresh_group_hz: float = 0.005,
    scan_result=None,
    demod: str = "am",
) -> list[list[dict]]:
    """Scan the band and group detected emissions into distinct SCREENS.

    Harmonics of one screen ride one pixel clock, so their per-channel
    refresh estimates agree exactly (measured 0.0 mHz spread across three
    harmonics of a 6 dB-SNR synthetic); distinct monitors' crystals differ
    by ppm (60 Hz ± a few mHz).  Emissions whose refresh estimates agree
    within ``refresh_group_hz`` (default 5 mHz) are one screen.  Limits:
    two monitors closer in refresh than the scan window's estimator
    resolution merge — pass explicit ``centers_hz`` lists to
    ``combined_reconstruct`` to separate them by hand.

    Returns screens ordered by their strongest emission's comb mass; each
    screen is the list of its ``ScanResult.emissions()`` dicts (strongest
    first).  ``iq``: interleaved float32 I/Q words (complex input must be
    viewed before calling — the public wrappers do this).  Pass
    ``scan_result`` to group an already-run sweep instead of scanning here
    (``iq`` is then unused).
    """
    if scan_result is None:
        from ..ops.scan import scan_band, scan_centers

        centers = scan_centers(fs, step_hz=chan_bw / 2.0,
                               guard_hz=chan_bw / 2.0)
        scan_result = scan_band(iq, fs, centers, chan_bw, corr_seconds,
                                rate_min, rate_max, demod=demod)
    ems = scan_result.emissions(min_margin_db=min_margin_db)
    screens: list[list[dict]] = []
    for e in ems:  # already ordered by comb mass
        for s in screens:
            if abs(e["refresh_hz"] - s[0]["refresh_hz"]) < refresh_group_hz:
                s.append(e)
                break
        else:
            screens.append([e])
    return screens


def reconstruct_all_emissions(
    iq: np.ndarray,
    fs: float,
    chan_bw: float = 4e6,
    n_frames: int | None = None,
    alpha: float | str = 0.1,
    invert: bool = False,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    restore: bool = True,
    restore_nsr: float = 0.002,
    min_margin_db: float = 5.0,
    refresh_group_hz: float = 0.005,
    max_screens: int | None = None,
    demod: str = "am",
    excise_db: float | None = None,
) -> list[tuple]:
    """Reconstruct EVERY screen radiating in one wideband capture.

    Band scan → emissions → screens (``discover_screens``) → one
    multi-harmonic ``combined_reconstruct`` per screen.  Returns a list of
    ``(timing, reconstruction, combine_result)`` ordered by emission
    strength — two monitors in one capture give two images, each fused
    from all of that monitor's harmonics.  The reference operator would
    re-tune and re-lock once per screen by hand (``GUI.jl:594-605``)."""
    iq = np.asarray(iq)
    if np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    screens = discover_screens(iq, fs, chan_bw, corr_seconds, rate_min,
                               rate_max, min_margin_db, refresh_group_hz,
                               demod=demod)
    out = []
    for group in screens[:max_screens]:
        centers_hz = [e["best_channel_hz"] for e in group]
        out.append(combined_reconstruct(
            iq, fs, centers_hz, chan_bw=chan_bw, n_frames=n_frames,
            alpha=alpha, invert=invert, corr_seconds=corr_seconds,
            rate_min=rate_min, rate_max=rate_max, weighting=weighting,
            restore=restore, restore_nsr=restore_nsr, demod=demod,
            excise_db=excise_db))
    return out
