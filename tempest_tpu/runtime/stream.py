"""Streaming runtime: source → ring → jitted reconstruction → frame sink.

The re-design of the reference's live control plane
(``/root/reference/src/GUI.jl:120-234,286-664``).  The reference runs three
cooperating threads (SDR producer, DSP consumer, renderer) stitched together
by global Makie Observables; here the same pipeline is an explicit object:

* a producer thread fills the host ring buffer from any ``SampleSource``
  (the ``start_atomic_sdr`` hot loop, ``AtomicAbstractSDRs.jl:284-306``);
* the consumer loop takes blocks, feeds the jitted stage-2 program, and hands
  reconstructed frames to a sink callback (``coreProcessing``,
  ``GUI.jl:120-205``) — with the carried EMA image as an explicit state
  array, not a global;
* tasks mirror the reference's ``OBS_Task`` state machine: ``correlate()``
  re-estimates the video mode from the live stream (task 1,
  ``extract_configuration`` ``GUI.jl:49-88``), ``record(n)`` dumps raw blocks
  to a GNURadio-compatible ``.dat`` (task 3, ``GUI.jl:182-190``), and frame
  rendering is the steady state (task 2).

Config changes (refresh, line count, alpha) are plain attribute updates that
swap the compiled program on the next block — jit caching makes flipping back
free, replacing ``FLAG_CONFIG_UPDATE`` + mutable globals (``GUI.jl:151-158``).
"""

from __future__ import annotations

import threading
from collections.abc import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..io.dat import write_complex_binary
from ..pipeline.offline import (
    ReconstructionConfig,
    estimate_timing,
    make_reconstruct_fn,
    TimingEstimate,
)
from ..video.modes import VideoMode
from .ring import RingBuffer
from .sources import SampleSource

__all__ = ["StreamingRuntime"]

FrameSink = Callable[[np.ndarray, dict], None]


def frames_per_window(cap: int, spf: float) -> int:
    """Whole frame periods fitting one chain window of ``cap`` samples
    after a frame period of phase headroom + fractional-cut slack (cf. the
    reference's headroom-less ``nbIm`` floor, ``GUI.jl:137``, which
    drifts).  ONE definition shared by the single-chip and mesh runtimes —
    their bit-parity contract depends on the identical derivation."""
    n = max(int((cap - 2 - spf) / spf), 1)
    while n > 1 and int(np.ceil(spf * n)) + 1 + int(np.ceil(spf)) > cap:
        n -= 1
    return n


class StreamingRuntime:
    """Block-streaming executor around one ``SampleSource``."""

    def __init__(
        self,
        source: SampleSource,
        mode: VideoMode,
        n_frames_per_block: int | None = None,
        alpha: float = 0.1,
        ring_depth: int = 16,
        invert: bool = False,
        ring_impl: str = "python",
        fidelity: bool = False,
        fidelity_bins: int = 64,
        config_overrides: dict | None = None,
        combine: list[float] | None = None,
        combine_bw: float = 4e6,
        combine_demod: str = "am",
        combine_excise_db: float | None = None,
    ) -> None:
        """``fidelity=True`` selects the highest-measured-fidelity chain:
        sub-sample-exact frame cuts with the per-frame sync stage skipped
        (see ReconstructionConfig.subsample_align — +0.61 dB over rounded
        cuts, and above the per-frame-sync EMA).  Pair with ``correlate()``
        + ``refine_refresh_from_drift`` so the frame grid is drift-locked.

        ``fidelity_bins`` > 0 (default 64) runs fidelity mode through the
        phase-quantised mxu3 exact-cut tables (one compiled program, full
        matmul speed — ops.resample.StreamingExactPlan); 0 selects the
        traced-offset gather resampler (exact carry phase, ~5× slower).

        ``config_overrides`` passes extra ReconstructionConfig fields through
        to the compiled programs (resampler, num_phases, interp_taps,
        einsum_bf16, demod, …) — the runtime-knob passthrough the reference
        gives ``openAtomicSDR`` kwargs (``AtomicAbstractSDRs.jl:273-280``).
        Fields the runtime owns (carry_phase, input_format, n_frames, mode,
        sample_rate) cannot be overridden."""
        if config_overrides:
            owned = {"carry_phase", "input_format", "n_frames", "mode",
                     "sample_rate", "block_samples"}
            bad = owned & set(config_overrides)
            if bad:
                raise ValueError(f"config_overrides may not set {sorted(bad)}"
                                 " — the streaming runtime owns these")
        self._overrides = dict(config_overrides or {})
        self.source = source
        self.alpha = alpha
        self.invert = invert
        self.fidelity = fidelity
        self.fidelity_bins = fidelity_bins
        self._mode = mode
        self._n_frames_fixed = n_frames_per_block
        # Live multi-harmonic combining (ops.combine): when set, every block
        # is channelised at these carrier offsets and the MRC-fused envelope
        # feeds the reconstruction chain at the channel rate.
        self._combine_centers = list(combine) if combine else None
        self._combine_bw = float(combine_bw)
        # Per-channel demodulator of the combine front: "am" (envelope) or
        # "fm" (discriminator — ops.demod.fm_demod_rows) for targets whose
        # video leaks in carrier frequency.
        self._combine_demod = str(combine_demod)
        # Opt-in spectral excision of in-channel CW interference (margin
        # over the carrier peak, dB — ops.scan._excise_spikes).
        self._combine_excise = combine_excise_db
        self._combine_front = None     # jitted words -> (env, w, pol, mass)
        self.combine_weights = None    # device arrays from the last block
        self._rebuild()
        if ring_impl == "native":
            # GIL-free C++ SPSC ring (tempest_tpu/native); same overwrite-
            # oldest semantics, built on demand with g++.
            from ..native import NativeRing

            self.ring = NativeRing(source.block_size, ring_depth)
        else:
            self.ring = RingBuffer(source.block_size, ring_depth)
        self._producer: threading.Thread | None = None
        self._stop = threading.Event()
        self._producer_error: BaseException | None = None
        self._ema = np.zeros(self.config.render_size, np.float32)
        # Absolute-position base: block seq 0 of THIS session's source sits at
        # this stream offset (nonzero after a checkpoint resume, where the
        # source is assumed to continue the checkpointed signal).
        self._abs_base = 0
        self.frames_out = 0
        self._record_idx = 0           # next auto-rotated capture index
        self.last_record_path: str | None = None
        self.last_evidence = None      # TimingEvidence from correlate()
        self.corr_spark: str | None = None  # HUD sparkline of the evidence
        self.last_correlate_gaps = 0   # ring gaps detected by correlate()

    # ------------------------------------------------------------ config
    def _rebuild(self) -> None:
        # With live combining, the chain runs on the CHANNEL-rate fused
        # envelope: each source block of block_size complex samples is
        # channelised over its first N (power-of-two) samples into M channel
        # samples at fs·M/N.  Frame-phase accounting stays in SOURCE samples
        # (frames tick at multiples of the source-rate frame period from
        # stream start); the per-block phase is scaled by M/N on dispatch,
        # which also absorbs the (block_size − N) source samples the FFT
        # window does not cover — the next block re-anchors exactly.
        if self._combine_centers:
            from ..ops.scan import _channel_geometry

            n_fft, m_chan, fs_chan = _channel_geometry(
                self.source.block_size, self.source.sample_rate,
                self._combine_bw)
            chain_fs, chain_cap = fs_chan, m_chan
            self._phase_scale = m_chan / n_fft
            self._upload_samples = n_fft
            self._combine_geometry = (n_fft, m_chan, fs_chan)
        else:
            chain_fs = self.source.sample_rate
            chain_cap = self.source.block_size
            self._phase_scale = 1.0
            self._upload_samples = None  # set to block_samples below
            self._combine_geometry = None
        # Whole frame periods that fit in one block after a frame period of
        # phase headroom + fractional-cut slack (cf. the reference's nbIm
        # floor, GUI.jl:137 — which has no headroom and drifts).  Re-derived
        # on every mode change: a slower refresh may fit one frame less.
        spf = chain_fs / self._mode.refresh
        if self._n_frames_fixed is None:
            self._n_frames = frames_per_window(chain_cap, spf)
        else:
            self._n_frames = self._n_frames_fixed
        self.config = ReconstructionConfig(
            sample_rate=chain_fs,
            mode=self._mode,
            n_frames=self._n_frames,
            invert=self.invert,
            carry_phase=True,
            input_format=("envelope" if self._combine_centers
                          else "iq_interleaved"),
            resampler=(
                "gather" if self.fidelity and not self.fidelity_bins else "mxu3"
            ),
            subsample_align=self.fidelity,
            do_align=not self.fidelity,
            # Sub-pixel registration (shift-operator matmuls) whenever the
            # sync stage runs: +0.4-0.5 dB over integer rolls — the quality
            # chain is the default.
            align_subpixel=not self.fidelity,
            phase_bins=self.fidelity_bins if self.fidelity else 0,
            # Quantised fidelity defaults to the bf16 weights einsum (half
            # the weight bytes at <= 2^-9 coefficient rounding; `cli warmup`
            # precompiles exactly this program).  Overridable via
            # config_overrides.
            einsum_bf16=bool(self.fidelity and self.fidelity_bins),
        )
        if self._overrides:
            import dataclasses

            self.config = dataclasses.replace(self.config, **self._overrides)
        self._spf = self.source.sample_rate / self._mode.refresh
        self._abs_pos = 0  # absolute SOURCE-sample index of the next block
        if self.config.block_samples > chain_cap:
            raise ValueError(
                f"blocks ({chain_cap} chain samples) are smaller than "
                f"{self._n_frames} frame periods ({self.config.block_samples})"
            )
        if self._upload_samples is None:
            self._upload_samples = self.config.block_samples
        self._step = make_reconstruct_fn(self.config)
        self._combine_front = (
            self._make_combine_front() if self._combine_centers else None
        )

    def _make_combine_front(self):
        """Jitted per-block combine front-end: raw I/Q words → MRC-fused
        envelope (sliced to the chain's block length) + channel diagnostics.
        Kept as its own program so the same fused envelope feeds BOTH step
        families (traced carry-phase and quantised-fidelity tables); the
        envelope never leaves the device between the two dispatches."""
        from ..ops.combine import combine_core

        _, m_chan, fs_chan = self._combine_geometry
        fs = float(self.source.sample_rate)
        bw = float(self._combine_bw)
        centers = tuple(float(c) for c in self._combine_centers)
        # The runtime KNOWS the refresh (its video mode): the comb-mass gate
        # reads the known frame lags directly instead of running a full
        # autocorrelation + period search per channel (combine_core's
        # refresh_hz fast path — the search is pure diagnostics here).
        fv = float(self._mode.refresh)
        block_len = self.config.block_samples

        demod = self._combine_demod
        excise = self._combine_excise
        # Fail fast (constructor / set_combine / resume), not at first-block
        # trace time: excision's carrier-relative criterion is AM-only.
        from ..ops.scan import check_excise_demod

        check_excise_demod(demod, excise)

        @jax.jit
        def front(words):
            env, w, pol, mass, _ = combine_core(
                words, fs, centers, bw, fs_chan, 0.1,
                max(fv - 5.0, 20.0), fv + 5.0, "mrc", refresh_hz=fv,
                demod=demod, excise_db=excise)
            return env[:block_len], w, pol, mass

        return front

    @property
    def mode(self) -> VideoMode:
        return self._mode

    @mode.setter
    def mode(self, new_mode: VideoMode) -> None:
        """Hot-swap the video configuration (``FLAG_CONFIG_UPDATE`` path,
        ``GUI.jl:151-158``) — compiles on first use, cached afterwards."""
        self._mode = new_mode
        self._rebuild()

    # ------------------------------------------------- operator overrides
    # The reference exposes these as GUI widgets: fv/y_t textboxes
    # (GUI.jl:463-523), ±1-line buttons (GUI.jl:529-543), and an automatic
    # video-mode re-match on any change (GUI.jl:568-580).  Here they are
    # plain methods on the runtime — scriptable, and usable from the stream
    # CLI or a notebook while the stream runs.

    def set_refresh(self, fv: float) -> None:
        """Override the refresh rate [Hz], keeping the pixel geometry (the
        fv textbox, ``GUI.jl:463-484``)."""
        m = self._mode
        self.mode = VideoMode(m.width, m.height, float(fv))

    def set_line_count(self, y_t: int) -> None:
        """Override the total line count, keeping width and refresh (the
        y_t textbox, ``GUI.jl:487-523``)."""
        m = self._mode
        self.mode = VideoMode(m.width, int(y_t), m.refresh)

    def nudge_lines(self, delta: int = 1) -> int:
        """±N-line nudge (the reference's +1/−1 buttons, ``GUI.jl:529-543``)
        — the standard manual fix when the image shears.  Returns the new
        line count."""
        self.set_line_count(self._mode.height + delta)
        return self._mode.height

    def snap_to_mode(self) -> str:
        """Re-match the current (line count, refresh) against the video-mode
        table and adopt the winner's pixel geometry, keeping the measured
        refresh (``find_closest_configuration`` on any change,
        ``GUI.jl:568-580``).  Returns the matched mode name."""
        from ..video.modes import find_closest_mode

        m = self._mode
        name, best = find_closest_mode(m.height, m.refresh)
        self.mode = VideoMode(best.width, best.height, m.refresh)
        return name

    def pick_line_peak(self, n: int) -> str:
        """Adopt ranked line-period peak ``n`` from the last correlation
        evidence (``correlate(keep_evidence=True)``) — the reference's
        click-the-other-peak recovery (``GUI.jl:512-523``) as a runtime
        command.  Returns the matched mode name."""
        if self.last_evidence is None:
            raise RuntimeError(
                "no correlation evidence — run correlate(keep_evidence=True) first"
            )
        from ..pipeline.offline import TimingEstimate, pick_line_peak

        m = self._mode
        timing = TimingEstimate(m.refresh, m.height, "", m)
        picked = pick_line_peak(timing, self.last_evidence, n)
        self.mode = picked.mode
        return picked.mode_name

    def set_fidelity(self, on: bool) -> None:
        """Hot-swap between the throughput chain (mxu resampler + per-frame
        sync) and the fidelity chain (sub-sample-exact cuts, sync skipped).
        Typical flow: warm up with sync on, ``refine_refresh_from_drift``,
        then switch fidelity on with the frame grid drift-locked."""
        self.fidelity = on
        self._rebuild()

    def set_combine(self, centers_hz: list[float] | None,
                    chan_bw: float | None = None,
                    demod: str | None = None,
                    excise_db: float | None | str = "keep") -> None:
        """Turn live multi-harmonic combining on (carrier offsets in Hz,
        relative to the source's tuned center) or off (``None``) mid-stream.
        Every block is then channelised at these carriers and the MRC-fused
        envelope (``ops.combine``) feeds the reconstruction chain at the
        channel rate — the per-channel weights/polarity/comb-mass of the
        last block are kept on ``self.combine_weights``.  The reference
        operator can only tune to one carrier at a time
        (``GUI.jl:594-605``).  ``demod`` switches the front's per-channel
        demodulator ("am"/"fm") — ``None`` keeps the current setting.
        ``excise_db`` sets the CW-excision margin (a float), turns it off
        (``None``); the default string ``"keep"`` leaves it unchanged."""
        self._combine_centers = list(centers_hz) if centers_hz else None
        if chan_bw is not None:
            self._combine_bw = float(chan_bw)
        if demod is not None:
            self._combine_demod = str(demod)
        if excise_db != "keep":
            self._combine_excise = excise_db
        self.combine_weights = None
        self._rebuild()

    def combine_auto(self, seconds: float = 0.4,
                     min_margin_db: float = 5.0,
                     refresh_tol_hz: float = 0.5) -> list[float]:
        """Discover the strongest screen's carriers from the live stream and
        switch combining onto them: gather a contiguous window from the
        ring (sequence-fenced), run the band scan + same-refresh emission
        grouping (``pipeline.offline.discover_screens``), and
        ``set_combine`` the winning screen's channel centers.  Returns the
        centers chosen (empty list = nothing detected, combining off).

        The discovered screen's measured refresh RE-ANCHORS the runtime
        mode first: the combine front bakes its comb lags and ±5 Hz gate
        band from ``self.mode.refresh``, so a mode the operator never
        ``correlate()``d (or a stale one) would silently score the wrong
        lags and degrade every weight.  When the discovery disagrees by
        more than ``refresh_tol_hz`` the emission's refresh is adopted
        (same estimator grid as ``correlate()``'s timing path); within the
        tolerance the current — possibly mHz-refined — lock is kept."""
        from ..pipeline.offline import discover_screens

        sig = self._gather_window(seconds)
        screens = discover_screens(
            np.ascontiguousarray(sig, np.complex64).view(np.float32),
            self.source.sample_rate, self._combine_bw,
            min_margin_db=min_margin_db)
        centers = ([e["best_channel_hz"] for e in screens[0]]
                   if screens else [])
        if centers:
            fv_disc = float(screens[0][0]["refresh_hz"])
            if abs(fv_disc - self._mode.refresh) > refresh_tol_hz:
                self._mode = VideoMode(self._mode.width, self._mode.height,
                                       fv_disc)
        self.set_combine(centers or None)
        return centers

    # -------------------------------------------------------- live retuning
    def set_carrier(self, freq: float) -> None:
        """Retune the source's carrier frequency mid-stream (the reference's
        carrier textbox callback, ``GUI.jl:609-633``).  Raises for sources
        without a tuner (replay/synthetic)."""
        retune = getattr(self.source, "set_carrier", None)
        if retune is None:
            raise AttributeError(
                f"{type(self.source).__name__} does not support carrier retuning"
            )
        retune(freq)

    def set_gain(self, gain: float) -> None:
        """Update the source's RX gain mid-stream (``updateGain!`` slider,
        ``GUI.jl:651-658``)."""
        setg = getattr(self.source, "set_gain", None)
        if setg is None:
            raise AttributeError(
                f"{type(self.source).__name__} does not support gain control"
            )
        setg(gain)

    def set_sample_rate(self, rate: float) -> None:
        """Update the source sample rate and rebuild the compiled programs
        whose static shapes derive from it (``updateSamplingRate!``,
        ``GUI.jl:636-648``)."""
        setr = getattr(self.source, "set_sample_rate", None)
        if setr is None:
            raise AttributeError(
                f"{type(self.source).__name__} does not support rate changes"
            )
        setr(rate)
        self._rebuild()

    # ---------------------------------------------------------- producer
    def start(self) -> None:
        """Spawn the producer thread (``Threads.@spawn start_atomic_sdr``,
        ``GUI.jl:380``)."""
        if self._producer is not None:
            return
        self._stop.clear()

        def _produce() -> None:
            block = np.empty(self.source.block_size, np.complex64)
            try:
                while not self._stop.is_set():
                    self.source.read(block)
                    self.ring.put(block)
            except BaseException as exc:  # surfaced to the consumer, not lost
                # (the reference swallows producer errors, GUI.jl:197-200)
                self._producer_error = exc
                self.ring.close()

        self._producer = threading.Thread(target=_produce, daemon=True, name="sdr-producer")
        self._producer.start()

    def stop(self) -> None:
        """Cooperative shutdown (``stop_runtime``, ``GUI.jl:714-733``)."""
        self._stop.set()
        self.ring.close()
        if self._producer is not None:
            self._producer.join(timeout=5.0)
            self._producer = None
        self.source.close()

    # ---------------------------------------------------------- consumer
    def _resync_abs_pos(self) -> None:
        """Re-anchor the absolute sample position to the block just taken.

        The ring is overwrite-oldest (real-time: never block the radio), so
        when the consumer falls behind, blocks are silently dropped.  Blind
        ``pos += block_size`` accounting then shears the carried frame phase
        by ``block_size % spf`` per dropped block — the image jumps a few
        hundred lines and the EMA smears.  The rings stamp every block with
        its production sequence; anchoring to ``seq * block_size`` keeps the
        frame grid locked to the *signal*, not to the consume count.  (The
        reference has exactly this bug class: its cuts are buffer-aligned and
        its ring drops silently, ``GUI.jl:165-166``.)"""
        seq = getattr(self.ring, "last_seq", -1)
        if seq >= 0:
            self._abs_pos = self._abs_base + seq * self.source.block_size

    def process_blocks(
        self,
        n_blocks: int,
        sink: FrameSink | None = None,
        emit_every_frame: bool = False,
    ) -> np.ndarray:
        """Consume ``n_blocks`` from the ring through the jitted chain.

        ``sink(image, info)`` is called once per block with the EMA image (or
        per frame with ``emit_every_frame``) — the reference's frame channel +
        renderer (``GUI.jl:177,207-234``) collapsed into a callback.  Returns
        the final EMA image.
        """
        # A FRESH host buffer per block: JAX may alias (zero-copy) an
        # aligned numpy input on some backends, and mutating a buffer after
        # handing it to a dispatched program is undefined — the previous
        # two-buffer rotation corrupted block k's in-flight input when
        # block k+2's ring.take overwrote it, whenever no sink forced
        # per-block completion (REAL bug, caught by the mesh-runtime parity
        # test: no-sink EMA deviated 0.07 from the sink-fenced fold on the
        # CPU backend).  Allocation is microseconds against a multi-MB DSP
        # block; correctness must not depend on transfer semantics.
        ema = jnp.asarray(self._ema)
        for i in range(n_blocks):
            buf = np.empty(self.source.block_size, np.complex64)
            got = self.ring.take(buf)
            if got is None:
                if self._producer_error is not None:
                    raise RuntimeError("sample source failed") from self._producer_error
                break
            self._resync_abs_pos()
            # Fractional offset of the next absolute frame boundary (frames
            # tick at multiples of spf from stream start) inside this block.
            phase = (-self._abs_pos) % self._spf
            # Interleaved float32 view keeps the host->device boundary real.
            iq = jnp.asarray(
                buf[: self._upload_samples].view(np.float32)
            )
            # phase stays a host float: the quantised fidelity step selects
            # its bin tables host-side; the traced paths accept it as a weak
            # f32 scalar.
            if self._combine_front is not None:
                # Channelise + MRC-fuse on device; the envelope feeds the
                # chain at the channel rate without a host round trip.
                env, w, pol, mass = self._combine_front(iq)
                self.combine_weights = (w, pol, mass)  # lazy device arrays
                ema, frames, sync, score = self._step(
                    env, ema, jnp.float32(self.alpha),
                    phase * self._phase_scale
                )
            else:
                ema, frames, sync, score = self._step(
                    iq, ema, jnp.float32(self.alpha), phase
                )
            self._abs_pos += self.source.block_size
            self.frames_out += frames.shape[0]
            if sink is not None:
                info = {
                    "sync": np.asarray(sync),
                    "score": np.asarray(score),
                    "mode": self._mode,
                    "frames_out": self.frames_out,
                }
                if self.corr_spark:
                    info["spark"] = self.corr_spark
                if emit_every_frame:
                    for f in np.asarray(frames):
                        sink(f, info)
                else:
                    sink(np.asarray(ema), info)
        self._ema = np.asarray(ema)
        return self._ema

    # ------------------------------------------------------------- tasks
    def _gather_window(self, seconds: float) -> np.ndarray:
        """Take ~``seconds`` of CONTIGUOUS signal from the ring (complex64).

        Sequence-fenced against ring-overflow gaps (the scan() dwell bug
        class: a dropped block inside a concatenated window puts a
        frame-phase discontinuity in it — measured ~10 dB comb dilution).
        A gap restarts the run; bounded retakes get a fully contiguous
        window in all but pathological cases, else the longest contiguous
        run is used.  Gap count lands on ``self.last_correlate_gaps``."""
        n_needed = int(np.ceil(seconds * self.source.sample_rate))
        n_blocks = max(1 + n_needed // self.source.block_size, 1)
        chunks: list[np.ndarray] = []
        best_run: list[np.ndarray] = []
        buf = np.empty(self.source.block_size, np.complex64)
        prev_seq = None
        gaps = 0
        max_takes = max(4 * n_blocks, n_blocks + 8)
        for _ in range(max_takes):
            got = self.ring.take(buf)
            if got is None:
                raise RuntimeError("ring closed while gathering a window")
            self._resync_abs_pos()
            seq = getattr(self.ring, "last_seq", -1)
            self._abs_pos += self.source.block_size  # keep the frame grid honest
            if prev_seq is not None and seq >= 0 and seq != prev_seq + 1:
                gaps += 1
                if len(chunks) > len(best_run):
                    best_run = chunks
                chunks = []
            prev_seq = seq if seq >= 0 else (
                prev_seq + 1 if prev_seq is not None else None
            )
            chunks.append(buf.copy())
            if len(chunks) >= n_blocks:
                break
        if len(best_run) > len(chunks):
            chunks = best_run
        self.last_correlate_gaps = gaps
        return np.concatenate(chunks)

    def correlate(
        self,
        seconds: float = 0.1,
        rate_min: float = 50.0,
        rate_max: float = 90.0,
        keep_evidence: bool = False,
    ) -> TimingEstimate:
        """Task 1: re-estimate timing from the live stream and hot-swap the
        detected mode (``extract_configuration`` + auto mode match,
        ``GUI.jl:411-419,568-580``).

        ``rate_min``/``rate_max`` bound the refresh search band [Hz] — widen
        them to detect e.g. PAL TV (25 Hz) or 120 Hz panels live, exactly as
        the offline path allows.  With ``keep_evidence`` the correlation
        windows behind the estimate are retained on ``self.last_evidence``
        and a refresh-band sparkline is shown in the stream HUD — the live
        correlation panels of the reference GUI (``GUI.jl:296-356``).

        The correlation window must be CONTIGUOUS signal: under ring overflow
        (producer outrunning this estimator) successive takes skip dropped
        blocks, and concatenating across a gap puts a frame-phase
        discontinuity inside the window — measured to dilute the refresh comb
        ~10 dB and corrupt the estimate (the scan() dwell bug class).  Takes
        are therefore sequence-fenced: a gap restarts the run, bounded
        retakes get a fully contiguous window in all but pathological cases,
        and otherwise the longest contiguous run is used (a shorter clean
        window beats a longer torn one).  Gap count is kept on
        ``self.last_correlate_gaps``."""
        sig = self._gather_window(seconds)
        # A shortened (but contiguous) window still estimates correctly —
        # scale the correlation seconds to the signal actually gathered.
        seconds = min(seconds, len(sig) / self.source.sample_rate)
        if keep_evidence:
            from ..pipeline.offline import timing_evidence
            from ..render.plots import sparkline

            timing, ev = timing_evidence(
                sig, self.source.sample_rate, seconds, rate_min, rate_max
            )
            self.last_evidence = ev
            self.corr_spark = (
                f"corr[{rate_min:.0f}-{rate_max:.0f}Hz] "
                f"{sparkline(ev.gamma_rates, mark=ev.rate_mark())} "
                f"peak {ev.refresh_hz:.2f} Hz"
            )
        else:
            timing = estimate_timing(
                sig, self.source.sample_rate, seconds, rate_min, rate_max
            )
        self.mode = timing.mode
        return timing

    def scan(
        self,
        freqs_hz,
        dwell_seconds: float = 0.1,
        settle_blocks: int = 1,
        retune_to_best: bool = True,
        rate_min: float = 50.0,
        rate_max: float = 90.0,
    ) -> list[tuple[float, float, float, float]]:
        """Retune across candidate carriers and score each dwell's
        screen-ness — the automated version of the reference operator's
        hunt-by-eye over the waterfall (its carrier is a hand-filled textbox,
        ``GUI.jl:594-605``; no scan exists).  Requires a retunable source
        (``set_carrier``).

        Per dwell: retune, drop blocks until the delivered one was produced
        ``settle_blocks`` after the retune (sequence-fenced: the ring may
        hold a full depth of pre-retune blocks), then score ~``dwell_
        seconds`` of signal block-by-block with the scale-free refresh-comb
        prominence (gain-independent — AGC may differ per dwell; see
        ``ops.scan.carrier_score``), keeping the best block.

        Detection is CALIBRATED like the offline sweep: the measured noise
        selection floor of the dwell's own window geometry (white-noise
        surrogates through the identical estimator at the per-block length,
        ``ops.scan._noise_floor``) is computed once per scan, so a dwell's
        margin-over-floor is comparable with an offline ``scan_band`` of
        the same geometry rather than an uncalibrated raw prominence.

        Returns ``[(freq, prominence_db, floor_db, refresh_hz), ...]`` in
        input order and, by default, leaves the source tuned to the best
        candidate.  For a single wideband CAPTURE use
        :func:`tempest_tpu.ops.scan.scan_band` instead — it scores every
        channel in one batched program."""
        from ..ops.scan import _noise_floor, carrier_score

        retune = getattr(self.source, "set_carrier", None)
        if retune is None:
            raise RuntimeError(
                f"{type(self.source).__name__} does not support carrier "
                "retuning — scan a wideband capture with ops.scan.scan_band"
            )
        fs = self.source.sample_rate
        # Coverage precondition: blocks are scored individually, and the
        # autocorrelation's usable lag range is HALF its power-of-two FFT
        # window (lags past n/2 are circular mirrors) — worst case
        # block_seconds/4.  If the frame period 1/rate_min does not fit,
        # every dwell on a real emission scores at the noise floor and the
        # "best" carrier is arbitrary; refuse instead.
        n_fft = 1 << (max(int(self.source.block_size), 2).bit_length() - 1)
        usable_lag_s = (n_fft // 2) / fs
        if usable_lag_s < 1.0 / rate_min:
            raise ValueError(
                f"block too short to score the {rate_min:.0f}-{rate_max:.0f}"
                f" Hz band: usable correlation lag {usable_lag_s*1e3:.1f} ms"
                f" < one frame period {1e3/rate_min:.1f} ms — use"
                f" block_seconds >= {4.0/rate_min:.2f} s"
            )
        n_blocks = max(int(np.ceil(dwell_seconds * fs))
                       // self.source.block_size + 1, 1)
        buf = np.empty(self.source.block_size, np.complex64)
        # ONE floor per scan: the dwell scores whole blocks, so the null
        # geometry is (block_size envelope, per-block correlation window) —
        # identical for every candidate carrier.
        corr_s = min(dwell_seconds, 0.5 * self.source.block_size / fs)
        floor = float(_noise_floor(fs, self.source.block_size, corr_s,
                                   rate_min, rate_max))
        results: list[tuple[float, float, float, float]] = []
        def _take():
            if self.ring.take(buf) is None:
                raise RuntimeError("ring closed during scan()")
            self._resync_abs_pos()
            self._abs_pos += self.source.block_size  # keep the frame grid honest

        for freq in freqs_hz:
            retune(float(freq))
            # Fence against stale data: the overwrite-oldest ring may hold up
            # to `depth` blocks captured BEFORE the retune (plus one the
            # producer was mid-read on).  Sequence stamps make the fence
            # exact — drop until the delivered block was produced at least
            # `settle_blocks` after the retune (counting a fixed number of
            # takes instead mixes old-carrier samples into the dwell and
            # dilutes the score).
            produced = getattr(self.ring, "produced", None)
            if produced is not None:
                target = produced + settle_blocks
                while True:
                    _take()
                    if self.ring.last_seq >= target:
                        break
            else:
                for _ in range(settle_blocks):
                    _take()
            # Score each block INDEPENDENTLY and keep the best: under
            # overflow (producer faster than this consumer) successive takes
            # are not contiguous in the signal, and concatenating across a
            # gap puts a frame-phase discontinuity inside the correlation
            # window — measured to dilute the comb score ~10 dB and corrupt
            # the refresh read.  Per-block coverage of the refresh band is
            # guaranteed by the usable-lag check above.
            best_sf = (-np.inf, float("nan"))
            for _ in range(n_blocks):
                _take()
                sc, fv = carrier_score(buf, fs, corr_s, rate_min, rate_max)
                if sc > best_sf[0]:
                    best_sf = (sc, fv)
            results.append((float(freq), best_sf[0], floor, best_sf[1]))
        if retune_to_best and results:
            best = max(results, key=lambda r: r[1])
            retune(best[0])
        return results

    def record(
        self,
        path: str | None = None,
        n_blocks: int = 10,
        fmt: str = "single",
        prefix: str = "dumpIQ",
    ) -> int:
        """Task 3: dump raw IQ blocks to a GNURadio-compatible capture
        (``GUI.jl:182-190``). Returns samples written.

        With ``path=None`` successive calls auto-rotate output files exactly
        like the reference's task 3 (``dumpIQ_0.dat``, ``dumpIQ_1.dat``, …,
        ``GUI.jl:182-190``): the first index whose file does not yet exist is
        used.  The chosen path is exposed as ``self.last_record_path``.
        """
        if path is None:
            import os

            k = self._record_idx
            while os.path.exists(f"{prefix}_{k}.dat"):
                k += 1
            path = f"{prefix}_{k}.dat"
            self._record_idx = k + 1
        self.last_record_path = path
        buf = np.empty(self.source.block_size, np.complex64)
        out = np.empty(n_blocks * self.source.block_size, np.complex64)
        n = 0
        for i in range(n_blocks):
            got = self.ring.take(buf)
            if got is None:
                break
            out[i * self.source.block_size : (i + 1) * self.source.block_size] = buf
            n += self.source.block_size
            self._resync_abs_pos()
            self._abs_pos += self.source.block_size  # keep the frame grid honest
        write_complex_binary(out[:n], path, fmt)
        return n

    # ----------------------------------------------------- drift feedback
    @staticmethod
    def _median_circular_step(values: np.ndarray, n: int) -> float:
        """Median per-frame step of a circular quantity (sync offsets)."""
        if len(values) < 2:
            return 0.0
        d = np.diff(values.astype(np.float64))
        d = (d + n / 2) % n - n / 2  # wrap to [-n/2, n/2)
        return float(np.median(d))

    def refine_refresh_from_drift(self, sync_history: np.ndarray) -> float:
        """Closed-loop refresh refinement: a residual error in the assumed
        frame period makes the detected blanking position drift linearly
        across frames; converting that drift (render px/frame on each axis)
        back to samples/frame gives the period correction directly.

        ``sync_history``: (n_frames, 2) recent per-frame (s_y, s_x).  Returns
        the refined refresh [Hz] and hot-swaps the runtime's mode to it.  The
        reference has no such loop — the user retypes fv until the image
        stops rolling (``GUI.jl:463-484``).
        """
        h, w = self.config.render_size
        x_t, y_t = self._mode.width, self._mode.height
        dy = self._median_circular_step(sync_history[:, 0], h)
        dx = self._median_circular_step(sync_history[:, 1], w)
        spf = self._spf
        samples_per_raster_px = spf / (x_t * y_t)
        # A period error drifts the blank along the RASTER: the x position
        # is the fine odometer (raster px/frame, ambiguous modulo x_t) and
        # the y position the coarse one (lines/frame ≈ the SAME drift / x_t)
        # — they are redundant, NOT additive.  Use dx for precision and dy
        # only to resolve dx's whole-line wraps.  (Summing them double-
        # counted the drift: with sub-pixel sync — where dy's median step
        # is no longer quantised to zero — the feedback overshot the true
        # refresh by exactly the initial error, caught by
        # test_refresh_drift_feedback_locks when sub-pixel became the
        # default sync stage.)
        dx_px = dx * (x_t / w)             # fine: raster px/frame, mod x_t
        coarse_px = dy * (y_t / h) * x_t   # coarse: from the line odometer
        wraps = np.round((coarse_px - dx_px) / x_t)
        drift_samples = (dx_px + wraps * x_t) * samples_per_raster_px
        new_spf = spf + drift_samples
        new_fv = self.source.sample_rate / new_spf
        self.mode = VideoMode(x_t, y_t, float(new_fv))
        return float(new_fv)

    # --------------------------------------------------- failure detection
    def health(self) -> dict:
        """Liveness/health snapshot — the failure-detection surface the
        reference lacks (its loops swallow errors, SURVEY.md §5): producer
        thread state, ring backlog/overflow, source error, throughput."""
        if hasattr(self.ring, "producer"):
            _, prod_msps = self.ring.producer.rates()
            _, cons_msps = self.ring.consumer.rates()
        else:  # native ring: counters only
            prod_msps = cons_msps = float("nan")
        return {
            "producer_alive": self._producer is not None and self._producer.is_alive(),
            "producer_error": repr(self._producer_error) if self._producer_error else None,
            "ring_available": self.ring.available,
            "ring_overflows": self.ring.overflows,
            # Driver-side live conditions (hardware sources count them;
            # reference parity: AtomicAbstractSDRs.jl:263-268,333-341).
            "source_overflows": getattr(self.source, "overflows", 0),
            "source_timeouts": getattr(self.source, "timeouts", 0),
            "producer_msps": round(prod_msps, 2),
            "consumer_msps": round(cons_msps, 2),
            "frames_out": self.frames_out,
            "combine": (
                {
                    "centers_hz": list(self._combine_centers),
                    "chan_bw": self._combine_bw,
                    "demod": self._combine_demod,
                    "excise_db": self._combine_excise,
                    "fs_channel": self._combine_geometry[2],
                    "weights": (
                        np.asarray(self.combine_weights[0]).round(3).tolist()
                        if self.combine_weights is not None else None
                    ),
                }
                if self._combine_centers else None
            ),
            "realtime_factor": round(
                cons_msps * 1e6 / self.source.sample_rate, 3
            ) if self.source.sample_rate else None,
        }

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str) -> None:
        """Persist the streaming state (EMA image, frame phase, config) so a
        later runtime resumes phase-continuous averaging — state persistence
        the reference does not have (its only persistence is raw IQ
        recording, ``GUI.jl:182-190``)."""
        from ..utils.checkpoint import RuntimeState, save_state

        save_state(
            RuntimeState(
                ema=self._ema,
                abs_pos=self._abs_pos,
                mode=self._mode,
                sample_rate=self.source.sample_rate,
                alpha=self.alpha,
                frames_out=self.frames_out,
                combine_centers=self._combine_centers,
                combine_bw=self._combine_bw,
                combine_demod=self._combine_demod,
                combine_excise_db=self._combine_excise,
                fidelity=self.fidelity,
                fidelity_bins=self.fidelity_bins,
                invert=self.invert,
            ),
            path,
        )

    def load_checkpoint(self, path: str) -> None:
        from ..utils.checkpoint import load_state

        state = load_state(path)
        if state.sample_rate != self.source.sample_rate:
            raise ValueError(
                f"checkpoint sample rate {state.sample_rate} != source "
                f"{self.source.sample_rate}"
            )
        self._mode = state.mode
        self.alpha = state.alpha
        self._combine_centers = (list(state.combine_centers)
                                 if state.combine_centers else None)
        self._combine_bw = state.combine_bw
        self._combine_demod = state.combine_demod
        self._combine_excise = state.combine_excise_db
        self.fidelity = state.fidelity
        self.fidelity_bins = state.fidelity_bins
        self.invert = state.invert
        self._rebuild()
        self._ema = state.ema
        self._abs_pos = state.abs_pos
        # The NEXT delivered block continues the checkpointed stream at
        # state.abs_pos: anchor the sequence-based position tracking there
        # (so the first _resync_abs_pos does not clobber the restored frame
        # phase), accounting for any blocks this session already consumed.
        consumed = getattr(self.ring, "last_seq", -1) + 1
        self._abs_base = state.abs_pos - consumed * self.source.block_size
        self.frames_out = state.frames_out

    def summary(self) -> str:
        base = (
            self.ring.summary()
            if hasattr(self.ring, "summary")
            else f"NativeRing: {self.ring.overflows} overflows"
        )
        return base + f" | {self.frames_out} frames reconstructed"
