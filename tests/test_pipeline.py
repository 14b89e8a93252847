"""Integration tests: single-chip end-to-end reconstruction and the sharded
multi-device pipelines on the virtual 8-device CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import pytest
import tempest_tpu as tt
from tempest_tpu.ops.resample import downgrade_image
from tempest_tpu.parallel.mesh import make_mesh
from tempest_tpu.parallel.sharded import sharded_mode_search, sharded_reconstruct_fn
from tempest_tpu.pipeline.offline import (
    ReconstructionConfig,
    auto_reconstruct,
    estimate_timing,
    reconstruct_frames,
)
from tempest_tpu.video.modes import candidate_modes

MODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]  # 800x525 total — small and fast
FS = 4e6


def _capture(n_seconds=0.8, snr_db=20.0, seed=3):
    return tt.generate_iq(MODE, FS, int(FS * n_seconds), snr_db=snr_db, seed=seed)


def _norm(a):
    a = a - a.mean()
    return a / (a.std() + 1e-9)


def _best_corr(truth, img):
    """Correlation after the best circular alignment (reconstruction is
    defined up to a circular shift of the blanking position)."""
    xc = np.fft.ifft2(np.fft.fft2(_norm(truth)) * np.conj(np.fft.fft2(_norm(img)))).real
    sh = np.unravel_index(xc.argmax(), xc.shape)
    return float(
        np.corrcoef(_norm(truth).ravel(), _norm(np.roll(img, sh, axis=(0, 1))).ravel())[
            0, 1
        ]
    )


def test_estimate_timing_exact_mode():
    cap = _capture(0.4)
    timing = estimate_timing(cap.iq, FS)
    assert timing.mode_name == "640x480 @ 60Hz"
    assert abs(timing.refresh_hz - 60.0) < 0.01
    assert abs(timing.line_count - MODE.height) < 3


def test_auto_reconstruct_fidelity():
    cap = _capture(0.5, snr_db=18.0)
    timing, recon = auto_reconstruct(cap.iq, FS, alpha=0.6)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    corr = _best_corr(truth, recon.image)
    assert corr > 0.85, f"reconstruction corr {corr}"
    # Per-frame sync may *drift* slowly (it tracks the residual refresh-rate
    # error) but must not jump — jumps smear the EMA.
    assert np.abs(np.diff(recon.sync[:, 0])).max() <= 8
    assert np.abs(np.diff(recon.sync[:, 1])).max() <= 8


def test_reconstruct_low_snr_still_locks():
    cap = _capture(0.5, snr_db=5.0, seed=9)
    timing = estimate_timing(cap.iq, FS)
    assert timing.mode_name == "640x480 @ 60Hz"


def test_sharded_reconstruct_matches_single_chip():
    """The sharded path is *phase-exact*: its frame cuts equal the single-chip
    carry-phase streaming path fed the same consecutive blocks (VERDICT r1 #3),
    and the (A,B) associative EMA combine equals a sequential fold."""
    from tempest_tpu.pipeline.offline import make_reconstruct_fn

    cap = _capture(0.8)
    mesh = make_mesh(8)
    F = 5
    spf = FS / MODE.refresh
    cfg = ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=F)
    step = sharded_reconstruct_fn(cfg, mesh)
    S = int(np.ceil(spf * F)) + 1
    iq = cap.iq[: 8 * S].reshape(8, S)
    iq_dev = jax.device_put(jnp.asarray(iq), NamedSharding(mesh, P("blocks", None)))
    ema, frames, sync, score = step(
        iq_dev, jnp.zeros((600, 800), jnp.float32), jnp.float32(0.5)
    )
    assert frames.shape == (40, 600, 800)

    # Single-chip carry-phase streaming over the same consecutive blocks.
    import dataclasses

    cfg1 = dataclasses.replace(cfg, carry_phase=True)
    step1 = make_reconstruct_fn(cfg1)
    ema1 = jnp.zeros((600, 800), jnp.float32)
    frames1, sync1 = [], []
    for d in range(8):
        block = jnp.asarray(cap.iq[d * S : d * S + cfg1.block_samples])
        phase = (-(d * S)) % spf
        ema1, f, s, _ = step1(block, ema1, jnp.float32(0.5), jnp.float32(phase))
        frames1.append(np.asarray(f))
        sync1.append(np.asarray(s))
    frames1 = np.concatenate(frames1)
    sync1 = np.concatenate(sync1)
    # Shards 0..6 are phase-exact vs streaming; shard 7's halo wraps to the
    # stream head (circular tail) while streaming reads the true continuation.
    np.testing.assert_allclose(np.asarray(frames)[:35], frames1[:35], atol=1e-3)
    np.testing.assert_array_equal(np.asarray(sync)[:35], sync1[:35])
    # The associative EMA combine == sequential fold over the same frames.
    e = np.zeros((600, 800), np.float64)
    for f in np.asarray(frames):
        e = 0.5 * e + 0.5 * f
    np.testing.assert_allclose(np.asarray(ema), e.astype(np.float32), atol=1e-3)


def test_sharded_mode_search_finds_true_mode():
    cap = _capture(0.2)
    mesh = make_mesh(8)
    cands = candidate_modes(60.0, tol_hz=0.5)
    assert len(cands) > 8  # real fan-out across devices
    res = sharded_mode_search(cap.iq, FS, 60.0, cands, mesh, n_frames=2)
    assert res.names[res.best_index] == "640x480 @ 60Hz"
    assert res.scores.shape == (len(cands),)


def test_mode_search_static_finds_true_mode():
    """The static-table hypothesis search (stacked per-candidate mxu3
    tables, batched einsums — no dynamic-geometry gathers) must agree with
    the full search's winner."""
    from tempest_tpu.parallel.sharded import mode_search_static

    cap = _capture(0.2)
    cands = candidate_modes(60.0, tol_hz=0.5)
    assert len(cands) > 8
    res = mode_search_static(cap.iq, FS, 60.0, cands, n_frames=2)
    assert res.names[res.best_index] == "640x480 @ 60Hz"
    assert res.scores.shape == (len(cands),)


def test_sharded_welch_matches_single():
    from tempest_tpu.ops.spectrum import get_welch, get_welch_sharded

    rng = np.random.default_rng(5)
    sig = (rng.standard_normal(32768) + 1j * rng.standard_normal(32768)).astype(
        np.complex64
    )
    mesh = make_mesh(8)
    f1, p1 = get_welch(1e6, jnp.asarray(sig), fft_size=1024)
    f2, p2 = get_welch_sharded(1e6, jnp.asarray(sig), mesh, fft_size=1024)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2))
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-3)


@pytest.mark.parametrize(
    "mode_name,fs",
    [
        ("800x600 @ 72Hz", 6e6),
        ("1024x768 @ 85Hz", 12e6),
        ("1280x1024 @ 75Hz", 14e6),
    ],
)
def test_timing_estimation_other_rates(mode_name, fs):
    """Refresh/line-count estimation must work across the mode table, not
    just 60 Hz."""
    mode = tt.ALL_VIDEO_MODES[mode_name]
    cap = tt.generate_iq(mode, fs, int(fs * 0.3), snr_db=18.0, seed=21)
    timing = estimate_timing(cap.iq, fs)
    assert abs(timing.refresh_hz - mode.refresh) < 0.05
    assert timing.mode.height == mode.height, timing


def test_unknown_resampler_is_refused():
    """The Pallas resampler kernel is gone: asking for it (or any name
    outside RESAMPLERS) fails at config construction with the valid list,
    instead of falling through to a KeyError at trace time."""
    import dataclasses

    from tempest_tpu.pipeline.offline import RESAMPLERS

    for bad in ("pallas", "nope"):
        with pytest.raises(ValueError, match="valid resamplers: mxu3, mxu"):
            ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=1,
                                 resampler=bad)
    cfg = ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=1)
    with pytest.raises(ValueError, match="pallas"):
        dataclasses.replace(cfg, resampler="pallas")
    for ok in RESAMPLERS:
        assert dataclasses.replace(cfg, resampler=ok).resampler == ok


def test_package_loads_no_pallas_and_no_backend_branch():
    """Importing every module of the package loads no Pallas (the one
    kernel, written for another accelerator, is gone), and no module
    chooses its code path by asking which backend it runs on."""
    import os
    import pathlib
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys, tempest_tpu\n"
        "for m in pkgutil.walk_packages(tempest_tpu.__path__, 'tempest_tpu.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if 'pallas' in k))\n"
    )
    root = pathlib.Path(tt.__file__).parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    pkg = pathlib.Path(tt.__file__).parent
    hits = [str(p) for p in pkg.rglob("*.py")
            if "default_backend(" in p.read_text()]
    assert not hits, hits


def test_subsample_align_improves_psnr():
    """Sub-sample-exact frame cuts must beat rounded cuts on the deep-averaged
    image when per-frame sync alignment is off: rounding leaves +-0.5-sample
    phase jitter per frame (~+-2 px here) that blurs the EMA.

    (With do_align=True the sync stage already compensates the jitter at
    integer-pixel granularity, measured delta ~0 — so exact cuts are the
    fidelity path for sparse-sync / drift-locked streaming, and measured
    slightly above even the per-frame-sync EMA: 15.48 vs 15.43 dB here.)"""
    import dataclasses

    from tempest_tpu.ops.resample import downgrade_image
    from tempest_tpu.render.screen import aligned_psnr

    cap = _capture(0.8, snr_db=30.0)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=40, resampler="gather",
        do_align=False,
    )
    base = reconstruct_frames(cap.iq, cfg, alpha=0.9)
    sub = reconstruct_frames(
        cap.iq, dataclasses.replace(cfg, subsample_align=True), alpha=0.9
    )
    p_base, _ = aligned_psnr(truth, base.image)
    p_sub, _ = aligned_psnr(truth, sub.image)
    assert p_sub > p_base + 0.3, (p_base, p_sub)


def test_sharded_batched_serving_matches_single_device():
    """Stream-axis sharding (8 streams over 8 devices) must equal the
    unsharded vmapped step — serving parallelism has no cross-device math."""
    from tempest_tpu.parallel.sharded import sharded_batched_reconstruct_fn
    from tempest_tpu.pipeline.offline import make_batched_reconstruct_fn

    mesh = make_mesh(8)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=2, input_format="iq_interleaved"
    )
    n = cfg.block_samples
    iq = np.stack([
        tt.generate_iq(MODE, FS, n, snr_db=25.0, seed=s).iq[:n].view(np.float32)
        for s in range(8)
    ])
    ema0 = np.zeros((8, 600, 800), np.float32)
    sharded = sharded_batched_reconstruct_fn(cfg, mesh)
    iq_dev = jax.device_put(
        jnp.asarray(iq), NamedSharding(mesh, P("blocks", None)))
    ema_s, frames_s, *_ = sharded(iq_dev, jnp.asarray(ema0), jnp.float32(0.5))
    plain = make_batched_reconstruct_fn(cfg)
    ema_p, frames_p, *_ = plain(
        jnp.asarray(iq), jnp.asarray(ema0), jnp.float32(0.5))
    np.testing.assert_allclose(np.asarray(ema_s), np.asarray(ema_p), atol=1e-4)
    assert frames_s.shape == frames_p.shape


def test_subsample_align_mxu3_matches_gather_path():
    """subsample_align with resampler='mxu3' (exact cuts via host-built
    tables, full matmul speed) must agree with the gather fidelity path on
    the averaged image."""
    import dataclasses

    cap = _capture(0.3, snr_db=30.0)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=10, resampler="gather",
        subsample_align=True, do_align=False,
    )
    ref = reconstruct_frames(cap.iq, cfg, alpha=0.9)
    fast = reconstruct_frames(
        cap.iq, dataclasses.replace(cfg, resampler="mxu3"), alpha=0.9
    )
    scale = ref.image.max() - ref.image.min() + 1e-9
    d = np.abs(fast.image - ref.image)[2:-2] / scale
    # mxu3 quantises the sub-sample phase to 1/64; real emanations are
    # broadband so allow percent-level pointwise deviation.
    assert d.mean() < 0.01 and d.max() < 0.08, (d.mean(), d.max())


def test_phase_quantised_fidelity_matches_exact_tables():
    """The streaming fidelity step (carry_phase + phase_bins: per-bin
    grouping tables fed to ONE compiled program as traced int32 inputs)
    must reproduce frames_to_screens_mxu3_exact evaluated at the quantised
    offsets — the two are the same compute graph, constants vs inputs."""
    from tempest_tpu.ops.resample import frames_to_screens_mxu3_exact
    from tempest_tpu.pipeline.offline import make_reconstruct_fn

    cap = _capture(0.2, snr_db=30.0)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, resampler="mxu3",
        subsample_align=True, do_align=False, carry_phase=True,
        phase_bins=16, input_format="iq_interleaved",
    )
    from tempest_tpu.ops.demod import am_envelope_from_iq

    step = make_reconstruct_fn(cfg)
    plan = step.plan
    words = cap.iq[: cfg.block_samples].view(np.float32)
    # Truth must start from the SAME envelope the step demodulates: a host
    # np.abs differs from the device sqrt(I²+Q²) at ~1e-7, which is enough
    # to flip bf16 rounding boundaries in the selection cast.
    env = np.asarray(am_envelope_from_iq(jnp.asarray(words)))
    ema0 = jnp.zeros(cfg.render_size, jnp.float32)
    spf = cfg.samples_per_frame
    for phase in (0.0, 0.37, spf * 0.631):
        ema, frames, sync, score = step(words, ema0, jnp.float32(0.9), phase)
        assert np.all(np.asarray(sync) == 0)  # sync stage off in fidelity
        k, m = plan.bin_for_phase(phase)
        offs = k / cfg.phase_bins + (np.arange(cfg.n_frames) * spf - plan.u)
        truth = frames_to_screens_mxu3_exact(
            jnp.asarray(env), m + plan.u, offs,
            int(np.floor(spf)), MODE.height, MODE.width, cfg.render_size,
        )
        truth = np.asarray(truth)
        scale = truth.max() - truth.min() + 1e-9
        d = np.abs(np.asarray(frames) - truth) / scale
        # The bottom rows read a few samples past the frame boundary, where
        # the two paths pad differently (real continuation vs per-frame edge
        # replication) — exclude them; everywhere else the graphs agree.
        assert d[:, :-2].max() < 2e-3, float(d[:, :-2].max())


def test_pick_line_peak_recovers_true_mode():
    """A strong line-periodic interferer locks the automatic comb onto the
    wrong line rate; the ranked peak list must still contain the true line
    peak, and picking it must recover the true mode — the reference's
    interactive click-the-other-peak (GUI.jl:512-523, delay2yt :238-252)
    fully automated."""
    from tempest_tpu.pipeline.offline import pick_line_peak, timing_evidence

    n = int(FS * 0.4)
    cap = _capture(0.4, snr_db=20.0)
    spf = FS / 60.0
    t = np.arange(n)
    # Interferer: strong AM at a WRONG line rate (700 lines/frame), with a
    # slow random-walk phase so its SHORT-lag correlations (the line-period
    # window, ~100-600 samples) stay strong while its LONG-lag correlations
    # (the 50-90 Hz refresh band, ~44k-80k samples) decohere — the refresh
    # lock stays near the true signal's, only the line comb is fooled.
    L_i = spf / 700.0
    rng = np.random.default_rng(9)
    phi = np.cumsum(rng.normal(0.0, 0.02, n))
    am = 1.0 + 0.8 * np.cos(2 * np.pi * t / L_i + phi)
    interferer = (1.2 * am * np.exp(2j * np.pi * 0.13 * t)).astype(np.complex64)
    iq = (cap.iq[:n] + interferer).astype(np.complex64)

    timing, ev = timing_evidence(iq, FS, 0.1)
    assert abs(timing.refresh_hz - 60.0) < 0.5
    assert abs(timing.line_count - 525) > 20, timing.line_count  # fooled
    assert ev.line_peaks is not None and len(ev.line_peaks) >= 2
    ys = ev.line_peaks[:, 1]
    idx = int(np.argmin(np.abs(ys - 525)))
    assert abs(ys[idx] - 525) < 3, ys  # the true peak is in the ranked list
    picked = pick_line_peak(timing, ev, idx)
    assert picked.mode_name == "640x480 @ 60Hz"
    assert abs(picked.mode.height - 525) < 1
    # auto_reconstruct honours the same override end-to-end.
    timing2, recon = auto_reconstruct(iq, FS, alpha=0.6, pick_line_peak=idx)
    assert timing2.mode_name == "640x480 @ 60Hz"
    assert recon.image.std() > 0


def test_alignment_mode_drift_law():
    """The measured mode-selection rule: with a
    drift-locked refresh, exact cuts match-or-beat per-frame sync on deep
    averages; with 100 ppm of residual refresh error, per-frame sync must
    win by a wide margin (it tracks the moving blank; unsync'd exact cuts
    shear)."""
    import dataclasses

    from tempest_tpu.render.screen import aligned_psnr
    from tempest_tpu.video.modes import VideoMode

    cap = _capture(0.8, snr_db=30.0)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))

    def psnr(cfg):
        r = reconstruct_frames(cap.iq, cfg, alpha=0.9)
        return aligned_psnr(truth, r.image)[0]

    locked = ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=40)
    p_sync = psnr(locked)
    p_exact = psnr(dataclasses.replace(
        locked, subsample_align=True, do_align=False))
    assert p_exact > p_sync - 0.05, (p_sync, p_exact)

    drifted = dataclasses.replace(
        locked, mode=VideoMode(MODE.width, MODE.height, 60.0 * 1.0001))
    p_sync_d = psnr(drifted)
    p_exact_d = psnr(dataclasses.replace(
        drifted, subsample_align=True, do_align=False))
    assert p_sync_d > p_exact_d + 1.0, (p_sync_d, p_exact_d)


def test_interp_taps_quality_rule():
    """Catmull-Rom (interp_taps=4) must beat linear on OVERSAMPLED captures
    (≥1 sample/raster px) and lose below — the measured alias-energy rule
    that drives auto_reconstruct's auto selection."""
    import dataclasses

    from tempest_tpu.render.screen import aligned_psnr

    def psnr_pair(fs, seconds):
        cap = tt.generate_iq(MODE, fs, int(fs * seconds), snr_db=30.0, seed=3)
        truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
        cfg2 = ReconstructionConfig(
            sample_rate=fs, mode=MODE, n_frames=int(seconds * 60) - 2,
            subsample_align=True, do_align=False,
        )
        cfg4 = dataclasses.replace(cfg2, interp_taps=4)
        p2, _ = aligned_psnr(truth, reconstruct_frames(cap.iq, cfg2, 0.9).image)
        p4, _ = aligned_psnr(truth, reconstruct_frames(cap.iq, cfg4, 0.9).image)
        return p2, p4

    p2u, p4u = psnr_pair(4e6, 0.4)     # 0.16 samples/raster px: undersampled
    assert p2u > p4u + 0.15, (p2u, p4u)
    p2o, p4o = psnr_pair(32e6, 0.3)    # 1.27 samples/raster px: oversampled
    assert p4o > p2o + 0.15, (p2o, p4o)


def test_planar_input_format_matches_interleaved():
    """input_format='iq_planar' (host de-interleave, contiguous device demod)
    must reproduce the interleaved pipeline exactly."""
    cap = _capture(0.2)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, input_format="iq_interleaved"
    )
    words = cap.iq.view(np.float32)
    rec_i = reconstruct_frames(words, cfg, alpha=0.5)
    import dataclasses

    cfg_p = dataclasses.replace(cfg, input_format="iq_planar")
    rec_p = reconstruct_frames(words, cfg_p, alpha=0.5)  # auto-planarised
    np.testing.assert_allclose(rec_p.image, rec_i.image, atol=1e-5)
    np.testing.assert_array_equal(rec_p.sync, rec_i.sync)


def test_fused_batched_serving_matches_vmap():
    """The fused serving program (all B*F frames through one resample/sync
    batch) must reproduce the vmapped single-stream program to f32
    reassociation."""
    from tempest_tpu.pipeline.offline import make_batched_reconstruct_fn

    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, input_format="iq_interleaved"
    )
    n = cfg.block_samples
    iq = np.stack([
        tt.generate_iq(MODE, FS, n, snr_db=25.0, seed=s).iq[:n].view(np.float32)
        for s in range(3)
    ])
    ema0 = jnp.zeros((3, 600, 800), jnp.float32)
    fused = make_batched_reconstruct_fn(cfg, fuse=True)
    plain = make_batched_reconstruct_fn(cfg)             # default: vmap
    ef, ff, sf, cf = fused(jnp.asarray(iq), ema0, jnp.float32(0.5))
    ep, fp, sp, cp = plain(jnp.asarray(iq), ema0, jnp.float32(0.5))
    assert ff.shape == fp.shape == (3, 3, 600, 800)
    np.testing.assert_allclose(np.asarray(ef), np.asarray(ep), atol=2e-4)
    np.testing.assert_allclose(np.asarray(ff), np.asarray(fp), atol=2e-4)
    np.testing.assert_array_equal(np.asarray(sf), np.asarray(sp))


def test_batched_quantised_fidelity_matches_per_stream():
    """Batched carry-phase fidelity (per-stream bin tables gathered on
    device from the K-resident set) must equal running each stream through
    the single-stream quantised step."""
    from tempest_tpu.pipeline.offline import (
        make_batched_reconstruct_fn,
        make_reconstruct_fn,
    )

    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=2, input_format="iq_interleaved",
        carry_phase=True, subsample_align=True, do_align=False,
        resampler="mxu3", phase_bins=16,
    )
    n = cfg.block_samples
    B = 3
    iq = np.stack([
        tt.generate_iq(MODE, FS, n, snr_db=25.0, seed=s).iq[:n].view(np.float32)
        for s in range(B)
    ])
    phases = [0.0, 0.4, FS / 60.0 * 0.73]
    ema0 = jnp.zeros((B, 600, 800), jnp.float32)
    bstep = make_batched_reconstruct_fn(cfg)
    eb, fb, sb, cb = bstep(jnp.asarray(iq), ema0, jnp.float32(0.7), phases)
    assert fb.shape == (B, 2, 600, 800)
    single = make_reconstruct_fn(cfg)
    for b in range(B):
        e1, f1, *_ = single(
            jnp.asarray(iq[b]), ema0[0], jnp.float32(0.7), phases[b])
        np.testing.assert_allclose(np.asarray(fb[b]), np.asarray(f1),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(eb[b]), np.asarray(e1),
                                   atol=1e-4)


def test_sharded_batched_serving_carry_phase():
    """The serving-parallel step must also support carry_phase configs
    (per-stream fractional frame phase rides the stream axis)."""
    from tempest_tpu.parallel.sharded import sharded_batched_reconstruct_fn
    from tempest_tpu.pipeline.offline import make_batched_reconstruct_fn

    mesh = make_mesh(8)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=1, carry_phase=True,
        input_format="iq_interleaved",
    )
    n = cfg.block_samples
    iq = np.stack([
        tt.generate_iq(MODE, FS, n, snr_db=25.0, seed=s).iq[:n].view(np.float32)
        for s in range(8)
    ])
    ema0 = np.zeros((8, 600, 800), np.float32)
    phases = np.linspace(0.0, 0.9, 8).astype(np.float32)
    sharded = sharded_batched_reconstruct_fn(cfg, mesh)
    iq_dev = jax.device_put(
        jnp.asarray(iq), NamedSharding(mesh, P("blocks", None)))
    ema_s, *_ = sharded(
        iq_dev, jnp.asarray(ema0), jnp.float32(0.5), jnp.asarray(phases))
    plain = make_batched_reconstruct_fn(cfg)
    ema_p, *_ = plain(
        jnp.asarray(iq), jnp.asarray(ema0), jnp.float32(0.5),
        jnp.asarray(phases))
    np.testing.assert_allclose(np.asarray(ema_s), np.asarray(ema_p), atol=1e-4)


def test_align_subpixel_improves_psnr():
    """Sub-pixel sync registration (parabolic peak + fractional roll) must
    beat integer circshift alignment on a noisy moderately-averaged capture:
    integer rolls leave ±0.5 px of per-frame registration jitter that blurs
    the EMA.  (Measured: +0.32 dB here; +0.51 dB on the judged 1080p60 /
    20 Msps config; ~neutral on clean deep averages near the interpolation
    ceiling.)"""
    import dataclasses

    from tempest_tpu.ops.resample import downgrade_image
    from tempest_tpu.render.screen import aligned_psnr

    cap = tt.generate_iq(MODE, FS, int(FS * 0.3), snr_db=18.0, seed=33)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    cfg = ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=14)
    base = reconstruct_frames(cap.iq, cfg, alpha=0.5)
    sub = reconstruct_frames(
        cap.iq, dataclasses.replace(cfg, align_subpixel=True), alpha=0.5
    )
    p_base, _ = aligned_psnr(truth, base.image)
    p_sub, _ = aligned_psnr(truth, sub.image)
    assert p_sub > p_base + 0.15, (p_base, p_sub)


def test_scan_frame_loop_matches_vmap():
    """frame_loop='scan' (compile-light large blocks) must be numerically
    identical to the vmapped loop."""
    import dataclasses

    cap = _capture(0.2)
    cfg = ReconstructionConfig(sample_rate=FS, mode=MODE, n_frames=3)
    rec = reconstruct_frames(cap.iq, cfg, alpha=0.5)
    cfg2 = dataclasses.replace(cfg, frame_loop="scan")
    rec2 = reconstruct_frames(cap.iq, cfg2, alpha=0.5)
    np.testing.assert_allclose(rec2.image, rec.image, atol=1e-5)
    np.testing.assert_array_equal(rec2.sync, rec.sync)


def test_segmented_batched_resampler_in_pipeline():
    """resampler='mxu_batched' with segments matches the per-frame mxu path
    through the full pipeline."""
    import dataclasses

    cap = _capture(0.2)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, resampler="gather", do_align=False
    )
    rec = reconstruct_frames(cap.iq, cfg, alpha=0.5)
    cfg2 = dataclasses.replace(cfg, resampler="mxu_batched", segments=4)
    rec2 = reconstruct_frames(cap.iq, cfg2, alpha=0.5)
    scale = rec.image.max() - rec.image.min() + 1e-9
    # Interior bound: phase quantisation (64 levels) + bf16 contraction;
    # the first/last rows legitimately differ (the gather path clamps at the
    # frame edge, the batched path reads the real neighbouring samples).
    assert np.abs(rec.image - rec2.image)[2:-2].max() / scale < 0.02


def test_pipeline_with_fft_resampler():
    """The gather-free spectral resampler slots into the jitted pipeline and
    reconstructs the same screen as the gather path (sinc vs linear
    interpolation and circular frame-edge semantics bound the difference)."""
    import dataclasses

    cap = _capture(0.2)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, resampler="fft", do_align=False
    )
    rec = reconstruct_frames(cap.iq, cfg, alpha=0.5)
    cfg2 = dataclasses.replace(cfg, resampler="gather")
    rec2 = reconstruct_frames(cap.iq, cfg2, alpha=0.5)
    scale = rec2.image.max() - rec2.image.min() + 1e-9
    d = np.abs(rec.image - rec2.image)[2:-2] / scale
    # Interior agreement: sinc and linear interpolation legitimately differ
    # on undersampled wideband content (the unit test proves tight agreement
    # on band-limited signals); this bounds gross wiring/geometry errors.
    assert d.mean() < 0.03
    assert d.max() < 0.4


def test_fidelity_1080p60_20msps():
    """The primary judged configuration (BASELINE.md): 1920x1080@60 from a
    20 Msps stream — reconstruction must match the generator's ground truth."""
    from tempest_tpu.render.screen import aligned_psnr

    mode = tt.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    fs = 20e6
    cap = tt.generate_iq(mode, fs, int(fs * 0.25), snr_db=18.0, seed=33)
    timing, recon = auto_reconstruct(cap.iq, fs, alpha=0.5)
    assert timing.mode_name == "1920x1080 @ 60Hz", timing
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    db, shift = aligned_psnr(truth, recon.image)
    # The information-theoretic ceiling at 20 Msps (≈296 samples/line against
    # 2576 raster px) is ~15.3 dB (noiseless, exact-parameter oracle); the
    # full auto pipeline at 18 dB SNR must come within ~3 dB of it.
    assert db > 12.0, f"1080p60 reconstruction PSNR {db:.1f} dB"


def test_fidelity_1080p60_quantised_psnr_matches_gather():
    """The acceptance check on the judged config: streaming fidelity through
    the phase-quantised tables must reconstruct the 1080p60 / 20 Msps
    synthetic capture at the traced-offset gather chain's PSNR.

    Measured: the gap is 0.074 dB and UNCHANGED from 64 to 1024 bins — i.e.
    it is not phase quantisation at all but the mxu3 selection stage's
    deliberate bf16 envelope cast plus frame-edge boundary semantics (the
    same fixed offset every mxu3-family chain carries, sign capture-
    specific).  Tolerance 0.1 dB bounds that class."""
    import dataclasses

    from tempest_tpu.pipeline.offline import make_reconstruct_fn
    from tempest_tpu.render.screen import aligned_psnr

    mode = tt.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    fs = 20e6
    cfg_q = ReconstructionConfig(
        sample_rate=fs, mode=mode, n_frames=4, input_format="iq_interleaved",
        carry_phase=True, subsample_align=True, do_align=False,
        resampler="mxu3", phase_bins=64,
    )
    cfg_g = dataclasses.replace(cfg_q, resampler="gather", phase_bins=0)
    n = cfg_q.block_samples
    cap = tt.generate_iq(mode, fs, 3 * n, snr_db=18.0, seed=33)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    spf = cfg_q.samples_per_frame

    def run(cfg):
        step = make_reconstruct_fn(cfg)
        ema = jnp.zeros(cfg.render_size, jnp.float32)
        for b in range(3):
            blk = jnp.asarray(cap.iq[b * n : (b + 1) * n].view(np.float32))
            ema, *_ = step(blk, ema, jnp.float32(0.5), (-(b * n)) % spf)
        return aligned_psnr(truth, np.asarray(ema))[0]

    p_q, p_g = run(cfg_q), run(cfg_g)
    assert abs(p_q - p_g) < 0.1, (p_q, p_g)


def test_streaming_plan_einsum_bf16_equivalence():
    """The plan's einsum_bf16 knob (weights einsum in bf16, halving the
    weight bytes) must stay within a fraction of a percent of the f32 path
    on CPU, where f32 matmuls are true f32 — the bf16 rounding of the
    interpolation coefficients (≤2^-9 relative) is the whole difference."""
    import dataclasses

    from tempest_tpu.pipeline.offline import make_reconstruct_fn

    cap = _capture(0.2, snr_db=30.0)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, resampler="mxu3",
        subsample_align=True, do_align=False, carry_phase=True,
        phase_bins=16, input_format="iq_interleaved",
    )
    words = cap.iq[: cfg.block_samples].view(np.float32)
    ema0 = jnp.zeros(cfg.render_size, jnp.float32)
    outs = {}
    for bf16 in (False, True):
        step = make_reconstruct_fn(dataclasses.replace(cfg, einsum_bf16=bf16))
        ema, *_ = step(words, ema0, jnp.float32(0.9), 0.37)
        outs[bf16] = np.asarray(ema)
    scale = outs[False].max() - outs[False].min() + 1e-9
    d = np.abs(outs[True] - outs[False]) / scale
    assert d.max() < 5e-3, float(d.max())


def test_streaming_plan_fused_demod_cut_bit_exact():
    """``fuse_demod_cut`` (slice the raw interleaved words first, demod
    per-frame rows — StreamingExactPlan.cut_words_am) must be BIT-exact
    against the demod→cut order: slicing commutes with the pointwise pair
    demod and both orders push the same pairs through the same one-hot
    pair-sum matmul.  Off by default; this pins the equivalence for a
    re-measurement on the GPU."""
    import dataclasses

    from tempest_tpu.pipeline.offline import make_reconstruct_fn

    cap = _capture(0.2, snr_db=30.0)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, resampler="mxu3",
        subsample_align=True, do_align=True, carry_phase=True,
        phase_bins=16, input_format="iq_interleaved",
    )
    words = cap.iq[: cfg.block_samples].view(np.float32)
    ema0 = jnp.zeros(cfg.render_size, jnp.float32)
    outs = {}
    for fused in (False, True):
        step = make_reconstruct_fn(
            dataclasses.replace(cfg, fuse_demod_cut=fused))
        ema, *_ = step(words, ema0, jnp.float32(0.9), 0.37)
        outs[fused] = np.asarray(ema)
    assert np.array_equal(outs[True], outs[False])
    # The word-level cut only commutes with the pointwise AM pair demod.
    with pytest.raises(ValueError, match="fuse_demod_cut"):
        make_reconstruct_fn(
            dataclasses.replace(cfg, fuse_demod_cut=True, demod="fm"))


@pytest.mark.parametrize("chain", ["offline", "judged-tables"])
def test_subpixel_align_impl_chain_equivalence(chain):
    """The full sub-pixel chain with align_impl='matmul' must match the
    'roll' chain on CPU (true f32 matmuls — difference is reassociation),
    both on the plain offline chain and on bench.py's judged configuration
    (quantised exact-cut tables + sub-pixel sync)."""
    import dataclasses

    from tempest_tpu.pipeline.offline import make_reconstruct_fn

    cap = _capture(0.2, snr_db=25.0)
    extra = {} if chain == "offline" else dict(
        carry_phase=True, subsample_align=True, resampler="mxu3",
        phase_bins=16, einsum_bf16=True,
    )
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, align_subpixel=True,
        input_format="iq_interleaved", **extra,
    )
    words = cap.iq[: cfg.block_samples].view(np.float32)
    ema0 = jnp.zeros(cfg.render_size, jnp.float32)
    outs = {}
    for impl in ("roll", "matmul"):
        step = make_reconstruct_fn(dataclasses.replace(cfg, align_impl=impl))
        args = (words, ema0, jnp.float32(0.9))
        if cfg.carry_phase:
            args = args + (0.37,)
        ema, _, sync, _ = step(*args)
        outs[impl] = (np.asarray(ema), np.asarray(sync))
    np.testing.assert_allclose(outs["roll"][1], outs["matmul"][1],
                               atol=1e-4)
    scale = outs["roll"][0].max() - outs["roll"][0].min() + 1e-9
    d = np.abs(outs["roll"][0] - outs["matmul"][0]) / scale
    assert d.max() < 1e-3, float(d.max())


def test_streaming_plan_tables_match_scalar_reference():
    """The plan's vectorised lazy table build must reproduce the scalar
    per-(bin, frame) construction bit-for-bit — a direct transcription of
    the original loop (floor/clip/pack per pair) is the oracle here, run on
    a small geometry.  Also pins per-bin lazy tables == full-stack rows."""
    from tempest_tpu.ops.resample import (StreamingExactPlan, _pack_slots,
                                          _screen_geometry)

    spf, F, K, P = 4e6 / 59.94, 3, 8, 32
    y_t, x_t, out_shape = 525, 800, (60, 80)
    frame_len = int(np.ceil(spf)) + 1
    plan = StreamingExactPlan(frame_len, spf, F, y_t, x_t, out_shape,
                              num_phases=P, phase_bins=K)

    base_start, base_frac, _, _, _ = _screen_geometry(frame_len, y_t, x_t,
                                                      out_shape)
    a_base = base_start.reshape(-1).astype(np.float64) + base_frac.reshape(-1)
    n_lines = 2 * out_shape[0]
    u = np.floor(np.arange(F) * spf)
    r = np.arange(F) * spf - u
    for k in range(K):
        sel_k, reg_k, blend_k = plan.tables(k)
        for f in range(F):
            a = a_base + (k / K + r[f])
            fstart = np.maximum(np.floor(a).astype(np.int64), 0)
            frac = np.clip(a - fstart, 0.0, 1.0 - 1e-9)
            ph = np.minimum((frac * P).astype(np.int64), P - 1)
            ch, of = fstart // 128, fstart % 128
            so, _ = _pack_slots(of, 128)
            sp, _ = _pack_slots(ph, P)
            o_slot = of * plan.per_o + so
            p_slot = ph * plan.per_p + sp
            sel_ref = np.full(128 * plan.per_o, -1, np.int32)
            sel_ref[o_slot] = ch
            reg_ref = np.full(P * plan.per_p, -1, np.int32)
            reg_ref[p_slot] = o_slot
            np.testing.assert_array_equal(sel_k[f], sel_ref)
            np.testing.assert_array_equal(reg_k[f], reg_ref)
            np.testing.assert_array_equal(blend_k[f], p_slot)
        # Lazy per-bin tables are the same rows the full stacks hold.
        np.testing.assert_array_equal(sel_k, plan.sel_src[k])
        np.testing.assert_array_equal(reg_k, plan.reg_src[k])
        np.testing.assert_array_equal(blend_k, plan.blend_idx[k])


def test_batched_multi_stream_reconstruction():
    """B independent IQ channels reconstruct concurrently (vmapped step)."""
    from tempest_tpu.pipeline.offline import make_batched_reconstruct_fn

    caps = [
        tt.generate_iq(MODE, FS, int(FS * 0.15), snr_db=25.0, seed=s)
        for s in (41, 42, 43)
    ]
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=3, input_format="iq_interleaved"
    )
    step = make_batched_reconstruct_fn(cfg)
    n = cfg.block_samples
    iq = jnp.asarray(
        np.stack([c.iq[:n].view(np.float32) for c in caps])
    )
    ema0 = jnp.zeros((3, 600, 800), jnp.float32)
    ema, frames, sync, score = step(iq, ema0, jnp.float32(0.5))
    assert ema.shape == (3, 600, 800)
    assert frames.shape == (3, 3, 600, 800)
    # Each stream must match its own single-stream reconstruction.
    single = reconstruct_frames(caps[1].iq[:n].view(np.float32), cfg, alpha=0.5)
    np.testing.assert_allclose(np.asarray(ema)[1], single.image, atol=1e-4)


def test_fidelity_2048x1536_reference_demo_mode():
    """The reference's demonstrated capture mode (2048x1536@60, readable
    large text from a 20 MHz stream — reference docs/src/gui.md:29)."""
    from tempest_tpu.render.screen import aligned_psnr

    mode = tt.ALL_VIDEO_MODES["2048x1536 @ 60Hz"]  # 2800x1589 total
    fs = 20e6
    cap = tt.generate_iq(mode, fs, int(fs * 0.25), snr_db=18.0, seed=44)
    timing, recon = auto_reconstruct(cap.iq, fs, alpha=0.5)
    assert timing.mode_name == "2048x1536 @ 60Hz", timing
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    db, _ = aligned_psnr(truth, recon.image)
    assert db > 11.0, f"2048x1536 PSNR {db:.1f} dB"


def test_sharded_mode_search_2d_mesh():
    """Time × modes 2-D mesh: 2 time shards × 4 mode shards on 8 devices."""
    from jax.sharding import Mesh
    from tempest_tpu.parallel.sharded import sharded_mode_search_2d

    cap = _capture(0.2)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("blocks", "modes"))
    cands = candidate_modes(60.0, tol_hz=0.5)
    res = sharded_mode_search_2d(cap.iq, FS, 60.0, cands, mesh, frames_per_shard=2)
    assert res.names[res.best_index] == "640x480 @ 60Hz"
    assert res.scores.shape == (len(cands),)


def test_fm_modulated_reconstruction():
    """An FM-modulated emanation reconstructs through the discriminator path."""
    import dataclasses

    cap = tt.generate_iq(
        MODE, FS, int(FS * 0.2), snr_db=30.0, seed=51, modulation="fm"
    )
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=4, demod="fm", do_align=False
    )
    rec = reconstruct_frames(cap.iq, cfg, alpha=0.5)
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    corr = _best_corr(truth, rec.image)
    assert corr > 0.7, f"FM reconstruction corr {corr}"


def test_fm_auto_reconstruct():
    """auto_reconstruct(demod="fm") drives the WHOLE auto chain off the
    discriminator (timing + mode detect + reconstruction) — the reference
    GUI's demod selector includes fmDemod on its main path.  A constant-
    amplitude FM capture has a flat envelope, so the AM timing statistic
    cannot lock (measured: mis-detects 56.85 Hz on this fixture where the
    FM path reads exactly 60.000)."""
    from tempest_tpu.pipeline.offline import auto_reconstruct

    mode = tt.ALL_VIDEO_MODES["800x600 @ 60Hz"]
    fs = 16e6
    cap = tt.generate_iq(mode, fs, int(fs * 0.4), snr_db=15.0, seed=9,
                         modulation="fm")
    timing, recon = auto_reconstruct(cap.iq, fs, alpha=0.6, demod="fm")
    assert timing.mode_name == "800x600 @ 60Hz"
    assert abs(timing.refresh_hz - 60.0) < 0.01
    truth = np.asarray(downgrade_image(jnp.asarray(cap.frame)))
    corr = _best_corr(truth, recon.image)
    assert corr > 0.7, f"FM auto reconstruction corr {corr}"


def test_cli_fm_single_carrier(tmp_path, capsys):
    """CLI: synth --modulation fm (single carrier) -> analyze --demod fm
    locks the mode; reconstruct --demod fm writes the image."""
    from tempest_tpu.app.cli import main as cli_main

    dat = tmp_path / "fm1.dat"
    out = tmp_path / "fm1.png"
    assert cli_main([
        "synth", "--mode", "800x600 @ 60Hz", "--fs", "16e6",
        "--seconds", "0.4", "--snr", "15", "--modulation", "fm",
        "--seed", "9", "--out", str(dat),
    ]) == 0
    assert cli_main([
        "analyze", str(dat), "--fs", "16e6", "--demod", "fm",
    ]) == 0
    assert "800x600 @ 60Hz" in capsys.readouterr().out
    assert cli_main([
        "reconstruct", str(dat), "--fs", "16e6", "--demod", "fm",
        "--alpha", "0.6", "--out", str(out),
    ]) == 0
    assert "800x600 @ 60Hz" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_custom_render_size():
    """render_size is configurable (the reference hardcodes 600x800)."""
    cap = _capture(0.15)
    cfg = ReconstructionConfig(
        sample_rate=FS, mode=MODE, n_frames=2, render_size=(304, 512)
    )
    rec = reconstruct_frames(cap.iq, cfg, alpha=0.5)
    assert rec.image.shape == (304, 512)
    assert rec.frames.shape == (2, 304, 512)
    assert np.isfinite(rec.image).all()


@pytest.mark.parametrize(
    "mode_name,fs,band",
    [
        ("PAL TV", 3e6, (20.0, 35.0)),           # 25 Hz, 576x625 total
        ("1024x768 @ 120Hz", 18e6, (95.0, 130.0)),
        ("640x480 @ 100Hz", 8e6, (95.0, 110.0)),
    ],
)
def test_timing_estimation_extreme_rates(mode_name, fs, band):
    """With an adjusted search band, auto-detection covers the whole mode
    table (PAL at 25 Hz through 120 Hz gaming modes), not just 50-90 Hz."""
    mode = tt.ALL_VIDEO_MODES[mode_name]
    cap = tt.generate_iq(mode, fs, int(fs * 0.35), snr_db=18.0, seed=23)
    timing = estimate_timing(cap.iq, fs, rate_min=band[0], rate_max=band[1])
    assert abs(timing.refresh_hz - mode.refresh) < 0.05
    assert timing.mode.height == mode.height, timing


def test_wide_band_no_octave_error():
    """Searching the full 20-130 Hz band on a 60 Hz capture must not lock on
    the 2P/3P repetition lags (30/20 Hz octave errors)."""
    cap = _capture(0.5)
    timing = estimate_timing(cap.iq, FS, rate_min=20.0, rate_max=130.0)
    assert abs(timing.refresh_hz - 60.0) < 0.05, timing
    assert timing.mode_name == "640x480 @ 60Hz"


def test_auto_reconstruct_interleaved_words():
    """auto_reconstruct accepts raw interleaved I/Q words: n_frames derives
    from the *complex* sample count and the mode search scores a demodulated
    envelope, not the raw word stream (ADVICE r1 items 2+3)."""
    cap = _capture(0.3)
    words = np.ascontiguousarray(cap.iq, np.complex64).view(np.float32)
    timing, recon = auto_reconstruct(words, FS, alpha=0.5)
    assert timing.mode_name == "640x480 @ 60Hz"
    _, recon2 = auto_reconstruct(cap.iq, FS, alpha=0.5)
    assert recon.frames.shape == recon2.frames.shape  # same frame count
    np.testing.assert_allclose(recon.image, recon2.image, atol=1e-5)
    timing3, _ = auto_reconstruct(
        words, FS, n_frames=2, alpha=0.5, refine_with_search=True
    )
    assert timing3.mode_name == "640x480 @ 60Hz"


def test_snr_adaptive_alpha():
    """estimate_timing reports an SNR proxy that orders clean vs noisy
    captures, and alpha='auto' maps it to a sensible EMA coefficient."""
    clean = tt.generate_iq(MODE, FS, int(FS * 0.3), snr_db=30.0, seed=61)
    noisy = tt.generate_iq(MODE, FS, int(FS * 0.3), snr_db=2.0, seed=61)
    t_clean = estimate_timing(clean.iq, FS)
    t_noisy = estimate_timing(noisy.iq, FS)
    assert t_clean.snr_db > t_noisy.snr_db
    assert 0.1 <= t_clean.suggested_alpha < t_noisy.suggested_alpha <= 0.9
    timing, recon = auto_reconstruct(noisy.iq, FS, alpha="auto", n_frames=3)
    assert recon.image.shape == (600, 800)
