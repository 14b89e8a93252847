"""Bring-up check of the TEMPEST chain on an NVIDIA GPU, through the entry
points a user calls, at the repo's primary deployment: a 1920x1080@60 screen
from a 20 Msps I/Q stream (BASELINE.md).

    python chip_smoke.py              # one card: phases A1-A4, D
    python chip_smoke.py --devices 4  # four cards: the mesh paths (E) only

Phases (one card):

  A1 offline    cli synth -> cli analyze (exact mode, refresh within 5 mHz)
                -> cli reconstruct (PNG read back, aligned PSNR vs truth)
  A2 streaming  StreamingRuntime + SyntheticSource (the path behind
                `cli stream --source synthetic`), default chain and
                fidelity=True, health() and PSNR of the final EMA
  A3 judged     bench.py's step (36 frames, phase_bins=64, sub-pixel sync,
                bf16 weights einsum, int16 ingest) on a seeded capture:
                memory analysis, peak device memory, stage times (trace)
  D  agreement  the A3 and A2 steps against (i) the same configuration at
                precision "highest" with an f32 weights einsum and (ii) the
                plain gather resampler at "highest"
  A4 wideband   cli synth --harmonics at 32 Msps -> cli scan ->
                cli reconstruct --combine all

Four cards (E): MeshStreamingRuntime on a 4-card mesh against the one-card
StreamingRuntime on the same stream; sharded_mode_search over 4 cards
against mode_search_static on one card; per-card peak memory.

Each phase prints one ``PHASE <name> {json}`` line (what ran, the quality it
reached, cold seconds — compile included — and warm seconds).  A failed
phase raises and the script exits non-zero.  The last line of standard
output is ``{"ok": true, "device": {"platform", "kind", "count"}}``.  Without
a GPU (or outside a checkout of this repository) the script exits non-zero
and prints no result.  Compiled programs persist in ``JAX_COMPILATION_CACHE_DIR``
or, when it is unset, ``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

MODE = "1920x1080 @ 60Hz"
FS = 20e6
# The wideband quick start runs at the CLI's defaults (4 MHz channels).
# Those leave a 1080p60 line only 59 channel samples and the line-count
# estimate locks to 768x576 (the CPU backend does the same on the same
# capture: a limit of the estimate, not of the card), while wider channels
# merge the harmonics into one emission; 1024x768@60 (83 samples per line)
# fuses all three carriers.
WIDE_MODE = "1024x768 @ 60Hz"
WIDE_FS = 32e6
HARMONICS = "-8e6,2.5e6,11e6"

# Quality floor for every reconstruction: the repo's own streaming-test
# floor (tests/test_runtime.py); a wrong mode, a lost frame grid or garbage
# values land far below it.
PSNR_FLOOR_DB = 10.0
# analyze must land within this of the true refresh.
REFRESH_TOL_HZ = 5e-3

# Agreement of the timed programs with the "highest" precision oracle (i),
# as max |timed - oracle| over the oracle EMA's dynamic range (max - min).
# f32 matmuls run as TF32 on the card (10 stored mantissa bits: relative
# rounding 2^-11 per operand, 2^-10 where the conversion truncates); the
# chain's matmuls after the exact one-hot selects (regroup, weights, blend,
# shift operators — up to 4 in a row) each add about that, on an envelope
# whose peak is ~2.5x the image's dynamic range: 4 * 2^-11 * 2.5 ~= 0.5%.
TOL_TF32 = 5e-3
# The judged step also casts the weights einsum to bf16 (8 significant
# bits: <= 2^-9 relative per coefficient, 2^-9 * 2.5 ~= 0.5% more).
TOL_TF32_BF16 = 1e-2
# Both effects are far below the capture noise, so the PSNR against the
# truth may not move by more than this between timed program and oracle.
TOL_PSNR_ORACLE_DB = 0.1
# Against the plain gather resampler (ii) the timed chain differs by design:
# the carry phase is quantised to 1/64 sample (<= 1/128 sample, ~0.02
# render px) and the envelope is cast to bf16 before the one-hot select
# (~0.4%, below the 20 dB capture noise).  The repo's own CPU check of the
# quantised chain against gather allows 0.1 dB (tests/test_pipeline.py);
# with per-frame sync on, different sub-pixel sync estimates per frame
# add a little: 0.3 dB.
TOL_PSNR_GATHER_DB = 0.3
# Four cards against one: the same per-span arithmetic; GEMM algorithms
# autotuned per program may round differently in TF32 (see TOL_TF32).
TOL_MESH = TOL_TF32
# A hang in the NCCL collectives of the mesh phase ends the process.
MESH_TIMEOUT_S = 600


def _say(name: str, record: dict) -> None:
    print(f"PHASE {name} {json.dumps(record, default=_jsonable)}", flush=True)


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def _cli(argv: list[str]) -> tuple[str, float]:
    """``tempest_tpu.app.cli.main(argv)`` with its standard output
    captured; a non-zero return raises.  Returns (output, seconds)."""
    from tempest_tpu.app.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} returned {rc}:\n{buf.getvalue()}")
    return buf.getvalue(), dt


def _field(text: str, label: str) -> str:
    m = re.search(rf"^{re.escape(label)}\s*:\s*(.+)$", text, re.M)
    if m is None:
        raise RuntimeError(f"no '{label}' line in:\n{text}")
    return m.group(1).strip()


def truth_image(mode) -> np.ndarray:
    """The synthetic screen every phase transmits for ``mode`` (a
    ``VideoMode``), at the render size."""
    import jax.numpy as jnp

    from tempest_tpu.io.synthetic import render_frame
    from tempest_tpu.ops.resample import downgrade_image

    return np.asarray(downgrade_image(jnp.asarray(render_frame(mode))))


def _psnr(truth: np.ndarray, img) -> float:
    from tempest_tpu.render.screen import aligned_psnr

    img = np.asarray(img, np.float32)
    if not np.all(np.isfinite(img)):
        raise RuntimeError("reconstruction has non-finite values")
    return float(aligned_psnr(truth, img)[0])


def _check_psnr(what: str, value: float, floor: float = PSNR_FLOOR_DB) -> None:
    if not value >= floor:
        raise RuntimeError(f"{what}: aligned PSNR {value:.2f} dB < {floor} dB")


def int16_words(iq: np.ndarray, scale: float = 8192.0) -> np.ndarray:
    """Complex samples as interleaved int16 I/Q words (the SDR wire format)."""
    w = np.ascontiguousarray(iq, np.complex64).view(np.float32) * scale
    return np.clip(np.rint(w), -32768, 32767).astype(np.int16)


# ------------------------------------------------------------------ phases

def phase_offline(workdir: str, mode_name: str, fs: float, seconds: float,
                  seed: int = 0) -> dict:
    """A1: synth -> analyze -> reconstruct through ``cli.main``."""
    from tempest_tpu.render.screen import read_png
    from tempest_tpu.video.modes import ALL_VIDEO_MODES

    mode = ALL_VIDEO_MODES[mode_name]
    cap = os.path.join(workdir, "capture.dat")
    png = os.path.join(workdir, "screen.png")
    fs_s = repr(float(fs))
    _, t_synth = _cli(["synth", "--mode", mode_name, "--fs", fs_s,
                         "--seconds", str(seconds), "--seed", str(seed),
                         "--out", cap])
    an_cold_out, an_cold = _cli(["analyze", cap, "--fs", fs_s])
    an_out, an_warm = _cli(["analyze", cap, "--fs", fs_s])
    detected = _field(an_out, "closest mode")
    refresh = float(_field(an_out, "refresh rate").split()[0])
    if detected != mode_name or _field(an_cold_out, "closest mode") != mode_name:
        raise RuntimeError(f"analyze detected {detected!r}, not {mode_name!r}")
    if abs(refresh - mode.refresh) > REFRESH_TOL_HZ:
        raise RuntimeError(f"analyze refresh {refresh} Hz is off {mode.refresh} "
                           f"by more than {REFRESH_TOL_HZ} Hz")
    _, rec_cold = _cli(["reconstruct", cap, "--fs", fs_s, "--out", png])
    rec_out, rec_warm = _cli(["reconstruct", cap, "--fs", fs_s, "--out", png])
    if mode_name not in _field(rec_out, "detected mode"):
        raise RuntimeError(f"reconstruct locked to {_field(rec_out, 'detected mode')}")
    p = _psnr(truth_image(mode), read_png(png))
    _check_psnr("offline reconstruct", p)
    return {
        "ran": f"cli synth ({int(fs * seconds)} samples) + analyze + reconstruct",
        "mode": detected, "refresh_hz": refresh,
        "refresh_err_mhz": 1e3 * abs(refresh - mode.refresh),
        "reconstruct": rec_out.strip().splitlines()[-1],
        "aligned_psnr_db": p,
        "synth_s": t_synth,
        "analyze_cold_s": an_cold, "analyze_warm_s": an_warm,
        "reconstruct_cold_s": rec_cold,
        "reconstruct_warm_s": rec_warm,
    }


def phase_streaming(mode_name: str, fs: float, block_seconds: float,
                    n_blocks: int, fidelity: bool, seed: int = 0) -> dict:
    """A2: ``StreamingRuntime`` on a ``SyntheticSource`` with its producer
    thread, as ``cli stream --source synthetic`` runs it."""
    import jax

    from tempest_tpu.runtime.sources import SyntheticSource
    from tempest_tpu.runtime.stream import StreamingRuntime
    from tempest_tpu.video.modes import ALL_VIDEO_MODES

    mode = ALL_VIDEO_MODES[mode_name]
    src = SyntheticSource(mode, fs, int(fs * block_seconds), seed=seed)
    rt = StreamingRuntime(src, mode, fidelity=fidelity)
    rt.start()
    try:
        t0 = time.perf_counter()
        jax.block_until_ready(rt.process_blocks(1))
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = rt.process_blocks(n_blocks)
        warm = (time.perf_counter() - t0) / n_blocks
        health = rt.health()
    finally:
        rt.stop()
    if rt.frames_out != (n_blocks + 1) * rt.config.n_frames:
        raise RuntimeError(f"{rt.frames_out} frames out of {n_blocks + 1} blocks")
    if health["producer_error"]:
        raise RuntimeError(f"producer failed: {health['producer_error']}")
    p = _psnr(truth_image(mode), img)
    _check_psnr(f"streaming fidelity={fidelity}", p)
    c = rt.config
    return {
        "ran": (f"StreamingRuntime fidelity={fidelity}: {n_blocks + 1} blocks "
                f"of {src.block_size} samples, {c.n_frames} frames/block, "
                f"resampler={c.resampler} sync={c.do_align} "
                f"subpixel={c.align_subpixel} exact_cuts={c.subsample_align} "
                f"einsum_bf16={c.einsum_bf16}"),
        "aligned_psnr_db": p,
        "first_block_cold_s": cold,
        # The producer fills the ring while the first block compiles, so
        # the warm blocks are already waiting: device + host loop only.
        "warm_s_per_block": warm,
        "health": health,
    }


def judged_config(mode_name: str, fs: float, n_frames: int, phase_bins: int):
    """bench.py's judged step configuration."""
    from tempest_tpu.pipeline.offline import ReconstructionConfig
    from tempest_tpu.video.modes import ALL_VIDEO_MODES

    return ReconstructionConfig(
        sample_rate=fs, mode=ALL_VIDEO_MODES[mode_name], n_frames=n_frames,
        input_format="iq_interleaved", carry_phase=True, subsample_align=True,
        do_align=True, align_subpixel=True, resampler="mxu3",
        phase_bins=phase_bins, einsum_bf16=True)


def phase_judged(config, words: np.ndarray, trace_dir: str,
                 warm_blocks: int = 3) -> dict:
    """A3: the judged step on device-resident int16 words: cold and warm
    block times, compiled memory, peak device memory, stage times."""
    import jax
    import jax.numpy as jnp

    from tempest_tpu.pipeline.offline import STAGES, make_reconstruct_fn
    from tempest_tpu.utils.profiling import profile_stages

    step = make_reconstruct_fn(config)
    n = config.block_samples
    iq = jax.device_put(words[: 2 * n])
    ema0 = jnp.zeros(config.render_size, jnp.float32)
    alpha = jnp.float32(0.1)
    t0 = time.perf_counter()
    first = step(iq, ema0, alpha, 0.0)
    jax.block_until_ready(first)
    cold = time.perf_counter() - t0
    p = _psnr(truth_image(config.mode), first[0])
    _check_psnr("judged step", p)
    phases = [(-i * n) % config.samples_per_frame for i in range(1, warm_blocks + 1)]
    for ph in phases:  # upload each phase bin's tables once
        jax.block_until_ready(step(iq, ema0, alpha, ph))
    e = first[0]
    t0 = time.perf_counter()
    for ph in phases:
        e, *_ = step(iq, e, alpha, ph)
    jax.block_until_ready(e)
    warm = (time.perf_counter() - t0) / warm_blocks
    mem = step.lower(iq, ema0, alpha, 0.0).compile().memory_analysis()
    stages = profile_stages(step.lower(iq, e, alpha, phases[0]),
                            step.args(iq, e, alpha, phases[0]), trace_dir,
                            STAGES, module="_table_step")
    dev = jax.devices()[0]
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    return {
        "ran": (f"judged step: {config.n_frames} frames, phase_bins="
                f"{config.phase_bins}, {n} samples/block, int16 ingest"),
        "aligned_psnr_db": p,
        "cold_s": cold, "warm_ms_per_block": 1e3 * warm,
        "warm_msamples_per_s": n / warm / 1e6,
        "memory_analysis": {k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")} if mem is not None else None,
        "peak_bytes_in_use": peak,
        "stage_ms_one_block": {k: (1e3 * v if k != "events" else v)
                               for k, v in stages.items()},
    }


def phase_agreement(name: str, config, iq: np.ndarray, tol_max: float,
                    alpha: float = 0.1) -> dict:
    """D: the timed step against (i) the same configuration at precision
    "highest" with an f32 weights einsum and (ii) the plain gather
    resampler at "highest", on the same block (carry phase 0)."""
    import jax
    import jax.numpy as jnp

    from tempest_tpu.pipeline.offline import make_reconstruct_fn

    truth = truth_image(config.mode)
    ema0 = jnp.zeros(config.render_size, jnp.float32)
    a = jnp.float32(alpha)
    block = jnp.asarray(iq)

    def run(cfg):
        ema, _, sync, _ = make_reconstruct_fn(cfg)(block, ema0, a, 0.0)
        return np.asarray(ema), np.asarray(sync)

    timed, sync_t = run(config)
    with jax.default_matmul_precision("highest"):
        oracle, sync_o = run(dataclasses.replace(config, einsum_bf16=False))
        gather, _ = run(dataclasses.replace(config, resampler="gather",
                                            einsum_bf16=False))
    span = float(oracle.max() - oracle.min())
    d = np.abs(timed - oracle) / span
    p_t, p_o, p_g = _psnr(truth, timed), _psnr(truth, oracle), _psnr(truth, gather)
    rec = {
        "ran": f"{name}: timed vs highest-precision oracle vs gather reference",
        "max_abs_diff_over_range": float(d.max()),
        "mean_abs_diff_over_range": float(d.mean()),
        "tol_max_abs_diff_over_range": tol_max,
        "max_sync_diff_px": float(np.abs(sync_t - sync_o).max()),
        "psnr_timed_db": p_t, "psnr_oracle_db": p_o,
        "psnr_gather_db": p_g,
        "tol_psnr_oracle_db": TOL_PSNR_ORACLE_DB,
        "tol_psnr_gather_db": TOL_PSNR_GATHER_DB,
    }
    if not (d.max() <= tol_max and abs(p_t - p_o) <= TOL_PSNR_ORACLE_DB
            and abs(p_t - p_g) <= TOL_PSNR_GATHER_DB):
        raise RuntimeError(f"agreement outside tolerance: {rec}")
    return rec


def phase_wideband(workdir: str, mode_name: str, fs: float, seconds: float,
                   harmonics: str, seed: int = 0) -> dict:
    """A4: the wideband quick start — synth --harmonics, scan,
    reconstruct --combine all (the capture FFT channeliser): every
    harmonic found and fused."""
    from tempest_tpu.render.screen import read_png
    from tempest_tpu.video.modes import ALL_VIDEO_MODES

    cap = os.path.join(workdir, "wide.dat")
    png = os.path.join(workdir, "wide.png")
    fs_s = repr(float(fs))
    _cli(["synth", "--mode", mode_name, "--fs", fs_s, "--seconds", str(seconds),
          "--seed", str(seed), f"--harmonics={harmonics}", "--out", cap])
    n_harmonics = len(harmonics.split(","))
    _, scan_cold = _cli(["scan", cap, "--fs", fs_s])
    scan_out, scan_warm = _cli(["scan", cap, "--fs", fs_s])
    m = re.search(r"^emissions\s*:\s*(\d+) distinct", scan_out, re.M)
    if m is None or int(m.group(1)) != n_harmonics:
        raise RuntimeError(f"scan did not find {n_harmonics} emissions:\n{scan_out}")
    rec = ["reconstruct", cap, "--fs", fs_s, "--combine", "all", "--out", png]
    _, rec_cold = _cli(rec)
    rec_out, rec_warm = _cli(rec)
    screens = re.findall(r"^screen \d+: (.+?) \(fv=([\d.]+) Hz\), (\d+) carrier",
                         rec_out, re.M)
    if (not screens or screens[0][0] != mode_name
            or int(screens[0][2]) != n_harmonics):
        raise RuntimeError(f"combine all did not fuse {n_harmonics} carriers "
                           f"of {mode_name!r}:\n{rec_out}")
    out_png = png if len(screens) == 1 else png.replace(".png", "_1.png")
    p = _psnr(truth_image(ALL_VIDEO_MODES[mode_name]), read_png(out_png))
    _check_psnr("wideband combine", p)
    return {
        "ran": (f"cli synth --mode '{mode_name}' --harmonics={harmonics} "
                f"({int(fs * seconds)} samples @ {fs / 1e6:g} Msps) + scan + "
                f"reconstruct --combine all"),
        "emissions": int(m.group(1)),
        "screens": [{"mode": s[0], "refresh_hz": float(s[1]), "carriers": int(s[2])}
                    for s in screens],
        "aligned_psnr_db": p,
        "scan_cold_s": scan_cold, "scan_warm_s": scan_warm,
        "reconstruct_cold_s": rec_cold,
        "reconstruct_warm_s": rec_warm,
    }


def phase_mesh(devices: list, mode_name: str, fs: float, span_seconds: float,
               n_dispatch: int = 2, seed: int = 0) -> dict:
    """E: ``MeshStreamingRuntime`` over ``devices`` (the path behind
    ``cli stream --mesh N``) against the one-card ``StreamingRuntime`` fed
    the same stream in span-sized blocks, and the sharded mode search
    against the one-card static-table search.  The rings are fed directly
    from one seeded capture so both runtimes see identical samples."""
    import jax
    from jax.sharding import Mesh

    from tempest_tpu.io.synthetic import generate_iq
    from tempest_tpu.parallel.sharded import mode_search_static, sharded_mode_search
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime
    from tempest_tpu.runtime.sources import SyntheticSource
    from tempest_tpu.runtime.stream import StreamingRuntime
    from tempest_tpu.video.modes import ALL_VIDEO_MODES, candidate_modes

    mode = ALL_VIDEO_MODES[mode_name]
    n_sh = len(devices)
    mesh = Mesh(np.array(devices), ("blocks",))
    S = int(fs * span_seconds)
    sig = generate_iq(mode, fs, (n_dispatch + 1) * n_sh * S, snr_db=20.0,
                      seed=seed).iq

    def feed(rt, block, count):
        for t in range(count):
            rt.ring.put(np.ascontiguousarray(sig[t * block:(t + 1) * block]))

    mrt = MeshStreamingRuntime(SyntheticSource(mode, fs, n_sh * S), mode, mesh,
                               alpha=0.5)
    feed(mrt, n_sh * S, n_dispatch + 1)
    t0 = time.perf_counter()
    mrt.process_blocks(1)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_m = mrt.process_blocks(n_dispatch - 1)
    warm = (time.perf_counter() - t0) / max(n_dispatch - 1, 1)
    peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
             for d in devices]

    srt = StreamingRuntime(SyntheticSource(mode, fs, S), mode, alpha=0.5)
    feed(srt, S, n_dispatch * n_sh)
    img_s = srt.process_blocks(n_dispatch * n_sh)
    if not mrt.frames_out == srt.frames_out == n_dispatch * n_sh * mrt.config.n_frames:
        raise RuntimeError(f"frames out: mesh {mrt.frames_out}, one card "
                           f"{srt.frames_out}")
    span = float(img_s.max() - img_s.min())
    diff = float(np.abs(img_m - img_s).max() / span)
    p_m = _psnr(truth_image(mode), img_m)

    cands = candidate_modes(mode.refresh, tol_hz=0.5)
    need = 3 * int(np.ceil(fs / mode.refresh))
    t0 = time.perf_counter()
    res_n = sharded_mode_search(sig[:need], fs, mode.refresh, cands, mesh)
    search_s = time.perf_counter() - t0
    with jax.default_device(devices[0]):
        res_1 = mode_search_static(sig[:need], fs, mode.refresh, cands)
        res_1d = sharded_mode_search(sig[:need], fs, mode.refresh, cands,
                                     Mesh(np.array(devices[:1]), ("blocks",)))
    rank = lambda r: [r.names[i] for i in np.argsort(r.scores)[::-1]]
    rec = {
        "ran": (f"MeshStreamingRuntime on {n_sh} cards ({n_dispatch} dispatches "
                f"of {n_sh}x{S} samples, {mrt.config.n_frames} frames/span) vs "
                f"StreamingRuntime on one card; sharded_mode_search over "
                f"{len(cands)} candidates"),
        "mesh_vs_one_card_max_abs_diff_over_range": diff,
        "tol_mesh": TOL_MESH,
        "mesh_aligned_psnr_db": p_m,
        "mesh_first_dispatch_cold_s": cold,
        "mesh_warm_s_per_dispatch": warm,
        "peak_bytes_in_use_per_card": peaks,
        "search_best_n_cards": res_n.names[res_n.best_index],
        "search_best_static_one_card": res_1.names[res_1.best_index],
        "search_top5_n_cards": rank(res_n)[:5],
        "search_top5_static_one_card": rank(res_1)[:5],
        "search_ranking_equal_one_card_same_program": rank(res_n) == rank(res_1d),
        "search_n_cards_s": search_s,
    }
    if diff > TOL_MESH:
        raise RuntimeError(f"mesh EMA differs from one card: {rec}")
    _check_psnr("mesh streaming", p_m)
    if not (rec["search_best_n_cards"] == rec["search_best_static_one_card"]
            == mode_name and rec["search_ranking_equal_one_card_same_program"]):
        raise RuntimeError(f"mode search disagrees: {rec}")
    if min(peaks) < 0.25 * max(peaks) or len({d.id for d in devices}) != n_sh:
        raise RuntimeError(f"mesh work did not spread over {n_sh} cards: {peaks}")
    return rec


# -------------------------------------------------------------------- main

def one_card(workdir: str, trace_dir: str) -> None:
    import jax

    from tempest_tpu.io.synthetic import generate_iq
    from tempest_tpu.runtime.stream import StreamingRuntime
    from tempest_tpu.runtime.sources import SyntheticSource
    from tempest_tpu.video.modes import ALL_VIDEO_MODES

    _say("A1_offline", phase_offline(workdir, MODE, FS, 0.5))
    for fidelity in (False, True):
        _say(f"A2_streaming{'_fidelity' if fidelity else ''}",
             phase_streaming(MODE, FS, 0.1, 8, fidelity))
    jcfg = judged_config(MODE, FS, 36, 64)
    cap = generate_iq(ALL_VIDEO_MODES[MODE], FS, jcfg.block_samples,
                      snr_db=20.0, seed=1).iq
    words = int16_words(cap)
    _say("A3_judged", phase_judged(jcfg, words, trace_dir))
    _say("D_judged", phase_agreement("judged step", jcfg, words, TOL_TF32_BF16))
    mode = ALL_VIDEO_MODES[MODE]
    scfg = StreamingRuntime(SyntheticSource(mode, FS, int(FS * 0.1)), mode).config
    sw = np.ascontiguousarray(cap[: scfg.block_samples]).view(np.float32)
    _say("D_streaming", phase_agreement("default streaming step", scfg, sw,
                                        TOL_TF32))
    _say("A4_wideband", phase_wideband(workdir, WIDE_MODE, WIDE_FS, 0.5,
                                       HARMONICS))
    dev = jax.devices()[0]
    print(f"peak_bytes_in_use after all phases: "
          f"{(dev.memory_stats() or {}).get('peak_bytes_in_use')}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="1: the one-card phases; 4: only the mesh paths")
    args = ap.parse_args(argv)

    from tempest_tpu.utils.compile_cache import configure_compile_cache
    from tempest_tpu.utils.device import card_info, require_gpu

    devs = require_gpu("chip_smoke.py")
    if len(devs) < args.devices:
        raise SystemExit(f"--devices {args.devices}: only {len(devs)} GPU(s)")
    configure_compile_cache()
    print(f"device_kind: {devs[0].device_kind}; count: {len(devs)}", flush=True)
    for line in card_info():
        print(line, flush=True)

    if args.devices > 1:
        import faulthandler

        faulthandler.dump_traceback_later(MESH_TIMEOUT_S, exit=True)
        _say("E_mesh", phase_mesh(devs[: args.devices], MODE, FS, 0.1))
        faulthandler.cancel_dump_traceback_later()
    else:
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as work:
            one_card(work, os.path.join(work, "trace"))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
