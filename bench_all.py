"""Scenario benchmark suite — device scenarios plus host-side scenarios,
one JSON line each (``bench.py`` remains the single-line judged step).

  1. offline AM envelope demod of a capture
  2. FFT autocorrelation refresh+line-rate estimation
  3. resample to the inferred pixel clock for one fixed mode
  4. full chain at 1080p60 (same as bench.py)
  5. sharded multi-hypothesis mode search across all devices
  6. host ring-buffer throughput (python vs native C++)
  7. streaming host loop end-to-end (source -> ring -> device -> EMA)

Runs on the GPU by default and fails without one (no CPU fallback); run
with ``--device cpu`` to exercise everything on the host's virtual 8-device
mesh.  Every line names the device it ran on (``device``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _fence(x) -> None:
    np.asarray(x).ravel()[:1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="gpu", choices=["gpu", "cpu"])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--fs", type=float, default=20e6)
    args = ap.parse_args()

    import os

    if args.device == "cpu":
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from tempest_tpu.utils.compile_cache import configure_compile_cache
    from tempest_tpu.utils.device import device_record, require_gpu

    if args.device == "gpu":
        require_gpu("bench_all.py --device gpu")
    configure_compile_cache()

    from tempest_tpu.ops.autocorr import autocorrelation, estimate_line_count, estimate_refresh
    from tempest_tpu.ops.demod import am_envelope_from_iq
    from tempest_tpu.ops.resample import frame_to_screen_rows
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.parallel.sharded import sharded_mode_search
    from tempest_tpu.pipeline.offline import ReconstructionConfig, make_reconstruct_fn
    from tempest_tpu.video.modes import ALL_VIDEO_MODES, candidate_modes

    fs = args.fs
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    rng = np.random.default_rng(0)
    results = []

    def bench(metric: str, fn, samples_per_iter: int, baseline_msps: float = 20.0):
        fn()  # compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        dt = time.perf_counter() - t0
        msps = samples_per_iter * args.iters / dt / 1e6
        results.append(
            {
                "metric": metric,
                "value": round(msps, 2),
                "unit": "Msamples/s/chip",
                "vs_baseline": round(msps / baseline_msps, 2),
            }
        )

    # 1. envelope demod of int16 IQ
    n = 2_000_000
    words = jax.device_put(rng.integers(-16384, 16384, 2 * n, dtype=np.int16))
    demod = jax.jit(am_envelope_from_iq)

    bench("AM envelope demod (int16 ingest)", lambda: _fence(demod(words)[:8]), n)

    # 2. autocorrelation + timing estimation over 0.1 s
    n2 = int(fs * 0.2)
    env = jax.device_put(rng.random(n2).astype(np.float32))

    @jax.jit
    def timing(e):
        gamma, _ = autocorrelation(e, fs, 0.0, 0.1)
        fv = estimate_refresh(gamma, fs)
        return fv, estimate_line_count(gamma, fs, fv)

    bench("autocorrelation timing estimation", lambda: _fence(timing(env)[0]), n2)

    # 3. resample one frame to the screen (rows variant)
    frame_len = int(fs / 60.0)
    sig = jax.device_put(rng.random(frame_len).astype(np.float32))
    res = jax.jit(lambda s: frame_to_screen_rows(s, mode.height, mode.width))
    bench("signal->screen resample (1 frame)", lambda: _fence(res(sig)[:1, :8]), frame_len)

    # 4. full chain (bench.py's metric)
    cfg = ReconstructionConfig(
        sample_rate=fs, mode=mode, n_frames=6, input_format="iq_interleaved"
    )
    step = make_reconstruct_fn(cfg)
    iq = jax.device_put(rng.integers(-16384, 16384, 2 * cfg.block_samples, dtype=np.int16))
    ema0 = jnp.zeros(cfg.render_size, jnp.float32)

    # Chain iterations through the EMA carry and fence once (bench.py's
    # methodology) — per-iteration fences would charge a host round trip
    # to every block.
    def full_chained():
        e = ema0
        for _ in range(args.iters):
            e, *_ = step(iq, e, jnp.float32(0.1))
        _fence(e[:1, :8])

    full_chained()  # compile
    t0 = time.perf_counter()
    full_chained()
    dt = time.perf_counter() - t0
    msps = cfg.block_samples * args.iters / dt / 1e6
    results.append(
        {
            "metric": "full chain 1080p60",
            "value": round(msps, 2),
            "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 20.0, 2),
        }
    )

    # 4b. multi-stream batched serving: B independent IQ channels through one
    # vmapped step (production serving batching; aggregate Msps).
    from tempest_tpu.pipeline.offline import make_batched_reconstruct_fn

    bsz = 4
    bstep = make_batched_reconstruct_fn(cfg)
    biq = jax.device_put(
        rng.integers(-16384, 16384, (bsz, 2 * cfg.block_samples), dtype=np.int16)
    )
    bema0 = jnp.zeros((bsz, *cfg.render_size), jnp.float32)

    def batched_chained():
        e = bema0
        for _ in range(args.iters):
            e, *_ = bstep(biq, e, jnp.float32(0.1))
        _fence(e[:1, :1, :8])

    batched_chained()  # compile
    t0 = time.perf_counter()
    batched_chained()
    dt = time.perf_counter() - t0
    msps = bsz * cfg.block_samples * args.iters / dt / 1e6
    results.append(
        {
            "metric": f"batched serving x{bsz} streams 1080p60 (aggregate)",
            "value": round(msps, 2),
            "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 20.0, 2),
        }
    )

    # 4c. streaming fidelity chain: carry-phase sub-sample-exact cuts via the
    # phase-quantised bin tables (StreamingRuntime fidelity=True's program).
    cfg_f = ReconstructionConfig(
        sample_rate=fs, mode=mode, n_frames=6, input_format="iq_interleaved",
        carry_phase=True, subsample_align=True, do_align=False,
        resampler="mxu3", phase_bins=64,
    )
    step_f = make_reconstruct_fn(cfg_f)
    iq_f = jax.device_put(
        rng.integers(-16384, 16384, 2 * cfg_f.block_samples, dtype=np.int16))
    spf = cfg_f.samples_per_frame
    phases = [(-i * cfg_f.block_samples) % spf for i in range(args.iters)]

    def fidelity_chained():
        e = ema0
        for p in phases:
            e, *_ = step_f(iq_f, e, jnp.float32(0.1), p)
        _fence(e[:1, :8])

    fidelity_chained()  # compile + upload bin tables
    fidelity_chained()  # settle (tables now device-cached)
    t0 = time.perf_counter()
    fidelity_chained()
    dt = time.perf_counter() - t0
    msps = cfg_f.block_samples * args.iters / dt / 1e6
    results.append(
        {
            "metric": "streaming fidelity 1080p60 (quantised exact-cut tables)",
            "value": round(msps, 2),
            "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 20.0, 2),
        }
    )

    # 4c. live-combine front: channelise + MRC-fuse K=3 carriers of one
    # wideband block (ops.combine.combine_core — what StreamingRuntime runs
    # per block before the chain when `combine` is on).  Chained through a
    # carried accumulator so one fence covers all iterations.
    from tempest_tpu.ops.combine import combine_core
    from tempest_tpu.ops.scan import _channel_geometry

    n_wide = 1 << 22
    _, m_chan, fs_chan = _channel_geometry(n_wide, fs, 4e6)
    words_w = jax.device_put(
        rng.standard_normal(2 * n_wide).astype(np.float32))

    @jax.jit
    def combine_front(w, acc):
        env, *_ = combine_core(w, fs, (-6e6, 1.5e6, 7e6), 4e6, fs_chan,
                               min(0.1, 0.25 * m_chan / fs_chan),
                               55.0, 65.0, "mrc")
        return 0.5 * acc + env

    def combine_chained():
        acc = jnp.zeros(m_chan, jnp.float32)
        for _ in range(args.iters):
            acc = combine_front(words_w, acc)
        _fence(acc[:8])

    combine_chained()  # compile
    t0 = time.perf_counter()
    combine_chained()
    dt = time.perf_counter() - t0
    msps = n_wide * args.iters / dt / 1e6
    results.append(
        {
            "metric": "live-combine front (K=3 channelise + MRC fusion)",
            "value": round(msps, 2),
            "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 20.0, 2),
        }
    )

    # 5. sharded mode search (all devices)
    mesh = make_mesh()
    cands = candidate_modes(60.0, tol_hz=0.5)
    search_sig = rng.random(2 * frame_len + 8).astype(np.float32)

    def search():
        sharded_mode_search(search_sig, fs, 60.0, cands, mesh, n_frames=1)

    bench(
        f"sharded mode search ({len(cands)} candidates, {mesh.devices.size} dev)",
        search,
        2 * frame_len,
    )

    # 6. host ring throughput (python vs native C++) — host-side real-time
    # headroom for the producer path (no reference equivalent measured).
    from tempest_tpu.runtime.ring import RingBuffer

    block = 1 << 20  # 1M complex samples
    data = (rng.standard_normal(block) + 1j * rng.standard_normal(block)).astype(
        np.complex64
    )
    out = np.empty(block, np.complex64)

    def ring_bench(ring, label):
        n_iter = 50
        t0 = time.perf_counter()
        for _ in range(n_iter):
            ring.put(data)
            ring.take(out)
        dt = time.perf_counter() - t0
        msps = block * n_iter / dt / 1e6
        results.append(
            {
                "metric": f"host ring put+take ({label})",
                "value": round(msps, 1),
                "unit": "Msamples/s",
                "vs_baseline": round(msps / 20.0, 2),
            }
        )

    ring_bench(RingBuffer(block, 4), "python")
    try:
        from tempest_tpu.native import NativeRing

        ring_bench(NativeRing(block, 4), "C++ native")
    except Exception:
        pass

    # 7. streaming host loop END-TO-END: source -> producer thread -> ring ->
    # jitted chain -> EMA, as a system (the device chain and the ring are
    # measured in isolation above; this is what a live session actually
    # sustains).  The reference self-measures exactly this surface
    # (AtomicAbstractSDRs.jl:333-341 producer/consumer MS/s, GUI.jl:201-203
    # FPS).  Each block pays its host->device upload here.
    from tempest_tpu.runtime.stream import StreamingRuntime

    class _MemSource:
        """Pregenerated in-memory blocks: producer cost = one memcpy, so the
        measurement charges the loop, not synthetic signal generation."""

        sample_rate = fs

        def __init__(self, blocks: np.ndarray) -> None:
            self._blocks = blocks
            self._i = 0
            self.block_size = blocks.shape[1]

        def read(self, out: np.ndarray) -> None:
            np.copyto(out, self._blocks[self._i % len(self._blocks)])
            self._i += 1

        def close(self) -> None:
            pass

    blk = int(fs * 0.15)
    src_blocks = (rng.standard_normal((2, blk))
                  + 1j * rng.standard_normal((2, blk))).astype(np.complex64)
    rt = StreamingRuntime(_MemSource(src_blocks), mode, alpha=0.1)
    rt.start()
    try:
        rt.process_blocks(2)          # compile + settle
        n_loop = max(args.iters, 8)
        t0 = time.perf_counter()
        rt.process_blocks(n_loop)
        dt = time.perf_counter() - t0
    finally:
        rt.stop()
    msps = n_loop * blk / dt / 1e6
    results.append(
        {
            "metric": "streaming host loop 1080p60 (source->ring->device->EMA)",
            "value": round(msps, 2),
            "unit": "Msamples/s/chip",
            "vs_baseline": round(msps / 20.0, 2),
            "blocks_per_s": round(n_loop / dt, 2),
            "realtime_factor": round(msps * 1e6 / fs, 3),
            "note": "per-block host->device upload included",
        }
    )

    # 8. MESH streaming host loop: the same end-to-end system with the
    # per-block step spanning the device mesh (MeshStreamingRuntime: time
    # spans + ppermute halos + one-block lookahead) over every visible
    # device, runnable on the virtual CPU mesh (--device cpu) and collapsing
    # to one shard on a one-card host.
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime

    n_dev = mesh.devices.size
    blk_m = (blk // n_dev) * n_dev
    mrt = MeshStreamingRuntime(
        _MemSource(src_blocks[:, :blk_m]), mode, mesh, alpha=0.1)
    mrt.start()
    try:
        mrt.process_blocks(2)         # compile + settle (+1 lookahead)
        n_loop = max(args.iters, 8)
        t0 = time.perf_counter()
        mrt.process_blocks(n_loop)
        dt = time.perf_counter() - t0
    finally:
        mrt.stop()
    msps = n_loop * blk_m / dt / 1e6
    results.append(
        {
            "metric": f"mesh streaming host loop 1080p60 ({n_dev} shards)",
            "value": round(msps, 2),
            "unit": "Msamples/s",
            "vs_baseline": round(msps / 20.0, 2),
            "blocks_per_s": round(n_loop / dt, 2),
            "realtime_factor": round(msps * 1e6 / fs, 3),
        }
    )

    device = device_record()
    for r in results:
        print(json.dumps({**r, "device": device}))


if __name__ == "__main__":
    main()
