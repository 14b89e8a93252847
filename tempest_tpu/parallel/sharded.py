"""Multi-device pipelines: time-block data parallelism with halo exchange,
cross-shard frame averaging, and sharded video-mode hypothesis search.

This is the multi-device generalisation of the reference's 3-thread pipeline
(SURVEY.md §2): instead of producer/consumer threads around a lock-based ring
buffer, the IQ timeline is laid out as ``(n_shards, samples_per_shard)`` and
sharded across the ``"blocks"`` mesh axis.  Each device reconstructs the frames
inside its shard; the only cross-device traffic is

* a *halo exchange* (``lax.ppermute``) handing each device the first
  ``overlap`` samples of its right neighbour, so frame cuts that straddle a
  shard boundary see contiguous signal (overlap-save; SURVEY.md §5
  "long-context/sequence parallelism" — the reference instead cuts frames
  buffer-aligned and drifts, ``GUI.jl:165-166``), and
* an EMA *combine*: the exponential average is a linear recurrence
  ``e' = α e + (1-α) f``, so a shard of k frames acts on the carried image as
  ``e' = A e + B`` with ``A = α^k`` and ``B`` the shard's zero-initialised
  EMA.  Shards compose associatively in time order; we ``all_gather`` the
  per-shard ``(A, B)`` (one image each) and fold — O(log) depth collective +
  n tiny fmas, instead of serialising all frames through one device.

The mode search shards *candidate video modes* instead of time: every device
scores a slice of the hypothesis set on the same signal using the
dynamic-geometry resampler, and one ``argmax`` over the gathered scores picks
the mode — automating what the reference leaves to a human click on the
correlation plot (``GUI.jl:512-523``).
"""

from __future__ import annotations

import dataclasses
import functools as _functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.demod import am_demod, am_envelope_from_iq
from ..ops.framesync import frame_sync
from ..ops.resample import RENDER_SIZE, frame_to_screen_dynamic
from ..pipeline.offline import (
    ReconstructionConfig,
    demodulate,
    ema_fold,
    process_frames,
)
from ..video.modes import VideoMode

__all__ = [
    "sharded_reconstruct_fn",
    "sharded_streaming_reconstruct_fn",
    "sharded_batched_reconstruct_fn",
    "sharded_mode_search",
    "sharded_mode_search_2d",
    "sharded_scan_band",
    "sharded_combine_harmonics",
    "sharded_combined_reconstruct_fn",
    "mode_search_static",
    "ModeSearchResult",
]


def sharded_batched_reconstruct_fn(
    config: ReconstructionConfig,
    mesh: Mesh,
    axis: str = "blocks",
):
    """Serving parallelism: B independent IQ streams (different carriers,
    antennas, targets), batch axis sharded across the mesh — each device
    runs the full single-stream chain on its slice of the streams, with no
    cross-device traffic at all (embarrassingly parallel; contrast
    :func:`sharded_reconstruct_fn`, which splits ONE stream's timeline and
    needs halo + EMA-combine collectives).

    Returns ``step(iq[B, ...], ema[B, h, w], alpha)`` like
    ``make_batched_reconstruct_fn``; B must be a multiple of the mesh size.
    No reference counterpart (it is a single-stream desktop app).
    """
    from ..pipeline.offline import make_batched_reconstruct_fn

    inner = make_batched_reconstruct_fn(config)
    stream = NamedSharding(mesh, P(axis))       # leading stream axis sharded
    repl = NamedSharding(mesh, P())
    out_sh = (stream, stream, stream, stream)

    if config.carry_phase:
        # Per-stream fractional frame phase rides the stream axis too.
        def step(iq, ema, alpha, phase):
            iq = jax.lax.with_sharding_constraint(iq, stream)
            ema = jax.lax.with_sharding_constraint(ema, stream)
            return inner(iq, ema, alpha, phase)

        return jax.jit(
            step,
            in_shardings=(stream, stream, repl, stream),
            out_shardings=out_sh,
        )

    def step(iq, ema, alpha):
        iq = jax.lax.with_sharding_constraint(iq, stream)
        ema = jax.lax.with_sharding_constraint(ema, stream)
        return inner(iq, ema, alpha)

    return jax.jit(
        step,
        in_shardings=(stream, stream, repl),
        out_shardings=out_sh,
    )


def sharded_reconstruct_fn(
    config: ReconstructionConfig,
    mesh: Mesh,
    axis: str = "blocks",
):
    """Build the jitted multi-chip reconstruction step.

    Returns ``step(iq_shards, ema, alpha)`` with ``iq_shards`` of shape
    ``(n_shards, shard_samples)`` sharded over ``axis`` — consecutive,
    *non-overlapping* spans of the IQ timeline (the halo travels between
    devices, the host never duplicates samples).  ``n_shards`` must equal the mesh axis
    size.  The timeline is treated as circular (file replay loops), so the
    last shard's halo wraps to the first — matching the ``:radiosim``
    steady state.

    Per shard: AM demod → *phase-exact* fractional frame cuts (each shard's
    start table is derived from its absolute position on the global frame
    grid, so the cuts are bit-identical to the single-chip carry-phase
    streaming path fed the same consecutive blocks) → fused resample to the
    render size → frame sync → align → local EMA; then the (A, B) EMA combine
    across shards.  Output: (ema_image, frames, sync, score) with
    frames/sync/score sharded over the leading axis.
    """
    n_shards = mesh.shape[axis]
    fs = config.sample_rate
    mode = config.mode
    n_frames = config.n_frames  # frames *per shard*
    h, w = config.render_size
    spf = fs / mode.refresh
    frame_len = int(np.floor(spf))
    # Phase-exact cuts: the global frame grid ticks at multiples of spf from
    # stream start (the same grid the single-chip carry-phase streaming path
    # uses, pipeline/offline.py make_reconstruct_fn).  Shard d starts at
    # absolute sample d*shard_samples, so its fractional offset to the next
    # grid boundary is (-d*S) % spf — computed host-side at trace time (S is
    # a static shape) and handed to each shard as its private start table.
    shard_samples_min = int(np.ceil(n_frames * spf))
    # What the single-chip carry-phase streaming step consumes per block —
    # the shard's extended window (own span + halo) is sized to exactly this,
    # so the two paths see byte-identical signal windows (same edge-padding
    # behaviour inside the resampler included).
    block_need = dataclasses.replace(
        config, carry_phase=True
    ).block_samples

    def _frame_starts(shard_samples: int) -> np.ndarray:
        phases = (-(np.arange(n_shards, dtype=np.float64) * shard_samples)) % spf
        return np.floor(
            phases[:, None] + spf * np.arange(n_frames, dtype=np.float64)[None, :]
            + 0.5
        ).astype(np.int32)

    @jax.jit
    def step(iq_shards, ema, alpha):
        shard_samples = int(iq_shards.shape[1])
        if shard_samples < shard_samples_min:
            raise ValueError(
                f"shards have {shard_samples} samples; need ≥ "
                f"{shard_samples_min} for {n_frames} frames"
            )
        overlap = max(block_need - shard_samples, 1)
        if overlap > shard_samples:
            raise ValueError(
                f"halo ({overlap}) exceeds the shard ({shard_samples}); "
                f"use larger shards or fewer frames per shard"
            )
        fstarts = jnp.asarray(_frame_starts(shard_samples))

        def local_step(iq_local, fstarts_local, ema, alpha):
            # iq_local: (1, shard_samples) — this shard's span of the timeline.
            sig = iq_local[0]
            # Halo exchange: receive the start of the right neighbour
            # (circular: the last shard wraps to the stream head).
            halo = sig[:overlap]
            perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
            halo_from_right = jax.lax.ppermute(halo, axis, perm)
            ext = jnp.concatenate([sig, halo_from_right])

            env = demodulate(ext, config)
            frames, sync, score = process_frames(
                env, fstarts_local[0], config, frame_len
            )

            # Local EMA from zero → B; decay over the shard → A = alpha^k.
            zero = jax.lax.pcast(
                jnp.zeros((h, w), jnp.float32), (axis,), to="varying"
            )
            b_local = ema_fold(zero, frames, alpha)
            a_local = alpha ** n_frames

            # Compose shards in time order: e_d = A_d e_{d-1} + B_d.
            b_all = jax.lax.all_gather(b_local, axis)      # (n_shards, h, w)
            ema_out = ema
            for d in range(n_shards):
                ema_out = a_local * ema_out + b_all[d]
            return ema_out[None], frames[None], sync[None], score[None]

        shard_step = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
        )
        ema_shards, frames, sync, score = shard_step(iq_shards, fstarts, ema, alpha)
        # Every shard computed the same fold; take the first replica.
        return ema_shards[0], frames.reshape(-1, h, w), sync.reshape(-1, 2), score.reshape(-1)

    step.n_shards = n_shards
    step.shard_samples_min = shard_samples_min
    return step


def sharded_streaming_reconstruct_fn(
    config: ReconstructionConfig,
    mesh: Mesh,
    shard_samples: int,
    axis: str = "blocks",
):
    """The LIVE multi-chip reconstruction step: one source block split into
    ``n_shards`` consecutive time spans, with the carried frame phase as a
    per-shard traced input — the step a :class:`MeshStreamingRuntime` feeds
    block-after-block from the host ring (the reference's live 3-stage
    pipeline, ``GUI.jl:380-382``, at the BASELINE 8-chip target's shape).

    Differences from :func:`sharded_reconstruct_fn` (the batch-shaped step):

    * **Carry phase.** Frame cuts tick on the global grid (multiples of
      ``spf`` from stream start).  The host passes each shard's fractional
      offset to its next grid boundary (``phases[d] = (-(abs_pos + d·S)) %
      spf``, computed in float64 host-side exactly like the single-chip
      carry-phase runtime) — consecutive blocks continue the grid instead
      of re-anchoring at zero.
    * **True continuation tail.** The last shard's halo cannot come from a
      neighbour (its right neighbour is the NEXT block), so the step takes
      the next block's first ``overlap`` samples as a replicated ``tail``
      input; shards 0..n-2 still receive their halo from their neighbour
      (``lax.ppermute``).  No circular wrap, no phase shear at block
      boundaries.

    Semantics are exactly "the single-chip carry-phase streaming step on
    ``shard_samples``-sized blocks, ``n_shards`` of them at a time": same
    per-span frame count, same grid, same cut windows — so a mesh runtime
    and the single-chip runtime fed the same stream produce the same EMA
    (parity-tested).

    ``config.input_format`` may be ``"iq_interleaved"`` (rows of
    ``2·shard_samples`` float32 words — the real device boundary) or
    ``"envelope"``.  Returns ``step(rows, tail, ema, alpha, phases)`` with
    ``rows (n_shards, u·S)``, ``tail (u·overlap,)``, ``phases (n_shards,)``
    float32; jit ``in_shardings`` place host arrays directly (rows/phases
    sharded over ``axis``, the rest replicated).  ``step.overlap`` and
    ``step.n_frames`` expose the geometry."""
    if not config.carry_phase:
        raise ValueError("sharded_streaming_reconstruct_fn needs "
                         "config.carry_phase=True (the streaming grid)")
    if config.input_format not in ("iq_interleaved", "envelope"):
        raise ValueError("streaming mesh step takes 'iq_interleaved' or "
                         "'envelope' rows (real device boundaries)")
    sub = config.subsample_align
    # Quantised-table FIDELITY chain on the mesh: per-shard phases select
    # per-shard bins host-side (same quantisation as the single-chip
    # fidelity step); ALL bins' grouping tables live device-resident as
    # (K, F, …) int32 stacks and each shard gathers its own (F, …) slab by
    # traced bin index — the round-3 batched-serving mechanism, per shard.
    quantised = sub and config.resampler == "mxu3" and config.phase_bins > 0
    if sub and not quantised and config.resampler != "gather":
        raise ValueError(
            "mesh streaming subsample_align needs resampler='gather' "
            "(traced fractional offsets) or resampler='mxu3' with "
            "phase_bins>0 (quantised tables at matmul speed)")
    if quantised and config.fuse_demod_cut:
        raise ValueError("fuse_demod_cut is a single-device formulation")
    n_shards = mesh.shape[axis]
    fs = config.sample_rate
    mode = config.mode
    n_frames = config.n_frames           # frames per shard
    h, w = config.render_size
    spf = fs / mode.refresh
    frame_len = int(np.floor(spf))
    u = 2 if config.input_format == "iq_interleaved" else 1
    S = int(shard_samples)
    block_need = config.block_samples    # single-chip window for n_frames
    overlap = max(block_need - S, 1)
    if overlap > S:
        raise ValueError(
            f"halo ({overlap}) exceeds the shard ({S}); use larger shards "
            f"or fewer frames per shard")

    def _extend(sig, tail):
        """This shard's span + its halo: from the right neighbour, or — for
        the last shard — the next block's head (the tail)."""
        halo = sig[: u * overlap]
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        halo_from_right = jax.lax.ppermute(halo, axis, perm)
        is_last = jax.lax.axis_index(axis) == n_shards - 1
        return jnp.concatenate([sig, jnp.where(is_last, tail,
                                               halo_from_right)])

    def _ema_compose(ema, frames, alpha):
        """Associative EMA combine, identical to sharded_reconstruct_fn."""
        zero = jax.lax.pcast(
            jnp.zeros((h, w), jnp.float32), (axis,), to="varying"
        )
        b_local = ema_fold(zero, frames, alpha)
        a_local = alpha ** n_frames
        b_all = jax.lax.all_gather(b_local, axis)
        ema_out = ema
        for d in range(n_shards):
            ema_out = a_local * ema_out + b_all[d]
        return ema_out

    row_sh = NamedSharding(mesh, P(axis, None))
    vec_sh = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    if quantised:
        from ..pipeline.offline import _get_plan, _make_sync_one

        plan = _get_plan(config, frame_len)
        sync_one = _make_sync_one(config)
        sel_all = jnp.asarray(plan.sel_src)      # (K, F, G_o) int32
        reg_all = jnp.asarray(plan.reg_src)      # (K, F, G_p)
        blend_all = jnp.asarray(plan.blend_idx)  # (K, F, n_lines)

        def local_fid(iq_local, m_local, k_local, sel_a, reg_a, blend_a,
                      tail, ema, alpha):
            ext = _extend(iq_local[0], tail)
            env = demodulate(ext, config)
            k = k_local[0]
            screens = plan.resample(env, m_local[0], sel_a[k], reg_a[k],
                                    blend_a[k])
            frames, sync, score = jax.vmap(sync_one)(screens)
            ema_out = _ema_compose(ema, frames, alpha)
            return ema_out[None], frames[None], sync[None], score[None]

        shard_fid = jax.shard_map(
            local_fid,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis), P(axis), P(), P(), P(),
                      P(), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
        )

        @_functools.partial(
            jax.jit,
            in_shardings=(row_sh, vec_sh, vec_sh, repl, repl, repl,
                          repl, repl, repl),
            out_shardings=(repl, row_sh, row_sh, vec_sh),
        )
        def fid_step(rows, m_arr, k_arr, sel_a, reg_a, blend_a,
                     tail, ema, alpha):
            ema_shards, frames, sync, score = shard_fid(
                rows, m_arr, k_arr, sel_a, reg_a, blend_a, tail, ema, alpha)
            return (ema_shards[0], frames.reshape(-1, h, w),
                    sync.reshape(-1, 2), score.reshape(-1))

        def step_api(rows, tail, ema, alpha, phases):
            # Host-side bin quantisation per shard — identical to the
            # single-chip fidelity step's bin_for_phase on each span.
            km = [plan.bin_for_phase(float(p)) for p in np.asarray(phases)]
            k_arr = np.asarray([k for k, _ in km], np.int32)
            m_arr = np.asarray([m for _, m in km], np.int32)
            return fid_step(rows, m_arr, k_arr, sel_all, reg_all, blend_all,
                            tail, ema, alpha)

        step_api.plan = plan
    else:

        def local_step(iq_local, phase_local, tail, ema, alpha):
            ext = _extend(iq_local[0], tail)
            env = demodulate(ext, config)          # (S + overlap,) samples
            phase = phase_local[0]
            exact_t = phase + spf * jnp.arange(n_frames, dtype=jnp.float32)
            if sub:
                fstarts = jnp.floor(exact_t).astype(jnp.int32)
                fracs = exact_t - fstarts.astype(jnp.float32)
            else:
                fstarts = jnp.floor(exact_t + 0.5).astype(jnp.int32)
                fracs = None
            frames, sync, score = process_frames(env, fstarts, config,
                                                 frame_len, fracs)
            ema_out = _ema_compose(ema, frames, alpha)
            return ema_out[None], frames[None], sync[None], score[None]

        shard_step = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis), P(), P(), P()),
            out_specs=(P(axis), P(axis), P(axis), P(axis)),
        )

        @_functools.partial(
            jax.jit,
            in_shardings=(row_sh, vec_sh, repl, repl, repl),
            out_shardings=(repl, row_sh, row_sh, vec_sh),
        )
        def step(rows, phases, tail, ema, alpha):
            ema_shards, frames, sync, score = shard_step(rows, phases, tail,
                                                         ema, alpha)
            return (ema_shards[0], frames.reshape(-1, h, w),
                    sync.reshape(-1, 2), score.reshape(-1))

        def step_api(rows, tail, ema, alpha, phases):
            return step(rows, phases, tail, ema, alpha)

    step_api.n_shards = n_shards
    step_api.n_frames = n_frames
    step_api.overlap = overlap
    step_api.shard_samples = S
    return step_api


def _padded_candidate_arrays(
    candidates: list[tuple[str, VideoMode]], n_shards: int
) -> tuple[np.ndarray, np.ndarray]:
    """Candidate (height, width) arrays padded to a multiple of the shard
    count (the pad repeats the last candidate; scores beyond the real set are
    discarded by the callers)."""
    y_arr = np.array([m.height for _, m in candidates], np.float32)
    x_arr = np.array([m.width for _, m in candidates], np.float32)
    pad = (-len(candidates)) % n_shards
    if pad:
        y_arr = np.concatenate([y_arr, np.repeat(y_arr[-1:], pad)])
        x_arr = np.concatenate([x_arr, np.repeat(x_arr[-1:], pad)])
    return y_arr, x_arr


def sharded_mode_search_2d(
    iq: np.ndarray,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, "VideoMode"]],
    mesh: Mesh,
    time_axis: str = "blocks",
    mode_axis: str = "modes",
    frames_per_shard: int = 1,
    render_size: tuple[int, int] = RENDER_SIZE,
) -> "ModeSearchResult":
    """Hypothesis search over a 2-D mesh: the signal timeline sharded along
    ``time_axis`` AND the candidate modes sharded along ``mode_axis``
    simultaneously (BASELINE config 5: "streaming multi-hypothesis video-mode
    search, time-blocks sharded").

    Each (time, mode) device scores its candidate slice on its time span;
    a ``pmean`` over the time axis averages scores across the timeline, so
    every candidate is judged on ``n_time × frames_per_shard`` frames at the
    cost of one.
    """
    if not candidates:
        raise ValueError("empty candidate set")
    n_time = mesh.shape[time_axis]
    n_mode = mesh.shape[mode_axis]
    names = [n for n, _ in candidates]
    n_cand = len(candidates)
    y_arr, x_arr = _padded_candidate_arrays(candidates, n_mode)

    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(frames_per_shard) * spf).astype(np.int32)
    span = int(starts[-1]) + frame_len
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        env_np = np.abs(iq).astype(np.float32)
    else:
        env_np = np.asarray(iq, np.float32)
    if env_np.shape[0] < n_time * span:
        raise ValueError(
            f"need {n_time * span} samples for {n_time} time shards, "
            f"got {env_np.shape[0]}"
        )
    env_shards = env_np[: n_time * span].reshape(n_time, span)

    def local(env_local, y_loc, x_loc):
        env = env_local[0]

        def score_one(y_t, x_t):
            def per_frame(start):
                sig = jax.lax.dynamic_slice(env, (start,), (frame_len,))
                screen = frame_to_screen_dynamic(sig, y_t, x_t, render_size)
                _, _, s = frame_sync(screen)
                return s

            return jnp.mean(jax.vmap(per_frame)(jnp.asarray(starts)))

        scores = jax.vmap(score_one)(y_loc, x_loc)
        return jax.lax.pmean(scores, time_axis)[None]

    sharded = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(time_axis, None), P(mode_axis), P(mode_axis)),
            out_specs=P(time_axis, mode_axis),
        )
    )
    env_dev = jax.device_put(
        env_shards, NamedSharding(mesh, P(time_axis, None))
    )
    y_dev = jax.device_put(y_arr, NamedSharding(mesh, P(mode_axis)))
    x_dev = jax.device_put(x_arr, NamedSharding(mesh, P(mode_axis)))
    # Replicate before the host transfer: in a multi-controller run the raw
    # output's shards are only partially addressable from each process.
    rep = jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(
        sharded(env_dev, y_dev, x_dev)
    )
    scores = np.asarray(rep)[0][:n_cand]
    best = int(np.argmax(scores))
    return ModeSearchResult(
        best_index=best,
        best_mode=candidates[best][1],
        scores=scores,
        names=names,
    )


@dataclasses.dataclass
class ModeSearchResult:
    best_index: int
    best_mode: VideoMode
    scores: np.ndarray       # (n_candidates,) sync contrast per hypothesis
    names: list[str]


def mode_search_static(
    iq: np.ndarray | jnp.ndarray,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, VideoMode]],
    n_frames: int = 2,
    score_size: tuple[int, int] = (150, 200),
    num_phases: int = 16,
) -> ModeSearchResult:
    """Hypothesis search on STATIC per-candidate tables — the fast variant
    of :func:`sharded_mode_search`.

    Same scoring semantics (render each candidate's frames, take the
    two-axis ``frame_sync`` contrast), but every candidate's geometry is
    host-built into stacked one-hot select/regroup/blend/weight tables (the
    ``frames_to_screens_mxu3_exact`` pattern, stacked over candidates
    instead of frames) and the whole hypothesis set runs as a handful of
    batched einsums.  The dynamic-geometry resampler it replaces scores via
    per-element gathers because one executable must serve every geometry;
    here the hypothesis set is baked into the executable instead (a new
    candidate set is a recompile, which the jit cache absorbs per band).

    Scoring runs on a reduced ``score_size`` grid with coarser phase
    quantisation — blanking contrast discrimination doesn't need render
    fidelity.
    """
    if not candidates:
        raise ValueError("empty candidate set")
    names = [n for n, _ in candidates]
    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(n_frames) * spf).astype(np.int64)
    need = int(starts[-1]) + frame_len + 1
    interleaved = False
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        interleaved = True
    iq = jnp.asarray(iq)
    n_have = iq.shape[0] // (2 if interleaved else 1)
    if n_have < need:
        raise ValueError(f"need {need} samples for the mode search, got {n_have}")
    iq = iq[: 2 * need] if interleaved else iq[:need]

    run = _static_search_program(
        frame_len, tuple(int(x) for x in starts),
        tuple((m.height, m.width) for _, m in candidates),
        interleaved, score_size, num_phases,
    )
    scores = np.asarray(run(iq))
    best = int(np.argmax(scores))
    return ModeSearchResult(
        best_index=best,
        best_mode=candidates[best][1],
        scores=scores,
        names=names,
    )


@_functools.lru_cache(maxsize=16)
def _static_search_program(frame_len, starts, cand_geom, interleaved,
                           score_size, num_phases):
    """Build (once per distinct search configuration) the jitted static-table
    scoring program — cached so repeated searches reuse the compiled
    executable instead of retracing per call."""
    from ..ops.framesync import frame_sync
    from ..ops.resample import _pack_slots, _screen_geometry

    C = len(cand_geom)
    h_out, w_out = score_size
    n_lines = 2 * h_out

    # Host-built per-candidate geometry, padded to common shapes.
    geoms = []
    span_max = 0
    for y_t, x_t in cand_geom:
        start, frac, wr, cols, _ = _screen_geometry(
            frame_len, y_t, x_t, score_size)
        geoms.append((start, frac, wr, cols))
        span_max = max(span_max, int(np.ceil(cols[-1] + 1)) + 2)
    span_w = -(-span_max // 128) * 128
    win_w = span_w + 128
    ncw = win_w // 128

    per_cand = []
    R = 0
    per_o = per_p = 0
    for start, frac, wr, cols in geoms:
        raw = start.reshape(-1)
        flat_start = np.maximum(raw, 0)
        flat_frac = np.clip(frac.reshape(-1) + (raw - flat_start),
                            0.0, 1.0 - 1e-9)
        phase = np.minimum((flat_frac * num_phases).astype(np.int64),
                           num_phases - 1)
        chunk = flat_start // 128
        off = flat_start % 128
        slot_o, po = _pack_slots(off, 128)
        slot_p, pp = _pack_slots(phase, num_phases)
        per_cand.append((chunk, off, phase, slot_o, slot_p))
        R = max(R, int(chunk.max()) + 1)
        per_o, per_p = max(per_o, po), max(per_p, pp)

    G_o = 128 * per_o
    G_p = num_phases * per_p
    sel_src = np.full((C, G_o), -1, np.int32)
    reg_src = np.full((C, G_p), -1, np.int32)
    blend_idx = np.zeros((C, n_lines), np.int32)
    coeffs = np.zeros((C, n_lines), np.float32)
    # Per-candidate per-phase interpolation index/weight tables (weights are
    # built on device from these — dense f32 weight stacks would be hundreds
    # of MB of program constants, breaking remote-compile request limits).
    wi0 = np.zeros((C, num_phases, w_out), np.int32)
    wfr = np.zeros((C, num_phases, w_out), np.float32)
    for c, ((start, frac, wr, cols), (chunk, off, phase, slot_o, slot_p)) in \
            enumerate(zip(geoms, per_cand)):
        sel_src[c, off * per_o + slot_o] = chunk
        reg_src[c, phase * per_p + slot_p] = off * per_o + slot_o
        blend_idx[c] = phase * per_p + slot_p
        coeffs[c] = np.stack([1.0 - wr[:, 0], wr[:, 0]], axis=1).reshape(-1)
        for p in range(num_phases):
            pos = (p + 0.5) / num_phases + cols
            wi0[c, p] = pos.astype(np.int64)
            wfr[c, p] = (pos - wi0[c, p]).astype(np.float32)

    F = len(starts)
    # Rows must cover both the selected windows AND the whole frame slice.
    pad_len = 128 * max(R + ncw, -(-frame_len // 128))

    @jax.jit
    def run(iq_in):
        if interleaved:
            env = am_envelope_from_iq(iq_in)
        else:
            env = am_demod(iq_in).astype(jnp.float32)

        frames_sig = jnp.stack([
            jax.lax.slice(env, (int(s),), (int(s) + frame_len,))
            for s in starts
        ])
        frames_sig = jnp.concatenate(
            [frames_sig,
             jnp.broadcast_to(frames_sig[:, -1:], (F, pad_len - frame_len))],
            axis=1,
        )
        rows128 = frames_sig.reshape(F, -1, 128).astype(jnp.bfloat16)

        def onehot(src, n, dtype):
            return (jnp.asarray(src)[..., None]
                    == jnp.arange(n, dtype=jnp.int32)).astype(dtype)

        sel = onehot(sel_src, R, jnp.bfloat16)            # (C, G_o, R)
        reg = onehot(reg_src, G_o, jnp.float32)           # (C, G_p, G_o)
        blend = jnp.einsum(
            "cl,clg->clg", jnp.asarray(coeffs),
            onehot(blend_idx, G_p, jnp.float32),
        ).reshape(C, h_out, 2, G_p).sum(axis=2)           # (C, h, G_p)
        span_idx = jnp.arange(span_w, dtype=jnp.int32)
        i0 = jnp.asarray(wi0)[..., None, :]               # (C, P, 1, w)
        fr = jnp.asarray(wfr)[..., None, :]
        weights = ((span_idx[None, None, :, None] == i0) * (1.0 - fr)
                   + (span_idx[None, None, :, None] == i0 + 1) * fr
                   ).astype(jnp.float32)                  # (C, P, span_w, w)

        S = jnp.concatenate(
            [jnp.einsum("cgr,frk->cfgk", sel, rows128[:, i : R + i],
                        preferred_element_type=jnp.float32)
             for i in range(ncw)],
            axis=3,
        ).reshape(C, F, 128, per_o, win_w)
        aligned = jnp.concatenate(
            [jax.lax.slice(S, (0, 0, o, 0, o), (C, F, o + 1, per_o, o + span_w))
             for o in range(128)],
            axis=2,
        ).reshape(C, F, G_o, span_w)
        regrouped = jnp.einsum(
            "cgk,cfkw->cfgw", reg, aligned,
            preferred_element_type=jnp.float32,
        ).reshape(C, F, num_phases, per_p, span_w)
        z = jnp.einsum(
            "cfpbs,cpsw->cfpbw", regrouped, weights,
            preferred_element_type=jnp.float32,
        )
        screens = jnp.einsum(
            "chg,cfgw->cfhw", blend, z.reshape(C, F, G_p, w_out),
            preferred_element_type=jnp.float32,
        )

        def score_one(screen):
            _, _, score = frame_sync(screen)
            return score

        scores = jax.vmap(jax.vmap(score_one))(screens)   # (C, F)
        return jnp.mean(scores, axis=1)

    return run


def sharded_mode_search(
    iq: np.ndarray | jnp.ndarray,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, VideoMode]],
    mesh: Mesh,
    axis: str = "blocks",
    n_frames: int = 2,
    render_size: tuple[int, int] = RENDER_SIZE,
) -> ModeSearchResult:
    """Score every candidate video mode on the same signal, candidates sharded
    across the mesh; the best sync contrast wins.

    One compiled program handles all geometries via the dynamic-geometry
    resampler, so the hypothesis set is pure data: shard it, vmap it, argmax.

    ``iq``: complex samples (host complex is converted to an interleaved
    float32 view — complex never crosses the device boundary) or an already-
    demodulated real envelope.
    """
    if not candidates:
        raise ValueError("empty candidate set")
    n_dev = mesh.shape[axis]
    names = [n for n, _ in candidates]
    n_cand = len(candidates)
    y_arr, x_arr = _padded_candidate_arrays(candidates, n_dev)

    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(n_frames) * spf).astype(np.int32)
    need = int(starts[-1]) + frame_len
    interleaved = False
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        # Keep the host->device boundary real (no complex dtype crosses
        # it; half the bytes for int16 words).
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        interleaved = True
    iq = jnp.asarray(iq)
    n_have = iq.shape[0] // (2 if interleaved else 1)
    if n_have < need:
        raise ValueError(f"need {need} samples for the mode search, got {n_have}")
    iq = iq[: 2 * need] if interleaved else iq[:need]

    def score_one(env, y_t, x_t):
        def per_frame(start):
            sig = jax.lax.dynamic_slice(env, (start,), (frame_len,))
            screen = frame_to_screen_dynamic(sig, y_t, x_t, render_size)
            _, _, score = frame_sync(screen)
            return score

        return jnp.mean(jax.vmap(per_frame)(jnp.asarray(starts)))

    def local(env, y_loc, x_loc):
        return jax.vmap(lambda y, x: score_one(env, y, x))(y_loc, x_loc)

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
    )

    @jax.jit
    def run(iq_in, y_in, x_in):
        if interleaved:
            env = am_envelope_from_iq(iq_in)
        else:
            env = am_demod(iq_in).astype(jnp.float32)
        return sharded(env, y_in, x_in)

    y_dev = jax.device_put(y_arr, NamedSharding(mesh, P(axis)))
    x_dev = jax.device_put(x_arr, NamedSharding(mesh, P(axis)))
    # Replicate before the host transfer: in a multi-controller run the raw
    # output's shards are only partially addressable from each process (the
    # same fix sharded_mode_search_2d needed).
    rep = jax.jit(lambda s: s, out_shardings=NamedSharding(mesh, P()))(
        run(iq, y_dev, x_dev)
    )
    scores = np.asarray(rep)[:n_cand]
    best = int(np.argmax(scores))
    return ModeSearchResult(
        best_index=best,
        best_mode=candidates[best][1],
        scores=scores,
        names=names,
    )


def sharded_scan_band(
    iq_words: np.ndarray | jnp.ndarray,
    fs: float,
    centers_hz: np.ndarray,
    mesh: Mesh,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    demod: str = "am",
    excise_db: float | None = None,
):
    """Carrier scan with the candidate channels sharded across the mesh —
    hypothesis parallelism for :func:`tempest_tpu.ops.scan.scan_band` (no
    reference counterpart: its operator hunts carriers by eye).

    The capture's spectrum is computed once (replicated: one big FFT is
    cheap next to K per-channel scorings); each device then extracts and
    scores its own slice of candidate centers — band slice (a traced
    ``dynamic_slice`` on the wrapped spectrum), M-point inverse FFT,
    envelope, refresh-comb mass/prominence.  No collectives are needed:
    channels are independent, exactly like the mode-hypothesis search.
    Scores match the single-device :func:`scan_band` bit-for-bit (tested),
    with the same knob surface: ``demod="fm"`` scores the per-channel FM
    discriminator, ``excise_db`` nulls in-channel CW interference before
    scoring (AM only — :func:`tempest_tpu.ops.scan.check_excise_demod`).
    """
    from ..ops.demod import fm_demod_rows
    from ..ops.scan import (ScanResult, _channel_geometry, _comb_contrast,
                            _excise_spikes, _noise_floor, check_excise_demod)

    check_excise_demod(demod, excise_db)
    if isinstance(iq_words, np.ndarray) and np.iscomplexobj(iq_words):
        iq_words = np.ascontiguousarray(iq_words, np.complex64).view(np.float32)
    iq_words = jnp.asarray(iq_words)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    n_dev = mesh.shape[axis]
    n_c = int(iq_words.shape[0]) // 2
    N, M, fs_chan = _channel_geometry(n_c, fs, chan_bw)
    starts_p, _ = _carrier_layout(centers, fs, N, M, n_dev)

    def local(spec_w, starts_loc):
        def one(b0):
            band = jax.lax.dynamic_slice(spec_w, (b0,), (M,))
            band = jnp.roll(band, -(M // 2))
            if excise_db is not None:
                band = _excise_spikes(band, excise_db)
            return jnp.fft.ifft(band) * (M / N)

        chans_l = jax.vmap(one)(starts_loc)           # (K_local, M)
        if demod == "fm":
            envs = fm_demod_rows(chans_l)
        else:
            envs = jnp.real(chans_l) ** 2 + jnp.imag(chans_l) ** 2
        return jax.vmap(
            lambda env: _comb_contrast(env, fs_chan, corr_seconds,
                                       rate_min, rate_max))(envs)

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
    )

    @jax.jit
    def run(words, starts_in):
        ri = words[: 2 * N].reshape(N, 2)
        z = jax.lax.complex(ri[:, 0], ri[:, 1])
        spec = jnp.fft.fft(z)
        spec_w = jnp.concatenate([spec, spec[:M]])
        # Geometry noise floor: channel-independent, replicated (same value
        # on every device; matches the single-device sweep bit-for-bit —
        # same PRNG key, same shapes).
        floor = _noise_floor(fs_chan, M, corr_seconds, rate_min, rate_max,
                             demod=demod)
        return sharded(spec_w, starts_in) + (floor,)

    starts_dev = jax.device_put(starts_p, NamedSharding(mesh, P(axis)))
    # Replicate the channel-sharded outputs before the host reads them
    # (multi-controller: each process only addresses its own shards).
    mass, prom, fv, floor = jax.jit(
        lambda t: t, out_shardings=NamedSharding(mesh, P())
    )(run(iq_words, starts_dev))
    return ScanResult(
        centers_hz=centers,
        scores_db=np.asarray(mass, np.float64)[:K],
        prominence_db=np.asarray(prom, np.float64)[:K],
        refresh_hz=np.asarray(fv, np.float64)[:K],
        fs_channel=fs_chan,
        floor_db=np.full(K, float(floor)),
    )


def _carrier_layout(centers: np.ndarray, fs: float, N: int, M: int,
                    n_dev: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-carrier slice starts into the wrapped capture spectrum (the
    carrier's bin minus M/2, mod N) plus carrier indices, both padded to a
    multiple of the mesh axis (pads repeat carrier 0 and get indices ≥ K,
    so downstream gating discards them).  ONE definition shared by every
    carrier-sharded pipeline — the start-bin rounding must never drift
    between the sweep, the fused step, and the streaming front."""
    starts = np.array(
        [(int(np.round(float(fc) / fs * N)) - M // 2) % N for fc in centers],
        np.int32,
    )
    pad = (-len(centers)) % n_dev
    starts_p = np.concatenate([starts, np.repeat(starts[:1], pad)])
    kidx_p = np.arange(len(centers) + pad, dtype=np.int32)
    return starts_p, kidx_p


def _combine_local_builder(axis, K, M, N, fs_chan, corr_seconds,
                           rate_min, rate_max, weighting, fv_known,
                           demod="am", excise_db=None):
    """shard_map-local kernel of the channel-sharded combine — one device's
    slice of carriers, with the three small collectives (all_gather masses,
    one-hot psum anchor envelope, psum fusion).  ``fv_known`` None = full
    per-channel scoring + lag-1 MRC; a float = known-refresh dot scoring +
    interference-robust MRC (mirrors ops.combine.combine_core exactly).
    Shared by :func:`sharded_combine_harmonics` and
    :func:`sharded_combined_reconstruct_fn`."""
    from ..ops.autocorr import autocorrelation
    from ..ops.scan import _selection_prominence

    from ..ops.demod import fm_demod_rows
    from ..ops.scan import _excise_spikes

    def local(spec_w, starts_loc, kidx_loc):
            def one(b0):
                band = jax.lax.dynamic_slice(spec_w, (b0,), (M,))
                band = jnp.roll(band, -(M // 2))
                if excise_db is not None:
                    band = _excise_spikes(band, excise_db)
                ch = jnp.fft.ifft(band) * (M / N)
                if demod == "fm":
                    return fm_demod_rows(ch)
                return jnp.abs(ch).astype(jnp.float32)

            amp = jax.vmap(one)(starts_loc)              # (Kl, M) envelopes
            mean = jnp.mean(amp, axis=1, keepdims=True)
            env0 = amp - mean
            var = jnp.mean(env0 * env0, axis=1)

            if fv_known is not None:
                spf_c = fs_chan / float(fv_known)

                def comb_dots(e, half_off):
                    acc = jnp.zeros(())
                    cnt = 0
                    for k in range(1, 6):
                        lag0 = int(round(k * spf_c
                                         + half_off * spf_c / 2.0))
                        if lag0 + 1 >= M:
                            break
                        vals = [jnp.mean(e[: M - L] * e[L:])
                                for L in (lag0 - 1, lag0, lag0 + 1)
                                if 0 < L < M]
                        acc = acc + jnp.max(jnp.stack(vals))
                        cnt += 1
                    return acc / max(cnt, 1)

                comb = jax.vmap(lambda e: comb_dots(e, 0))(env0)
                comb_off = jax.vmap(lambda e: comb_dots(e, 1))(env0)
                mass_db = 10.0 * jnp.log10(jnp.maximum(comb, 1e-30))
                fv = jnp.full_like(var, float(fv_known))
            else:
                def comb_one(e):
                    lin, _ = autocorrelation(e, fs_chan, 0.0, corr_seconds,
                                             scale="linear")
                    return _selection_prominence(lin, fs_chan, rate_min,
                                                 rate_max, 5)

                mass_db, _, fv = jax.vmap(comb_one)(env0)
            valid = (kidx_loc < K)
            mass_masked = jnp.where(valid, mass_db, -jnp.inf)
            # Global anchor: gather the K(+pad) masses (scalars) everywhere.
            mass_all = jax.lax.all_gather(mass_masked, axis, tiled=True)
            anchor = jnp.argmax(mass_all)
            anchor_mass = mass_all[anchor]
            # The anchor's envelope, summoned by one (M,) psum.
            onehot = (kidx_loc == anchor).astype(jnp.float32)
            anchor_env = jax.lax.psum(onehot @ env0, axis)
            dots = env0 @ anchor_env
            pol = jnp.where(dots >= 0.0, 1.0, -1.0).astype(jnp.float32)
            if weighting == "equal":
                w = jnp.ones_like(var)
            elif fv_known is not None:
                s = jnp.maximum(comb - comb_off, 0.0)
                noise = jnp.maximum(var - s, 1e-6 * var)
                w = jnp.sqrt(s) / noise
                gate = ((comb > 10.0 ** ((anchor_mass - 20.0) / 10.0))
                        & (comb * np.sqrt(M) > 6.0 * var))
                w = jnp.where(gate, w, 0.0)
            else:
                c1 = jnp.mean(env0[:, :-1] * env0[:, 1:], axis=1)
                s = jnp.maximum(c1, 0.0)
                noise = jnp.maximum(var - c1, 1e-6 * var)
                w = jnp.sqrt(s) / noise
                w = jnp.where(mass_db > anchor_mass - 40.0, w, 0.0)
            w = jnp.where(valid, w, 0.0)
            wsum = jax.lax.psum(jnp.sum(w), axis)
            w = w / jnp.maximum(wsum, 1e-30)
            # Deterministic output polarity (mirrors combine_core): re-base
            # from the data-dependent anchor to the globally-first gated
            # carrier — two more scalar collectives (pmin of the candidate
            # index, psum of the one-hot-selected sign).
            cand = jnp.where(w > 0.0, kidx_loc.astype(jnp.int32),
                             jnp.int32(2**30))
            gfirst = jax.lax.pmin(jnp.min(cand), axis)
            sign = jax.lax.psum(
                jnp.sum(jnp.where(kidx_loc == gfirst, pol, 0.0)), axis)
            sign = jnp.where(sign == 0.0, 1.0, sign)
            pol = pol * sign
            env = jax.lax.psum((w * pol) @ env0, axis)
            env = env + jax.lax.psum(jnp.sum(w * mean[:, 0]), axis)
            return env, w, pol, mass_db, fv

    return local


def sharded_combine_harmonics(
    iq_words: np.ndarray | jnp.ndarray,
    fs: float,
    centers_hz: np.ndarray,
    mesh: Mesh,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    refresh_hz: float | str | None = "auto",
    demod: str = "am",
    excise_db: float | None = None,
):
    """Multi-harmonic combining with the carriers sharded across the mesh —
    channel parallelism for :func:`tempest_tpu.ops.combine.combine_harmonics`
    (the reference has no combining at all, ``GUI.jl:594-605``).

    The spectrum is replicated (one big FFT is cheap next to K per-channel
    scorings); each device channelises and scores its own carriers, then
    three small collectives produce identical global decisions everywhere:
    an ``all_gather`` of the per-channel comb masses (K scalars → the
    anchor channel), one ``psum`` of the one-hot-selected anchor envelope
    ((M,) — so every device can read its channels' polarity against it),
    and one ``psum`` each for the MRC-weighted envelope sum, its weight
    mass, and the DC term.  Cross-device traffic is ~2·M floats per call
    regardless of K.  Matches the single-device ``combine_harmonics`` to
    f32 reassociation (tested on the 8-device mesh).
    """
    from ..ops.autocorr import autocorrelation
    from ..ops.combine import CombineResult
    from ..ops.scan import (_channel_geometry, _selection_prominence,
                            check_excise_demod)

    check_excise_demod(demod, excise_db)
    if isinstance(iq_words, np.ndarray) and np.iscomplexobj(iq_words):
        iq_words = np.ascontiguousarray(iq_words, np.complex64).view(np.float32)
    iq_words = jnp.asarray(iq_words)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    n_dev = mesh.shape[axis]
    n_c = int(iq_words.shape[0]) // 2
    N, M, fs_chan = _channel_geometry(n_c, fs, chan_bw)
    starts_p, kidx_p = _carrier_layout(centers, fs, N, M, n_dev)

    def make_local(fv_known):
        return _combine_local_builder(
            axis, K, M, N, fs_chan, corr_seconds, rate_min, rate_max,
            weighting, fv_known, demod=demod, excise_db=excise_db)

    def run_pass(fv_known):
        sharded = jax.shard_map(
            make_local(fv_known),
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis)),
            out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
        )

        @jax.jit
        def run(words, starts_in, kidx_in):
            ri = words[: 2 * N].reshape(N, 2)
            z = jax.lax.complex(ri[:, 0], ri[:, 1])
            spec = jnp.fft.fft(z)
            spec_w = jnp.concatenate([spec, spec[:M]])
            return sharded(spec_w, starts_in, kidx_in)

        sh = NamedSharding(mesh, P(axis))
        out = run(iq_words, jax.device_put(starts_p, sh),
                  jax.device_put(kidx_p, sh))
        # Replicate the channel-sharded outputs before the host reads them
        # (multi-controller: each process only addresses its own shards).
        return jax.jit(
            lambda t: t, out_shardings=NamedSharding(mesh, P())
        )(out)

    env, w, pol, mass, fv = run_pass(
        None if refresh_hz == "auto" else refresh_hz)
    if refresh_hz == "auto" and weighting == "mrc":
        mass_np, fv_np = np.asarray(mass), np.asarray(fv)
        fv_anchor = float(fv_np[int(np.argmax(mass_np[:K]))])
        # Integer-frame-period quantisation, matching combine_harmonics
        # exactly (keeps the two paths' comb lags — and envelopes — equal).
        fv_anchor = fs_chan / round(fs_chan / fv_anchor)
        env, w, pol, _, _ = run_pass(fv_anchor)
    return CombineResult(
        envelope=np.asarray(env, np.float32),
        fs_channel=float(fs_chan),
        centers_hz=centers,
        weights=np.asarray(w, np.float64)[:K],
        polarity=np.asarray(pol, np.float64)[:K],
        mass_db=np.asarray(mass, np.float64)[:K],
        refresh_hz=np.asarray(fv, np.float64)[:K],
    )


def sharded_combined_reconstruct_fn(
    config: ReconstructionConfig,
    mesh: Mesh,
    fs: float,
    n_samples: int,
    centers_hz: np.ndarray,
    refresh_hz: float,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    weighting: str = "mrc",
    demod: str = "am",
    excise_db: float | None = None,
):
    """ONE multi-chip program for fused reconstruction: the combine front
    with the CARRIERS sharded across the mesh (``_combine_local_builder`` —
    all_gather of comb masses + one-hot-psum anchor envelope + psum fusion),
    whose replicated fused envelope is then re-laid out as consecutive
    per-device TIME spans and reconstructed by the ``ppermute``-halo chain
    (:func:`sharded_reconstruct_fn`) — two shard_maps over the same mesh
    axis composed under a single jit, carriers → time without leaving the
    device.

    ``config``: chain config at the CHANNEL rate (``sample_rate`` must be
    the channeliser's ``fs·M/N``; ``input_format="envelope"``; ``n_frames``
    per shard).  ``n_samples``: complex samples per input block (static —
    sets the FFT geometry).  ``refresh_hz``: the screen's refresh (the comb
    lags are baked in; quantised to an integer frame period like
    ``combine_harmonics``).  Returns ``step(words, ema, alpha) ->
    (ema', frames, sync, score, weights, polarity)`` with ``words`` the
    block's interleaved float32 I/Q (replicated).
    """
    from ..ops.scan import _channel_geometry, check_excise_demod

    check_excise_demod(demod, excise_db)
    n_shards = mesh.shape[axis]
    N, M, fs_chan = _channel_geometry(n_samples, fs, chan_bw)
    if abs(config.sample_rate - fs_chan) > 1e-6 * fs_chan:
        raise ValueError(
            f"config.sample_rate {config.sample_rate} != channel rate "
            f"{fs_chan} (= fs·M/N for n_samples={n_samples}, "
            f"chan_bw={chan_bw})")
    if config.input_format != "envelope":
        raise ValueError("config.input_format must be 'envelope' — the "
                         "chain consumes the fused envelope")
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    starts_p, kidx_p = _carrier_layout(centers, fs, N, M, n_shards)
    fv_q = fs_chan / round(fs_chan / float(refresh_hz))
    front = jax.shard_map(
        _combine_local_builder(axis, K, M, N, fs_chan, 0.1,
                               max(fv_q - 5.0, 20.0), fv_q + 5.0,
                               weighting, fv_q, demod=demod,
                               excise_db=excise_db),
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
    )
    chain = sharded_reconstruct_fn(config, mesh, axis)
    S = M // n_shards
    if S < chain.shard_samples_min:
        raise ValueError(
            f"per-device envelope span ({S}) < {config.n_frames} frame "
            f"periods ({chain.shard_samples_min}) — larger blocks or fewer "
            f"frames per shard")
    sh = NamedSharding(mesh, P(axis))
    starts_dev = jax.device_put(starts_p, sh)
    kidx_dev = jax.device_put(kidx_p, sh)

    @jax.jit
    def step(words, ema, alpha):
        ri = words[: 2 * N].reshape(N, 2)
        z = jax.lax.complex(ri[:, 0], ri[:, 1])
        spec = jnp.fft.fft(z)
        spec_w = jnp.concatenate([spec, spec[:M]])
        env, w, pol, _, _ = front(spec_w, starts_dev, kidx_dev)
        env_shards = jax.lax.with_sharding_constraint(
            env[: n_shards * S].reshape(n_shards, S),
            NamedSharding(mesh, P(axis, None)))
        ema2, frames, sync, score = chain(env_shards, ema, alpha)
        return ema2, frames, sync, score, w, pol

    step.n_shards = n_shards
    step.fs_channel = fs_chan
    step.shard_samples = S
    return step


def sharded_streaming_combine_front(
    fs: float,
    n_samples: int,
    centers_hz: np.ndarray,
    refresh_hz: float,
    mesh: Mesh,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    weighting: str = "mrc",
    demod: str = "am",
    excise_db: float | None = None,
):
    """Carrier-sharded per-block combine front for the LIVE mesh runtime:
    ``front(words) -> (env, weights, polarity, mass)`` with the fused
    envelope REPLICATED and device-resident — the mesh runtime hands it
    straight to :func:`sharded_streaming_reconstruct_fn` (input_format
    ``"envelope"``) without a host round trip, carrying the previous
    block's envelope on device for the one-block lookahead tail.

    This is the front half of :func:`sharded_combined_reconstruct_fn`
    (same ``_combine_local_builder`` locals: all_gather of the comb
    masses, one-hot-psum anchor envelope, psum fusion — ~2·M floats of
    inter-device traffic per call regardless of K) split out as its own program, because a
    streaming step consumes the PREVIOUS block's envelope while this
    block's is being fused."""
    from ..ops.scan import _channel_geometry, check_excise_demod

    check_excise_demod(demod, excise_db)
    n_dev = mesh.shape[axis]
    N, M, fs_chan = _channel_geometry(n_samples, fs, chan_bw)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    starts_p, kidx_p = _carrier_layout(centers, fs, N, M, n_dev)
    fv_q = fs_chan / round(fs_chan / float(refresh_hz))
    local = _combine_local_builder(
        axis, K, M, N, fs_chan, 0.1, max(fv_q - 5.0, 20.0), fv_q + 5.0,
        weighting, fv_q, demod=demod, excise_db=excise_db)
    front_sm = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
    )
    sh = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    starts_dev = jax.device_put(starts_p, sh)
    kidx_dev = jax.device_put(kidx_p, sh)

    @_functools.partial(
        jax.jit, in_shardings=(repl,),
        out_shardings=(repl, repl, repl, repl),
    )
    def front(words):
        ri = words[: 2 * N].reshape(N, 2)
        z = jax.lax.complex(ri[:, 0], ri[:, 1])
        spec = jnp.fft.fft(z)
        spec_w = jnp.concatenate([spec, spec[:M]])
        env, w, pol, mass, _ = front_sm(spec_w, starts_dev, kidx_dev)
        return env, w[:K], pol[:K], mass[:K]

    front.fs_channel = fs_chan
    front.n_fft = N
    front.m_chan = M
    return front
