"""Live streaming executor on a multi-chip mesh.

The reference is a *live* 3-stage pipeline — producer thread → ring →
consumer DSP loop (``/root/reference/src/GUI.jl:380-382``); the BASELINE
8-chip ≥8× real-time target is therefore a *streaming* claim, not a batch
one.  :class:`MeshStreamingRuntime` is the single-chip
:class:`~tempest_tpu.runtime.stream.StreamingRuntime` with its per-block
jitted step replaced by the time-sharded multi-chip step
(:func:`~tempest_tpu.parallel.sharded.sharded_streaming_reconstruct_fn`):
each host ring block is split into ``n_shards`` consecutive time spans laid
across the mesh, frame cuts tick on the same global carry-phase grid, halos
travel between neighbouring devices (``ppermute``), and the EMA folds
associatively across shards.

Semantics are EXACTLY "the single-chip runtime on ``block/n_shards``-sample
blocks, ``n_shards`` of them per dispatch": same per-span frame count, same
grid, same cut windows — so this runtime and the single-chip runtime fed
the same stream produce the same EMA (parity-tested on the virtual 8-CPU
mesh, ``tests/test_runtime.py::test_mesh_streaming_matches_single_chip``).

Design notes:

* **One-block lookahead.** The last shard's halo is the next block's first
  ``overlap`` samples (the true continuation — no circular wrap, no phase
  shear at block boundaries), so the runtime dispatches block *t* when
  block *t+1* arrives.  One extra block of latency, exact cuts.
* Everything else — ring, producer thread, sequence-anchored positions,
  correlate/scan/console/checkpoint — is inherited from the single-chip
  runtime unchanged; hot-swapping the mode rebuilds the mesh program.
* **Live combining runs on the same mesh**: the carrier-sharded front
  (:func:`~tempest_tpu.parallel.sharded.sharded_streaming_combine_front`)
  fuses each block's harmonics (all_gather masses + one-hot-psum anchor +
  psum fusion), the replicated envelope stays DEVICE-RESIDENT as the
  pending payload, and the time-sharded chain consumes the previous
  block's envelope with the new one's head as the lookahead tail —
  carriers → time across one mesh, streaming.  Frame-grid math stays in
  source samples, scaled by the exact decimation M/N on dispatch.
* **The fidelity chain runs on the mesh too** (``fidelity=True``): each
  shard's carry phase quantises to its own bin HOST-side (identical
  ``bin_for_phase`` as the single-chip step), all bins' grouping tables
  live device-resident as (K, F, …) stacks, and each shard gathers its
  (F, …) slab by traced bin index — the round-3 batched-serving
  mechanism applied per shard.  Bit-parity with the single-chip fidelity
  runtime is tested.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh

from ..pipeline.offline import ReconstructionConfig
from ..video.modes import VideoMode
from .sources import SampleSource
from .stream import FrameSink, StreamingRuntime, frames_per_window

__all__ = ["MeshStreamingRuntime"]


class MeshStreamingRuntime(StreamingRuntime):
    """Block-streaming executor whose jitted step spans a device mesh."""

    def __init__(
        self,
        source: SampleSource,
        mode: VideoMode,
        mesh: Mesh,
        axis: str = "blocks",
        n_frames_per_shard: int | None = None,
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
        self.mesh = mesh
        self._mesh_axis = axis
        self._pending: tuple[object, int] | None = None
        self._mesh_front = None
        super().__init__(
            source, mode, n_frames_per_block=n_frames_per_shard,
            alpha=alpha, ring_depth=ring_depth, invert=invert,
            ring_impl=ring_impl, fidelity=fidelity,
            fidelity_bins=fidelity_bins,
            config_overrides=config_overrides,
            combine=combine, combine_bw=combine_bw,
            combine_demod=combine_demod,
            combine_excise_db=combine_excise_db,
        )

    # ------------------------------------------------------------ config
    def _rebuild(self) -> None:
        from ..parallel.sharded import (
            sharded_streaming_combine_front,
            sharded_streaming_reconstruct_fn,
        )

        n_shards = self.mesh.shape[self._mesh_axis]
        block = self.source.block_size
        fs = self.source.sample_rate
        spf = fs / self._mode.refresh
        self._spf = spf

        if getattr(self, "_combine_centers", None):
            # Live combine across the SAME mesh: the front shards the
            # CARRIERS (all_gather masses + one-hot-psum anchor + psum
            # fusion) and hands the replicated fused envelope — still on
            # device — to the time-sharded chain at the channel rate.
            # Frame-grid math stays in SOURCE samples, scaled by the exact
            # decimation M/N on dispatch (same contract as the single-chip
            # combine front).
            from ..ops.scan import _channel_geometry

            n_fft, m_chan, fs_chan = _channel_geometry(
                block, fs, self._combine_bw)
            if block != n_fft:
                # The single-chip runtime tolerates block > N (its per-block
                # phase re-anchoring absorbs the uncovered tail), but the
                # MESH runtime's lookahead tail is the NEXT block's envelope
                # head: with block > N the tail would continue at source
                # position ppos+block while the chain assumes ppos+N — a
                # (block−N)·M/N-channel-sample tear inside the last shard's
                # halo frames, folded into the EMA every dispatch.  Refuse
                # and tell the operator the fix.
                raise ValueError(
                    f"mesh live combine needs a power-of-two block size "
                    f"(the channeliser FFT window): block {block} vs "
                    f"window {n_fft} — use block_size={n_fft} "
                    f"(cli: --block-seconds {n_fft / fs:.6f})")
            if m_chan % n_shards:
                raise ValueError(
                    f"channel length {m_chan} must divide into {n_shards} "
                    f"equal envelope spans")
            S = m_chan // n_shards
            chain_fs = fs_chan
            self._phase_scale = m_chan / n_fft
            self._combine_geometry = (n_fft, m_chan, fs_chan)
            self._mesh_front = sharded_streaming_combine_front(
                fs, block, np.asarray(self._combine_centers),
                self._mode.refresh, self.mesh, self._mesh_axis,
                chan_bw=self._combine_bw, demod=self._combine_demod,
                excise_db=self._combine_excise)
            input_format = "envelope"
        else:
            chain_fs = fs
            S = block // n_shards
            if block % n_shards:
                raise ValueError(
                    f"source block_size {block} must divide into {n_shards} "
                    f"equal shard spans")
            self._phase_scale = 1.0
            self._combine_geometry = None
            self._mesh_front = None
            input_format = "iq_interleaved"

        spf_chain = chain_fs / self._mode.refresh
        if self._n_frames_fixed is None:
            # The single-chip derivation with the chain capacity set to ONE
            # SHARD SPAN — that is what makes the mesh step per-span-
            # identical to single-chip blocks of S samples (shared helper:
            # the parity contract depends on the identical formula).
            self._n_frames = frames_per_window(S, spf_chain)
        else:
            self._n_frames = self._n_frames_fixed
        # Chain selection mirrors the single-chip runtime exactly (their
        # bit-parity contract): fidelity = quantised exact-cut tables with
        # per-SHARD host-selected bins; otherwise the sub-pixel sync chain.
        if self.fidelity and not self.fidelity_bins:
            raise ValueError(
                "mesh fidelity needs fidelity_bins>0 (quantised tables; "
                "the traced-offset gather chain is config_overrides="
                "{'resampler': 'gather'} if really wanted)")
        self.config = ReconstructionConfig(
            sample_rate=chain_fs,
            mode=self._mode,
            n_frames=self._n_frames,
            invert=self.invert,
            carry_phase=True,
            input_format=input_format,
            resampler="mxu3",
            subsample_align=self.fidelity,
            do_align=not self.fidelity,
            align_subpixel=not self.fidelity,
            phase_bins=self.fidelity_bins if self.fidelity else 0,
            einsum_bf16=bool(self.fidelity and self.fidelity_bins),
        )
        if self._overrides:
            import dataclasses

            self.config = dataclasses.replace(self.config, **self._overrides)
        self._abs_pos = 0
        self._upload_samples = self.config.block_samples
        self._combine_front = None     # single-chip front unused here
        self.combine_weights = None
        # A config change invalidates the pending block's pairing with the
        # compiled geometry — drop it (one block of signal, same real-time
        # semantics as a ring drop).
        self._pending = None
        self._step = sharded_streaming_reconstruct_fn(
            self.config, self.mesh, S, self._mesh_axis)
        from jax.sharding import NamedSharding, PartitionSpec as P

        # The front's fused envelope comes back committed-replicated; the
        # chain declares row-sharded inputs, so re-lay it out explicitly
        # (a device-side reshard — the envelope never visits the host).
        self._row_sharding = NamedSharding(self.mesh, P(self._mesh_axis,
                                                        None))

    # ---------------------------------------------------------- consumer
    def process_blocks(
        self,
        n_blocks: int,
        sink: FrameSink | None = None,
        emit_every_frame: bool = False,
    ) -> np.ndarray:
        """Consume ring blocks through the mesh step.

        Dispatches ``n_blocks`` blocks; because the last shard's halo is
        the NEXT block's head, the first call primes a one-block lookahead
        (``n_blocks`` dispatches consume ``n_blocks + 1`` ring blocks; the
        trailing block stays pending for the next call).  If the ring
        dropped blocks between two takes, the pending block's phase is
        still exact (sequence-anchored) and only its last ``overlap``
        halo samples come from non-contiguous signal."""
        ema = jnp.asarray(self._ema)
        block = self.source.block_size
        n_shards = self._step.n_shards
        S = self._step.shard_samples
        ov = self._step.overlap
        combining = self._mesh_front is not None
        # Chain-grid frame period: source samples, or channel samples
        # scaled by the exact decimation M/N when the front is active.
        spf_chain = self._spf * self._phase_scale
        dispatched = 0
        while dispatched < n_blocks:
            buf = np.empty(block, np.complex64)
            if self.ring.take(buf) is None:
                if self._producer_error is not None:
                    raise RuntimeError(
                        "sample source failed") from self._producer_error
                break
            seq = getattr(self.ring, "last_seq", -1)
            if seq >= 0:
                abs_this = self._abs_base + seq * block
            elif self._pending is not None:
                # Sequence-less ring: this block continues the pending one
                # (self._abs_pos still points at the pending block's start
                # until its dispatch below, so it would be one block stale).
                abs_this = self._pending[1] + block
            else:
                abs_this = self._abs_pos
            if combining:
                # Fuse THIS block's carriers on the mesh now; the envelope
                # stays device-resident and becomes the pending payload
                # (its head is also the previous dispatch's tail).
                env_new, w, pol, mass = self._mesh_front(
                    jnp.asarray(buf.view(np.float32)))
                self.combine_weights = (w, pol, mass)
                payload = env_new
            else:
                payload = buf
            if self._pending is not None:
                prev, ppos = self._pending
                # Phases stay float64 on the host: the fidelity step
                # quantises them to bins HOST-side (exact parity with the
                # single-chip bin_for_phase); the traced chains downcast to
                # f32 at dispatch either way.
                if combining:
                    import jax

                    rows = jax.device_put(
                        prev[: n_shards * S].reshape(n_shards, S),
                        self._row_sharding)
                    tail = payload[:ov]
                    ph0 = ((-ppos) % self._spf) * self._phase_scale
                    phases = np.asarray(
                        [(ph0 - d * S) % spf_chain for d in range(n_shards)],
                        np.float64)
                else:
                    rows = prev.view(np.float32).reshape(n_shards, 2 * S)
                    tail = np.ascontiguousarray(buf[:ov]).view(np.float32)
                    phases = np.asarray(
                        [(-(ppos + d * S)) % self._spf
                         for d in range(n_shards)],
                        np.float64)
                ema, frames, sync, score = self._step(
                    rows, tail, ema, jnp.float32(self.alpha), phases)
                self._abs_pos = ppos + block
                self.frames_out += int(frames.shape[0])
                dispatched += 1
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
            self._pending = (payload, abs_this)
        self._ema = np.asarray(ema)
        return self._ema

    # -------------------------------------------------- failure detection
    def health(self) -> dict:
        h = super().health()
        h["mesh"] = {
            "n_shards": int(self.mesh.shape[self._mesh_axis]),
            "axis": self._mesh_axis,
            "shard_samples": int(self._step.shard_samples),
            "frames_per_shard": int(self._step.n_frames),
            "halo_samples": int(self._step.overlap),
            "pending_block": self._pending is not None,
        }
        return h
