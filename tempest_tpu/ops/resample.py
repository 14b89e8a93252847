"""Rate conversion: signal→image mapping and fractional resampling.

Covers the capabilities of the reference's ``Resampler`` module
(``/root/reference/src/Resampler.jl``):

* ``sig_to_image`` / ``downgrade_image`` — the live reshaping path
  (``Resampler.jl:117-126``): 1-D interpolate one frame's envelope to
  ``y_t * x_t`` raster pixels, reshape to (y_t, x_t), then shrink to the
  (600, 800) rendering size.
* ``upsample_fft`` — the frequency-domain integer upsampler that the reference
  builds and benchmarks but never calls live (``Resampler.jl:26-62``,
  ``initLPF`` ``:83-99``): zero-stuff, FFT, multiply a Blackman-apodised
  low-pass, IFFT.
* ``naive_upsample`` — sample-repeat (``Resampler.jl:103-110``).
* ``polyphase_resample`` — the production fractional resampler (SURVEY.md §7
  step 2): a windowed-sinc polyphase bank addressed by per-output-sample
  fractional phase, which locks the sample rate to the inferred pixel clock
  with anti-aliasing — strictly better than the reference's ``imresize``
  point-interpolation.

Design: the reference's chain *upsamples* ~333 k samples to ~2.9 M
raster pixels with ``imresize`` and then *downsamples* to 600×800 with a second
``imresize``.  Both are point-sampling linear interpolators, so their
composition is (to interpolation error) a single linear interpolation from
signal index space to output-pixel space.  ``frame_to_screen`` therefore maps
each of the 480 k output pixels straight to a fractional signal position with
one fused gather — no 2.9 M-element intermediate, ~6× less memory traffic —
which XLA fuses with the upstream ``|z|`` demod.  All shapes are static.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "linear_resample",
    "sig_to_image",
    "downgrade_image",
    "frame_to_screen",
    "frame_to_screen_rows",
    "frame_to_screen_mxu",
    "frame_to_screen_mxu3",
    "frame_to_screen_mxu4",
    "frames_to_screens_mxu",
    "frames_to_screens_mxu3_exact",
    "StreamingExactPlan",
    "frames_to_screens_aligned",
    "frames_to_screens_fft",
    "frame_to_screen_dynamic",
    "fractional_shift",
    "naive_upsample",
    "upsample_fft",
    "make_fft_upsampler_filter",
    "polyphase_filter_bank",
    "polyphase_resample",
    "RENDER_SIZE",
]

RENDER_SIZE = (600, 800)  # reference RENDERING_SIZE (GUI.jl:10)


def _interp_positions(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Half-pixel-centred source positions for resizing n_in → n_out."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    i0 = np.floor(pos).astype(np.int32)
    i0 = np.minimum(i0, n_in - 2) if n_in > 1 else i0
    frac = (pos - i0).astype(np.float32)
    return i0, frac


def linear_resample(sig: jnp.ndarray, n_out: int) -> jnp.ndarray:
    """1-D linear interpolation of ``sig`` to ``n_out`` points (the
    ``imresize``-equivalent used by the reference's live path).  Gather-based:
    positions are compile-time constants for static shapes."""
    n_in = sig.shape[0]
    i0, frac = _interp_positions(n_in, n_out)
    i0 = jnp.asarray(i0)
    frac = jnp.asarray(frac)
    return sig[i0] * (1.0 - frac) + sig[i0 + 1] * frac


def sig_to_image(sig: jnp.ndarray, y_t: int, x_t: int) -> jnp.ndarray:
    """One frame's envelope → full-resolution (y_t, x_t) image (reference
    ``sig_to_image``, ``Resampler.jl:117-122``: resample to ``y_t*x_t`` pixels
    then fill line by line)."""
    flat = linear_resample(sig, y_t * x_t)
    return flat.reshape(y_t, x_t)


def downgrade_image(
    image: jnp.ndarray, out_shape: tuple[int, int] = RENDER_SIZE
) -> jnp.ndarray:
    """Bilinear shrink to the rendering size (reference ``downgradeImage``,
    ``Resampler.jl:124-126``)."""
    h_in, w_in = image.shape
    h_out, w_out = out_shape
    r0, rf = _interp_positions(h_in, h_out)
    c0, cf = _interp_positions(w_in, w_out)
    r0, rf = jnp.asarray(r0), jnp.asarray(rf)[:, None]
    c0, cf = jnp.asarray(c0), jnp.asarray(cf)[None, :]
    top = image[r0][:, c0] * (1 - cf) + image[r0][:, c0 + 1] * cf
    bot = image[r0 + 1][:, c0] * (1 - cf) + image[r0 + 1][:, c0 + 1] * cf
    return top * (1 - rf) + bot * rf


def frame_to_screen(
    sig: jnp.ndarray,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    offset: jnp.ndarray | float | None = None,
) -> jnp.ndarray:
    """Fused fast path: one frame's envelope straight to the (600, 800) screen.

    Equivalent (to interpolation error) to
    ``downgrade_image(sig_to_image(sig, y_t, x_t))`` — the reference's
    two-``imresize`` chain (``GUI.jl:168``) — but with a single gather over the
    envelope and no ``y_t*x_t`` intermediate.

    ``offset`` (optionally traced, in [0, 1) signal samples) shifts every read
    position by the frame boundary's sub-sample residual — sub-sample-exact
    frame cuts for super-resolution accumulation.  Implemented as a 3-tap
    read with traced weights: the same linear interpolation as the 2-tap
    path, no extra low-pass.
    """
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    ratio = n_in / (y_t * x_t)  # signal samples per raster pixel
    # Output pixel (r, c) ← raster position ((r+.5)*y_t/h - .5, (c+.5)*x_t/w - .5).
    ry = np.clip((np.arange(h_out, dtype=np.float64) + 0.5) * (y_t / h_out) - 0.5,
                 0.0, y_t - 1.0)
    cx = np.clip((np.arange(w_out, dtype=np.float64) + 0.5) * (x_t / w_out) - 0.5,
                 0.0, x_t - 1.0)
    # Bilinear across scan *lines* (positions x_t samples apart in the signal)
    # and along the scan — the same interpolation the two-imresize chain
    # performs, as one fused 4-tap gather.
    r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
    wr = (ry - r0).astype(np.float32)[:, None]
    max_i0 = max(n_in - 2, 0) if offset is None else max(n_in - 3, 0)

    def line_positions(line_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        flat = line_idx[:, None] * x_t + cx[None, :]
        pos = np.clip((flat + 0.5) * ratio - 0.5, 0.0, n_in - 1.0)
        i0 = np.minimum(np.floor(pos).astype(np.int32), max_i0)
        return i0, (pos - i0).astype(np.float32)

    def read_line(i0: np.ndarray, f: np.ndarray) -> jnp.ndarray:
        i0 = jnp.asarray(i0)
        if offset is None:
            return sig[i0] * (1.0 - f) + sig[i0 + 1] * f
        u = f + jnp.asarray(offset, jnp.float32)      # in [0, 2)
        w0 = jnp.maximum(1.0 - u, 0.0)
        w2 = jnp.maximum(u - 1.0, 0.0)
        return sig[i0] * w0 + sig[i0 + 1] * (1.0 - w0 - w2) + sig[i0 + 2] * w2

    i_top, f_top = line_positions(r0)
    i_bot, f_bot = line_positions(np.minimum(r0 + 1, y_t - 1))
    top = read_line(i_top, f_top)
    bot = read_line(i_bot, f_bot)
    return top * (1.0 - wr) + bot * wr


def _screen_geometry(
    n_in: int, y_t: int, x_t: int, out_shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Host-side geometry shared by the fast frame_to_screen variants.

    For output row r and vertical tap t∈{0,1}, the source positions along the
    scan are ``A[r,t] + c*delta`` (c = output column): an affine family whose
    slope is constant — only the per-(row,tap) offset differs.  Returns
    (line_start[600,2], line_frac[600,2], wr[600,1], col_offsets[800], delta)
    with positions split as start (int) + frac∈[0,1) + c*delta.
    """
    h_out, w_out = out_shape
    ratio = n_in / (y_t * x_t)  # signal samples per raster pixel
    ry = np.clip((np.arange(h_out) + 0.5) * (y_t / h_out) - 0.5, 0.0, y_t - 1.0)
    r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
    wr = (ry - r0).astype(np.float32)[:, None]
    lines = np.stack([r0, np.minimum(r0 + 1, y_t - 1)], axis=1)  # (h,2)
    # Column positions must stay a UNIFORM grid (the affine-family variants
    # encode them as start + c*delta): do NOT clip cx — clipping the edge
    # columns (which engages whenever w_out > x_t) used to corrupt delta and
    # silently mis-render every wide output grid.  The sub-pixel overhang at
    # the edges (< 1 raster px) reads the neighbouring sample instead of
    # clamping — boundary-only, and within the padded span.
    cx0 = 0.5 * (x_t / w_out) - 0.5
    delta = (x_t / w_out) * ratio if w_out > 1 else 0.0
    # pos(r,t,c) = (lines*x_t + cx0 + 0.5)*ratio - 0.5 + c*delta
    a = (lines * x_t + cx0 + 0.5) * ratio - 0.5            # (h,2) offset at c=0
    start = np.floor(a).astype(np.int64)
    frac = (a - start).astype(np.float32)
    cols = (np.arange(w_out) * delta).astype(np.float64)    # c*delta
    return start, frac, wr, cols, float(ratio)


def _catmull_rom(t: np.ndarray) -> tuple[np.ndarray, ...]:
    """Catmull-Rom (cubic, C¹) weights for taps at offsets (-1, 0, 1, 2)
    around the integer part of the read position, fraction ``t``."""
    t2, t3 = t * t, t * t * t
    return (
        0.5 * (-t3 + 2.0 * t2 - t),
        0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
        0.5 * (-3.0 * t3 + 4.0 * t2 + t),
        0.5 * (t3 - t2),
    )


def _phase_weights(
    cols: np.ndarray, span: int, w_out: int, num_phases: int, taps: int = 2
) -> np.ndarray:
    """Per-phase interpolation weight matrices (num_phases, span, w_out):
    phase p interpolates at positions ``(p+0.5)/P + cols`` — shared by every
    phase-quantised matmul resampler variant.

    ``taps=2`` is linear (the reference's ``imresize`` class,
    ``Resampler.jl:117-126``); ``taps=4`` is Catmull-Rom — same matrix shape
    and therefore the *same einsum cost* (the span is already 128-padded),
    i.e. higher interpolation order at no extra matmul cost.  Edge taps clamp to
    the span (border replication, affects only the first output column)."""
    weights = np.zeros((num_phases, span, w_out), np.float32)
    ar = np.arange(w_out)
    for p in range(num_phases):
        pos = (p + 0.5) / num_phases + cols
        i0 = pos.astype(np.int64)
        fr = (pos - i0).astype(np.float32)
        if taps == 2:
            np.add.at(weights[p], (i0, ar), 1.0 - fr)
            np.add.at(weights[p], (i0 + 1, ar), fr)
        elif taps == 4:
            for off, w in zip((-1, 0, 1, 2), _catmull_rom(fr)):
                np.add.at(weights[p], (np.clip(i0 + off, 0, span - 1), ar), w)
        else:
            raise ValueError(f"interp taps must be 2 or 4, got {taps}")
    return weights


def _pack_slots(keys: np.ndarray, n_keys: int) -> tuple[np.ndarray, int]:
    """Stable-sort items into (n_keys, per) slots; returns (slot, per) —
    the grouping used by the one-hot select/regroup tables.  Vectorised
    (the streaming plan builds K·F of these): slot = rank within the key's
    stable-sorted run."""
    keys = np.asarray(keys)
    n = len(keys)
    if n == 0:
        return np.zeros(0, np.int64), 1
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    idx = np.arange(n, dtype=np.int64)
    new = np.r_[True, sk[1:] != sk[:-1]]
    run_start = idx[new][np.cumsum(new) - 1]   # start index of each run
    slot_sorted = idx - run_start
    slot = np.empty(n, np.int64)
    slot[order] = slot_sorted
    return slot, int(slot_sorted.max()) + 1


def _pack_slots_batch(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """Batched :func:`_pack_slots` over the last axis of a 2-D key array.

    One argsort + cumulative-max over the whole (B, n) batch replaces B
    Python-loop calls (keep keys ≤int16: numpy's stable sort is radix for
    small ints, 15x faster than the int64 mergesort).  Returns
    ``(slots (B, n), per)`` with ``per`` the GLOBAL max run length,
    matching :func:`_pack_slots`'s maximum over per-row calls."""
    keys = np.asarray(keys)
    b, n = keys.shape
    if n == 0:
        return np.zeros((b, 0), np.int64), 1
    order = np.argsort(keys, axis=-1, kind="stable")
    sk = np.take_along_axis(keys, order, -1)
    idx = np.arange(n, dtype=np.int64)
    new = np.concatenate(
        [np.ones((b, 1), bool), sk[:, 1:] != sk[:, :-1]], axis=1)
    # Start index of the run each sorted element belongs to = running max
    # of the run-start positions.
    starts = np.maximum.accumulate(np.where(new, idx[None, :], 0), axis=1)
    slot_sorted = idx[None, :] - starts
    slot = np.empty((b, n), np.int64)
    np.put_along_axis(slot, order, slot_sorted, -1)
    return slot, int(slot_sorted.max()) + 1


def frame_to_screen_rows(
    sig: jnp.ndarray,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> jnp.ndarray:
    """``frame_to_screen`` v2: per-scanline span gather + take_along_axis.

    Instead of one flat (h*w)-point gather into the whole envelope, gather
    each needed scan line as a contiguous span (row-major slices), then
    interpolate within rows where the
    index extent is tiny.  Bit-compatible with ``frame_to_screen`` up to
    float rounding.
    """
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    start, frac, wr, cols, ratio = _screen_geometry(n_in, y_t, x_t, out_shape)
    # Absolute positions, clipped like frame_to_screen; then per-(row,tap)
    # span starts and in-span offsets.
    abs_pos = np.clip(
        start[:, :, None] + frac[:, :, None].astype(np.float64) + cols[None, None, :],
        0.0,
        n_in - 1.000001,
    )
    start_c = np.floor(abs_pos.min(axis=2)).astype(np.int64)
    span = int(np.ceil((abs_pos - start_c[:, :, None]).max())) + 2
    start_c = np.minimum(start_c, max(n_in - span - 1, 0))
    pos = abs_pos - start_c[:, :, None]
    i0 = pos.astype(np.int32)
    f = (pos - i0).astype(np.float32)
    spans = sig[jnp.asarray(start_c)[:, :, None] + jnp.arange(span + 1)[None, None, :]]
    i0 = jnp.asarray(i0)
    top_bot = jnp.take_along_axis(spans, i0, axis=2) * (1.0 - f) + \
        jnp.take_along_axis(spans, i0 + 1, axis=2) * f       # (h, 2, w)
    wr = jnp.asarray(wr)
    return top_bot[:, 0, :] * (1.0 - wr) + top_bot[:, 1, :] * wr


def frame_to_screen_mxu(
    sig: jnp.ndarray,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    perm: str = "gather",
    interp_taps: int = 2,
) -> jnp.ndarray:
    """``frame_to_screen`` v3: scanline interpolation as batched matmuls.

    Within a scan line the source positions are ``frac + c*delta`` — a
    one-parameter family in ``frac``.  Quantising ``frac`` to ``num_phases``
    levels, all lines sharing a phase use the same (span × w_out) linear-
    interpolation weight matrix, so the whole per-frame resample becomes one
    span gather + one batched matmul ``(P, rows/P, span) @ (P, span, w_out)``
    (plus static row permutations).  Trades the gather-bound inner loop for
    matmul FLOPs; phase quantisation error ≤ 1/(2·num_phases) sample.
    """
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    start, frac, wr, cols, ratio = _screen_geometry(n_in, y_t, x_t, out_shape)
    span = int(np.ceil(cols[-1] + 1)) + 2
    span_pad = -(-span // 128) * 128  # lane-aligned

    # Quantise per-(row,tap) fracs to phases; build P weight matrices.  The
    # signal is edge-padded by span_pad so spans never clamp; only the first
    # row's start can go negative (clamped, ≤1-sample effect at row 0 — the
    # same edge clip frame_to_screen applies).
    flat_start = np.maximum(start.reshape(-1), 0)
    flat_frac = np.clip(frac.reshape(-1).astype(np.float64), 0.0, 1.0 - 1e-9)
    phase = np.minimum((flat_frac * num_phases).astype(np.int64), num_phases - 1)

    weights = _phase_weights(cols, span_pad, w_out, num_phases, interp_taps)

    # Sort the 2h lines by phase → contiguous per-phase batches (padded).
    order = np.argsort(phase, kind="stable")
    inv = np.argsort(order)
    counts = np.bincount(phase, minlength=num_phases)
    per = int(counts.max()) if counts.size else 1
    slot = np.zeros(2 * h_out, np.int64)
    # slot index of each sorted line within its phase batch
    c = np.zeros(num_phases, np.int64)
    for idx in order:
        slot[idx] = c[phase[idx]]
        c[phase[idx]] += 1
    # scatter lines into (P, per) grid; empty slots read span 0 (ignored later)
    grid_src = np.zeros((num_phases, per), np.int64)          # line index
    valid = np.zeros((num_phases, per), bool)
    grid_src[phase, slot] = np.arange(2 * h_out)
    valid[phase, slot] = True

    sig_pad = jnp.concatenate(
        [sig, jnp.broadcast_to(sig[-1], (span_pad,)).astype(sig.dtype)]
    )
    spans = sig_pad[jnp.asarray(flat_start)[:, None] + jnp.arange(span_pad)[None, :]]
    if perm == "einsum":
        # Phase-sort as a one-hot matmul instead of a row gather (a
        # (P*per, 2h) one-hot contraction is ~1 GFLOP of matmul work).
        onehot = np.zeros((num_phases * per, 2 * h_out), np.float32)
        onehot[np.arange(num_phases * per), grid_src.reshape(-1)] = 1.0
        batched = jnp.dot(
            jnp.asarray(onehot), spans, preferred_element_type=jnp.float32
        ).reshape(num_phases, per, span_pad)
    else:
        batched = spans[jnp.asarray(grid_src.reshape(-1))].reshape(
            num_phases, per, span_pad
        )
    # f32 operands: this variant keeps full precision (use mxu3 with
    # einsum_bf16 for half the weight bytes).
    z = jnp.einsum(
        "pbs,psw->pbw", batched, jnp.asarray(weights),
        preferred_element_type=jnp.float32,
    )
    # Back to line order + vertical blend as ONE small matmul: the inverse
    # phase permutation would be a row gather, but both the permutation and
    # the (1-wr)/wr blend are linear, so they fold into a host-built
    # (h, P*per) matrix:
    # out[r] = (1-wr_r)*z[key(2r)] + wr_r*z[key(2r+1)].
    blend = np.zeros((h_out, num_phases * per), np.float32)
    rows = np.repeat(np.arange(h_out), 2)
    coeff = np.stack([1.0 - wr[:, 0], wr[:, 0]], axis=1).reshape(-1)
    blend[rows, phase * per + slot] += coeff
    return jnp.dot(
        jnp.asarray(blend), z.reshape(num_phases * per, w_out),
        preferred_element_type=jnp.float32,
    )


def frame_to_screen_mxu3(
    sig: jnp.ndarray,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    einsum_bf16: bool = False,
    interp_taps: int = 2,
) -> jnp.ndarray:
    """``frame_to_screen`` v4: ZERO gathers — every data movement is a
    reshape, a static slice, or a (one-hot) matmul.

    Stages (all permutations/selections are host-built static one-hots):
    1. chunk windows: reshape the envelope to 128-sample rows, concat 4
       shifted views → (R, 512) overlapping windows;
    2. chunk select: a bf16 one-hot (G, R) matmul picks each scan line's
       window, in *alignment-offset-sorted* order (bf16 one-hot select is
       exact up to the f32→bf16 cast of the envelope, ~0.4% — far below
       any capture's noise floor);
    3. alignment: lines sharing ``start % 128`` form one group, so the
       sub-window shift is ONE static slice per group (128 slices);
    4. phase regroup: one-hot matmul into phase-sorted order;
    5. the per-phase interpolation weight einsum (as ``mxu``);
    6. the blend matmul (inverse permutation + vertical blend).

    Rationale: it was built for an accelerator on which gathered rows were
    expensive regardless of width, so the 1200-row span gather (and the
    permutation row gathers) dominated the resample stage and matmul/slice
    formulations of the same movements won.  Whether they win on the GPU is
    not measured yet.
    """
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    start, frac, wr, cols, ratio = _screen_geometry(n_in, y_t, x_t, out_shape)
    span = int(np.ceil(cols[-1] + 1)) + 2
    span_w = -(-span // 128) * 128
    win_w = span_w + 128                      # covers offset (<128) + span
    n_chunks_per_win = win_w // 128
    raw_start = start.reshape(-1)
    flat_start = np.maximum(raw_start, 0)
    flat_frac = np.clip(
        frac.reshape(-1) + (raw_start - flat_start), 0.0, 1.0 - 1e-9
    )
    phase = np.minimum((flat_frac * num_phases).astype(np.int64), num_phases - 1)
    n_lines = 2 * h_out

    weights = _phase_weights(cols, span_w, w_out, num_phases, interp_taps)

    chunk = flat_start // 128
    off = flat_start % 128
    R = int(chunk.max()) + 1

    pack = _pack_slots

    slot_o, per_o = pack(off, 128)
    slot_p, per_p = pack(phase, num_phases)

    sel = np.zeros((128 * per_o, R), np.float32)
    sel[off * per_o + slot_o, chunk] = 1.0
    reg = np.zeros((num_phases * per_p, 128 * per_o), np.float32)
    reg[phase * per_p + slot_p, off * per_o + slot_o] = 1.0
    blend = np.zeros((h_out, num_phases * per_p), np.float32)
    rows = np.repeat(np.arange(h_out), 2)
    coeff = np.stack([1.0 - wr[:, 0], wr[:, 0]], axis=1).reshape(-1)
    blend[rows, phase * per_p + slot_p] += coeff

    # 1+2. chunk select straight off the un-duplicated 128-wide rows: one
    # bf16 one-hot matmul per window-chunk offset against a shifted row view
    # (slices fuse into the matmul operands).  Materialising the overlapped
    # windows first measured 1.27 ms per 12-frame block — over half the
    # whole resample stage — for zero arithmetic benefit.
    pad_len = 128 * (R + n_chunks_per_win)
    sig_pad = jnp.concatenate(
        [sig, jnp.broadcast_to(sig[-1], (pad_len - n_in,)).astype(sig.dtype)]
    )
    rows128 = sig_pad.reshape(-1, 128).astype(jnp.bfloat16)
    sel_b = jnp.asarray(sel, jnp.bfloat16)
    S = jnp.concatenate(
        [jnp.dot(sel_b, rows128[i : R + i],
                 preferred_element_type=jnp.float32)
         for i in range(n_chunks_per_win)],
        axis=1,
    ).reshape(128, per_o, win_w)
    # 3. static per-offset-group alignment slices.
    aligned = jnp.concatenate(
        [jax.lax.slice(S, (o, 0, o), (o + 1, per_o, o + span_w))
         for o in range(128)],
        axis=0,
    ).reshape(128 * per_o, span_w)
    # 4. phase regroup (one-hot matmul), 5. weight einsum, 6. blend matmul.
    # bf16 regroup is LOSSLESS: aligned elements are single bf16-select
    # outputs and the one-hot is 0/1 (see StreamingExactPlan).
    regrouped = jnp.dot(
        jnp.asarray(reg, jnp.bfloat16), aligned.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ).reshape(num_phases, per_p, span_w)
    # The per-phase weight tensor is the stage's device-memory traffic driver
    # (num_phases * span_w * w_out f32 ≈ 78 MB per frame at 1080p);
    # einsum_bf16 halves it (weights are interpolation coefficients in
    # [0, 1] — the bf16 rounding is ~0.2%, below capture noise).
    if einsum_bf16:
        z = jnp.einsum(
            "pbs,psw->pbw", regrouped.astype(jnp.bfloat16),
            jnp.asarray(weights, jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    else:
        z = jnp.einsum(
            "pbs,psw->pbw", regrouped, jnp.asarray(weights),
            preferred_element_type=jnp.float32,
        )
    return jnp.dot(
        jnp.asarray(blend), z.reshape(num_phases * per_p, w_out),
        preferred_element_type=jnp.float32,
    )


def frame_to_screen_mxu4(
    sig: jnp.ndarray,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    interp_taps: int = 2,
) -> jnp.ndarray:
    """``mxu3`` with the alignment stage as ONE grouped convolution.

    Same zero-gather structure as :func:`frame_to_screen_mxu3`, but the
    per-line sub-window shift (``start % 128``) is a depthwise conv whose
    per-line kernel is a single delta at the line's offset — so lines are
    selected once, directly in *phase-sorted* order, and the off-sort +
    regroup matmul of mxu3 disappear:

    1. chunk windows (reshape + shifted concat);
    2. bf16 one-hot chunk select, rows already in phase-sorted order;
    3. depthwise delta-kernel conv → aligned spans (one op, no slices);
    4. per-phase weight einsum;  5. blend matmul.
    """
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    start, frac, wr, cols, ratio = _screen_geometry(n_in, y_t, x_t, out_shape)
    span = int(np.ceil(cols[-1] + 1)) + 2
    span_w = -(-span // 128) * 128
    win_w = span_w + 128
    n_chunks_per_win = win_w // 128
    raw_start = start.reshape(-1)
    flat_start = np.maximum(raw_start, 0)
    flat_frac = np.clip(
        frac.reshape(-1) + (raw_start - flat_start), 0.0, 1.0 - 1e-9
    )
    phase = np.minimum((flat_frac * num_phases).astype(np.int64), num_phases - 1)
    n_lines = 2 * h_out

    weights = _phase_weights(cols, span_w, w_out, num_phases, interp_taps)

    chunk = flat_start // 128
    off = flat_start % 128
    R = int(chunk.max()) + 1

    slot = np.zeros(n_lines, np.int64)
    counts = np.zeros(num_phases, np.int64)
    for e in np.argsort(phase, kind="stable"):
        slot[e] = counts[phase[e]]
        counts[phase[e]] += 1
    per = int(counts.max())
    G = num_phases * per

    key = phase * per + slot
    sel = np.zeros((G, R), np.float32)
    sel[key, chunk] = 1.0
    delta = np.zeros((G, 1, 129), np.float32)  # (out=G, in/group=1, L)
    delta[key, 0, off] = 1.0
    blend = np.zeros((h_out, G), np.float32)
    rows = np.repeat(np.arange(h_out), 2)
    coeff = np.stack([1.0 - wr[:, 0], wr[:, 0]], axis=1).reshape(-1)
    blend[rows, key] += coeff

    pad_len = 128 * (R + n_chunks_per_win)
    sig_pad = jnp.concatenate(
        [sig, jnp.broadcast_to(sig[-1], (pad_len - n_in,)).astype(sig.dtype)]
    )
    rows128 = sig_pad.reshape(-1, 128).astype(jnp.bfloat16)
    sel_b4 = jnp.asarray(sel, jnp.bfloat16)
    # Chunk select off shifted row views — no materialised windows (see
    # frame_to_screen_mxu3).
    S = jnp.concatenate(
        [jnp.dot(sel_b4, rows128[i : R + i],
                 preferred_element_type=jnp.float32)
         for i in range(n_chunks_per_win)],
        axis=1,
    )                                              # (G, win_w), phase-sorted
    aligned = jax.lax.conv_general_dilated(
        S[None],                                   # (1, G, win_w)
        jnp.asarray(delta),
        window_strides=(1,),
        padding="VALID",
        feature_group_count=G,
    )[0][:, :span_w]                               # (G, win_w-128) -> span_w
    z = jnp.einsum(
        "pbs,psw->pbw",
        aligned.reshape(num_phases, per, span_w),
        jnp.asarray(weights),
        preferred_element_type=jnp.float32,
    )
    return jnp.dot(
        jnp.asarray(blend), z.reshape(G, w_out),
        preferred_element_type=jnp.float32,
    )


def _mxu_plan(
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int],
    num_phases: int,
    segments: int = 1,
):
    """Static plan shared by the batched matmul resampler: line geometry, phase
    permutation, and per-phase weight matrices (computed once per config).
    ``frame_len`` is the per-frame sample count (sets the raster↔signal
    ratio); per-line fracs/phases are invariant under *integer* frame-start
    shifts.

    ``segments`` splits every scan line into that many column blocks, each
    with its own (start, frac) entry: the gathered span per entry shrinks by
    ~1/segments (less gather traffic and padding waste) and the per-phase
    weight matrices shrink by ~1/segments² (span × w_out/segments) — e.g. at
    1080p60/20 Msps, segments=4 takes span_pad 384→128 and the weight set
    78 MB→6.5 MB."""
    h_out, w_out = out_shape
    if w_out % segments:
        raise ValueError(f"segments={segments} must divide w_out={w_out}")
    w_seg = w_out // segments
    start, frac, wr, cols, ratio = _screen_geometry(frame_len, y_t, x_t, out_shape)
    if segments > 1:
        # Entry (row, tap, seg) starts at the line position plus the segment's
        # first-column offset; within a segment positions are frac + c*delta
        # with the same shared delta, so the phase machinery is unchanged.
        seg_off = frac[:, :, None].astype(np.float64) + cols[None, None, ::w_seg]
        start = start[:, :, None] + np.floor(seg_off).astype(np.int64)
        frac = (seg_off - np.floor(seg_off)).astype(np.float32)
        cols = cols[:w_seg]
    span = int(np.ceil(cols[-1] + 1)) + 2
    span_pad = -(-span // 128) * 128
    raw_start = start.reshape(-1)
    line_start = np.maximum(raw_start, 0).astype(np.int32)
    line_frac = np.clip(
        frac.reshape(-1) + (raw_start - line_start), -1.0, 1.0 - 1e-6
    ).astype(np.float64)
    phase = np.clip(
        np.floor((line_frac + 1.0) * num_phases).astype(np.int64) - num_phases,
        -num_phases,
        num_phases - 1,
    )
    # Weights for phases in [-P, P): negative fracs only occur at row 0.
    uniq = np.unique(phase)
    phase_index = {p: i for i, p in enumerate(uniq)}
    w_cols = len(cols)
    weights = np.zeros((len(uniq), span_pad, w_cols), np.float32)
    for i, p in enumerate(uniq):
        fp = (p + 0.5) / num_phases
        pos = np.maximum(fp + cols, 0.0)
        i0 = pos.astype(np.int64)
        fr = (pos - i0).astype(np.float32)
        np.add.at(weights[i], (i0, np.arange(w_cols)), 1.0 - fr)
        np.add.at(weights[i], (np.minimum(i0 + 1, span_pad - 1), np.arange(w_cols)), fr)
    pidx = np.array([phase_index[p] for p in phase], np.int64)

    n_lines = 2 * h_out * segments
    order = np.argsort(pidx, kind="stable")
    counts = np.bincount(pidx, minlength=len(uniq))
    per = int(counts.max())
    slot = np.zeros(n_lines, np.int64)
    c = np.zeros(len(uniq), np.int64)
    for idx in order:
        slot[idx] = c[pidx[idx]]
        c[pidx[idx]] += 1
    grid_src = np.zeros((len(uniq), per), np.int64)
    grid_src[pidx, slot] = np.arange(n_lines)
    return {
        "span_pad": span_pad,
        "line_start": line_start,
        "weights": weights,
        "pidx": pidx,
        "slot": slot,
        "grid_src": grid_src,
        "wr": wr,
        "n_phase_mats": len(uniq),
        "per": per,
        "segments": segments,
        "w_seg": w_cols,
    }


def frames_to_screens_mxu(
    env: jnp.ndarray,
    frame_starts: jnp.ndarray | np.ndarray,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    compute_dtype=jnp.bfloat16,
    segments: int = 1,
) -> jnp.ndarray:
    """Batched multi-frame matmul resampler: (n_frames,) integer frame starts →
    (n_frames, h, w) screens in one span gather + ONE batched einsum.

    Because frame starts are integral, every frame shares the same per-line
    fractional phases, so the phase-sorted permutation and weight matrices are
    computed once and the weights are read once per *block* (not per frame) —
    the dominant device-memory traffic of the per-frame variant divided by
    n_frames.
    The spans are gathered directly in phase-sorted order (the permutation is
    folded into the gather indices host-side), so no post-gather relayout
    exists.  ``segments`` splits scan lines into column blocks (smaller spans
    and weights — see ``_mxu_plan``).  Spans/weights contract in
    ``compute_dtype`` (bf16 by default: half the traffic) with
    f32 accumulation.
    """
    h_out, w_out = out_shape
    plan = _mxu_plan(frame_len, y_t, x_t, out_shape, num_phases, segments)
    span_pad = plan["span_pad"]
    n_p, per, w_seg = plan["n_phase_mats"], plan["per"], plan["w_seg"]
    n_frames = int(frame_starts.shape[0])  # static even for traced starts

    env_pad = jnp.concatenate(
        [env, jnp.broadcast_to(env[-1], (span_pad,)).astype(env.dtype)]
    )
    fstarts = jnp.asarray(frame_starts, jnp.int32)            # (F,)
    # Entry starts pre-sorted by phase: (P', per) (padding slots read entry 0).
    sorted_start = plan["line_start"][plan["grid_src"]]
    idx = fstarts[None, :, None] + jnp.asarray(sorted_start)[:, None, :]
    spans = env_pad[idx[..., None] + jnp.arange(span_pad)[None, None, None, :]]
    batched = spans.reshape(n_p, n_frames * per, span_pad)
    w_mat = jnp.asarray(plan["weights"])
    z = jnp.einsum(
        "pbs,psw->pbw",
        batched.astype(compute_dtype),
        w_mat.astype(compute_dtype),
        preferred_element_type=jnp.float32,
    ).reshape(n_p, n_frames, per, w_seg)
    pidx = jnp.asarray(plan["pidx"])
    slot = jnp.asarray(plan["slot"])
    lines = z[pidx, :, slot]                                   # (E, F, w_seg)
    lines = lines.transpose(1, 0, 2).reshape(
        n_frames, h_out, 2, segments * w_seg
    )
    wr = jnp.asarray(plan["wr"])[None]                         # (1, h, 1)
    return lines[:, :, 0, :] * (1.0 - wr) + lines[:, :, 1, :] * wr


def frames_to_screens_mxu3_exact(
    env: jnp.ndarray,
    frame_starts: np.ndarray,
    frac_offsets: np.ndarray,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    einsum_bf16: bool = False,
    interp_taps: int = 2,
) -> jnp.ndarray:
    """Block-level ``mxu3`` with *sub-sample-exact* frame cuts: each frame's
    static fractional boundary residual (``frac_offsets[f]`` ∈ [0, 1)) is
    folded into that frame's host-built geometry tables, so the exact-cut
    fidelity mode runs as matmuls instead of falling back to the 4-tap
    gather resampler.

    Requires static (host-known) starts and offsets — the offline
    ``subsample_align`` path (``carry_phase=False``).  The interpolation
    weight tensor is shared across frames (it depends only on the phase
    quantisation); the per-frame offset only re-assigns lines to chunk /
    alignment / phase groups, i.e. changes the cheap one-hot select /
    regroup / blend matrices, which are stacked and applied as batched
    matmuls.
    """
    h_out, w_out = out_shape
    F = len(frame_starts)
    starts_np = np.asarray(frame_starts, np.int64)
    offs_np = np.asarray(frac_offsets, np.float64)
    n_lines = 2 * h_out

    # Shared geometry pieces (offset-independent).
    base_start, base_frac, wr, cols, _ = _screen_geometry(
        frame_len, y_t, x_t, out_shape)
    span = int(np.ceil(cols[-1] + 1)) + 2
    span_w = -(-span // 128) * 128
    win_w = span_w + 128
    n_chunks_per_win = win_w // 128

    weights = _phase_weights(cols, span_w, w_out, num_phases, interp_taps)

    pack = _pack_slots

    # Per-frame groupings (the fractional offset shifts every line position
    # by the same sub-sample amount; starts/phases re-derive per frame).
    per_frame = []
    R = 0
    per_o = per_p = 0
    a_base = base_start.reshape(-1).astype(np.float64) + base_frac.reshape(-1)
    for f in range(F):
        a = a_base + offs_np[f]
        flat_start = np.maximum(np.floor(a).astype(np.int64), 0)
        flat_frac = np.clip(a - flat_start, 0.0, 1.0 - 1e-9)
        phase = np.minimum((flat_frac * num_phases).astype(np.int64),
                           num_phases - 1)
        chunk = flat_start // 128
        off = flat_start % 128
        slot_o, po = pack(off, 128)
        slot_p, pp = pack(phase, num_phases)
        per_frame.append((chunk, off, phase, slot_o, slot_p))
        R = max(R, int(chunk.max()) + 1)
        per_o, per_p = max(per_o, po), max(per_p, pp)

    # The dense per-frame one-hot tables total hundreds of MB at F=12+
    # (sel F×1280×R f32 alone is 160 MB) — far too large as program
    # constants.  Ship only small integer index tables and build the
    # one-hots ON DEVICE with broadcast compares (XLA folds or fuses them;
    # values are exact).
    G_o = 128 * per_o
    G_p = num_phases * per_p
    sel_src = np.full((F, G_o), -1, np.int32)        # slot -> chunk index
    reg_src = np.full((F, G_p), -1, np.int32)        # phase slot -> o-slot
    blend_idx = np.zeros((F, n_lines), np.int32)     # line tap -> phase slot
    coeff = np.stack([1.0 - wr[:, 0], wr[:, 0]], axis=1).reshape(-1)
    for f, (chunk, off, phase, slot_o, slot_p) in enumerate(per_frame):
        sel_src[f, off * per_o + slot_o] = chunk
        reg_src[f, phase * per_p + slot_p] = off * per_o + slot_o
        blend_idx[f] = phase * per_p + slot_p

    def onehot(src, n, dtype):
        return (jnp.asarray(src)[..., None]
                == jnp.arange(n, dtype=jnp.int32)).astype(dtype)

    sel = onehot(sel_src, R, jnp.bfloat16)                  # (F, G_o, R)
    # bf16 regroup is LOSSLESS (aligned elements are single bf16-select
    # outputs; the one-hot is 0/1) — see StreamingExactPlan.resample_frames.
    reg = onehot(reg_src, G_o, jnp.bfloat16)                # (F, G_p, G_o)
    # blend carries the vertical-blend coefficients on its two taps/row.
    blend = jnp.einsum(
        "l,flg->flg", jnp.asarray(coeff, jnp.float32),
        onehot(blend_idx, G_p, jnp.float32),
    ).reshape(F, h_out, 2, G_p).sum(axis=2)                 # (F, h, G_p)

    # Batched compute: cut (static slices) → windows → select → align →
    # regroup → shared-weight einsum → blend.  Rows must cover both the
    # selected windows AND the whole frame slice.
    pad_len = 128 * max(R + n_chunks_per_win, -(-frame_len // 128))
    frames_sig = jnp.stack([
        jax.lax.dynamic_slice(env, (int(s),), (frame_len,))
        for s in starts_np
    ])
    frames_sig = jnp.concatenate(
        [frames_sig,
         jnp.broadcast_to(frames_sig[:, -1:], (F, pad_len - frame_len))],
        axis=1,
    )
    rows128 = frames_sig.reshape(F, -1, 128).astype(jnp.bfloat16)
    # Chunk select per window-chunk offset straight off the shifted row
    # views — no materialised overlapped windows (see frame_to_screen_mxu3).
    S = jnp.concatenate(
        [jnp.einsum("fgr,frk->fgk", sel, rows128[:, i : R + i],
                    preferred_element_type=jnp.float32)
         for i in range(n_chunks_per_win)],
        axis=2,
    ).reshape(F, 128, per_o, win_w)
    aligned = jnp.concatenate(
        [jax.lax.slice(S, (0, o, 0, o), (F, o + 1, per_o, o + span_w))
         for o in range(128)],
        axis=1,
    ).reshape(F, 128 * per_o, span_w)
    regrouped = jnp.einsum(
        "fgk,fkw->fgw", reg, aligned.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ).reshape(F, num_phases, per_p, span_w)
    if einsum_bf16:
        z = jnp.einsum(
            "fpbs,psw->fpbw", regrouped.astype(jnp.bfloat16),
            jnp.asarray(weights, jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    else:
        z = jnp.einsum(
            "fpbs,psw->fpbw", regrouped, jnp.asarray(weights),
            preferred_element_type=jnp.float32,
        )
    return jnp.einsum(
        "fhg,fgw->fhw", blend,
        z.reshape(F, num_phases * per_p, w_out),
        preferred_element_type=jnp.float32,
    )


class StreamingExactPlan:
    """Carry-phase sub-sample-exact frame cuts at full matmul speed — the
    streaming counterpart of :func:`frames_to_screens_mxu3_exact`.

    In streaming fidelity mode each block's first frame boundary sits at a
    *host-known but per-block-varying* fractional sample offset (the carry
    phase).  Tracing that offset forces the 4-tap gather resampler (measured
    ~5× slower than the mxu3 tables); baking it into constants would need a
    recompile per block.  This plan takes a third route:

    * the phase's fractional part is quantised to ``phase_bins`` bins
      (error ≤ 1/(2·bins) sample — at 64 bins, below the mxu resamplers' own
      1/num_phases line-phase quantisation);
    * for every bin the mxu3 exact-cut *grouping* tables (chunk select /
      phase regroup / vertical blend) are precomputed host-side as small
      **int32 index arrays padded to bin-invariant shapes**, so one compiled
      program — taking the tables as inputs and rebuilding the one-hot
      matrices on device with broadcast compares — serves every bin (no
      per-bin executables to warm, ~20 KB of extra host→device traffic per
      frame per block);
    * the phase's integer part ``m`` shifts the whole block: one traced
      ``dynamic_slice`` re-bases the envelope, after which every frame cut
      is a static slice at ``u[f] = floor(f·spf)`` (the per-frame residuals
      ``f·spf - u[f]`` are folded into the bin tables).

    The interpolation weight tensor — the stage's memory traffic driver — stays
    a shared compile-time constant (it depends only on the line-phase
    quantisation, not on the carry phase).

    The reference's live chain cuts buffer-aligned and visibly drifts
    (``/root/reference/src/GUI.jl:165-166``); this keeps streaming cuts
    sub-sample-exact at matmul throughput.
    """

    def __init__(
        self,
        frame_len: int,
        spf: float,
        n_frames: int,
        y_t: int,
        x_t: int,
        out_shape: tuple[int, int] = RENDER_SIZE,
        num_phases: int = 64,
        phase_bins: int = 64,
        interp_taps: int = 2,
        einsum_bf16: bool = False,
    ) -> None:
        h_out, w_out = out_shape
        self.frame_len = int(frame_len)
        self.spf = float(spf)
        self.n_frames = int(n_frames)
        self.num_phases = int(num_phases)
        self.phase_bins = int(phase_bins)
        self.einsum_bf16 = bool(einsum_bf16)
        self.h_out, self.w_out = h_out, w_out

        base_start, base_frac, wr, cols, _ = _screen_geometry(
            frame_len, y_t, x_t, out_shape)
        span = int(np.ceil(cols[-1] + 1)) + 2
        self.span_w = -(-span // 128) * 128
        self.win_w = self.span_w + 128
        self.n_chunks_per_win = self.win_w // 128
        self.weights = _phase_weights(cols, self.span_w, w_out, num_phases,
                                      interp_taps)
        self.coeff = np.stack([1.0 - wr[:, 0], wr[:, 0]], axis=1).reshape(-1)

        a_base = base_start.reshape(-1).astype(np.float64) + base_frac.reshape(-1)
        n_lines = 2 * h_out
        F, K = self.n_frames, self.phase_bins
        # Static frame-cut starts and residuals: frame f's exact boundary is
        # m + k/K + u[f] + r[f]; the cut happens at the static u[f] and the
        # whole sub-sample remainder k/K + r[f] ∈ [0, 2) folds into the
        # per-bin line tables (floor handles the extra integer sample).
        self.u = np.floor(np.arange(F) * self.spf).astype(np.int64)
        r = np.arange(F) * self.spf - self.u

        # Groupings for every (bin, frame) in ONE vectorised pass — the
        # per-(bin, frame) Python loop this replaces cost ~1.3 s at 36f/64
        # bins, paid on every operator line/refresh nudge.  Only the compact
        # geometry keys (chunk/off/phase, ≤int16, ~16 MB at 36f) and the
        # global shape maxima are computed eagerly; the index TABLES build
        # lazily per bin on first use (``tables(k)``, ~1 ms each) so a nudge
        # costs the geometry pass only and streaming warms bins as the carry
        # phase actually visits them.
        # Position decomposition: a = a_base + s with s = k/K + r[f] ∈
        # [0, ~3).  Splitting a_base into integer/fractional parts once
        # keeps the big (K, F, n_lines) arrays in ONE float64 pass (the
        # fractional sum g = frac(a_base) + s) plus int16 arithmetic —
        # floor(a) = floor(a_base) + floor(g) exactly, and all the grouping
        # keys derive from floor(a_base) (per-line constants) and floor(g)/
        # frac(g).  (float32 would be 0.02-sample wrong at 20 Msps frame
        # positions — the fractional track must stay float64.)
        ib = np.floor(a_base).astype(np.int64)              # (n_lines,)
        fb = a_base - ib                                    # exact in f64
        ib_chunk = (ib >> 7).astype(np.int16)               # floor-div 128
        ib_off = (ib & 127).astype(np.int16)                # floor-mod 128
        shift = np.arange(K, dtype=np.float64)[:, None] / K + r[None, :]
        g = fb[None, None, :] + shift[:, :, None]           # (K, F, n_lines)
        gi = g.astype(np.int16)                             # floor (g >= 0)
        frac = g - gi
        frac *= num_phases
        self._phase = np.minimum(frac.astype(np.int16), num_phases - 1)
        del g, frac
        off = ib_off[None, None, :] + gi                    # int16
        carry = off >> 7                                    # floor-div 128
        self._off = off - (carry << 7)
        self._chunk = ib_chunk[None, None, :] + carry
        # Clamp-at-zero parity with the scalar formulation: a line's leading
        # interpolation tap can sit before the frame start (a < 0 — one line
        # at 1080p); the cut clamps it to sample 0 with zero fractional
        # phase.  fstart < 0 iff its chunk is negative (floor semantics).
        neg = self._chunk < 0
        if neg.any():
            self._chunk[neg] = 0
            self._off[neg] = 0
            self._phase[neg] = 0
        self.R = int(self._chunk.max()) + 1
        # Exact global slot maxima from multiplicity counts (bincount over
        # per-row composite keys) — no packing needed to size the tables.
        rows = np.arange(K * F, dtype=np.int64)[:, None]
        self.per_o = int(np.bincount(
            (rows * 128 + self._off.reshape(K * F, n_lines)).ravel(),
            minlength=K * F * 128).max())
        self.per_p = int(np.bincount(
            (rows * num_phases
             + self._phase.reshape(K * F, n_lines)).ravel(),
            minlength=K * F * num_phases).max())
        self._bin_tables: dict[int, tuple] = {}
        self._stacks: tuple | None = None

        # Device layout: rows must cover the selected windows AND the frame.
        self.pad_len = 128 * max(self.R + self.n_chunks_per_win,
                                 -(-self.frame_len // 128))
        # Envelope samples needed past the traced shift m: the last frame's
        # slice end.  A carry_phase block holds ⌈spf·F⌉+1+⌈spf⌉ samples and
        # m ≤ ⌊spf⌋+1, so m + L0 always fits (asserted in the jitted step).
        self.L0 = int(self.u[-1]) + self.frame_len

    # ----------------------------------------------------------- host side
    def bin_for_phase(self, phase: float) -> tuple[int, int]:
        """Quantise a block's carry phase (fractional sample offset of the
        first frame boundary, in [0, spf)) → (bin index, integer shift)."""
        m = int(np.floor(phase))
        q = float(phase) - m
        k = int(round(q * self.phase_bins))
        if k >= self.phase_bins:
            k -= self.phase_bins
            m += 1
        return k, m

    def _build_rows(self, off: np.ndarray, phase: np.ndarray,
                    chunk: np.ndarray):
        """Index tables for a (B, n_lines) batch of grouping keys: stable
        slot packing + one scatter per table (-1 = empty slot → zero one-hot
        row on device).  Shared by the per-bin lazy build and the full-stack
        build, so both produce identical tables."""
        b, n_lines = off.shape
        slot_o, po = _pack_slots_batch(off)
        slot_p, pp = _pack_slots_batch(phase)
        assert po <= self.per_o and pp <= self.per_p  # global maxima hold
        o_slot = off.astype(np.int64) * self.per_o + slot_o
        p_slot = phase.astype(np.int64) * self.per_p + slot_p
        sel = np.full((b, 128 * self.per_o), -1, np.int32)
        np.put_along_axis(sel, o_slot, chunk.astype(np.int32), -1)
        reg = np.full((b, self.num_phases * self.per_p), -1, np.int32)
        np.put_along_axis(reg, p_slot, o_slot.astype(np.int32), -1)
        return sel, reg, p_slot.astype(np.int32)

    def tables(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Bin k's grouping tables (sel_src, reg_src, blend_idx) — built on
        first use (~1 ms) and cached; a streaming session only ever pays for
        the bins its carry phase visits."""
        t = self._bin_tables.get(k)
        if t is None:
            t = self._build_rows(self._off[k], self._phase[k],
                                 self._chunk[k])
            self._bin_tables[k] = t
        return t

    def _all_tables(self):
        if self._stacks is None:
            K, F, n_lines = self._off.shape
            flat = lambda x: x.reshape(K * F, n_lines)  # noqa: E731
            sel, reg, blend = self._build_rows(
                flat(self._off), flat(self._phase), flat(self._chunk))
            self._stacks = (sel.reshape(K, F, -1), reg.reshape(K, F, -1),
                            blend.reshape(K, F, n_lines))
        return self._stacks

    # Full (K, ...) table stacks — the batched fidelity serving path keeps
    # them device-resident and gathers by traced bin index; built on first
    # access (one batched pass over all bins).
    @property
    def sel_src(self) -> np.ndarray:
        return self._all_tables()[0]

    @property
    def reg_src(self) -> np.ndarray:
        return self._all_tables()[1]

    @property
    def blend_idx(self) -> np.ndarray:
        return self._all_tables()[2]

    # --------------------------------------------------------- device side
    def resample(
        self,
        env: jnp.ndarray,
        m: jnp.ndarray,
        sel_src: jnp.ndarray,
        reg_src: jnp.ndarray,
        blend_idx: jnp.ndarray,
    ) -> jnp.ndarray:
        """Traceable: (env, traced shift, traced bin tables) → (F, h, w)
        screens.  Same compute graph as ``frames_to_screens_mxu3_exact``
        with the one-hot select/regroup/blend matrices rebuilt on device
        from the int32 tables (broadcast compares — exact values)."""
        return self.resample_frames(self.cut(env, m), sel_src, reg_src,
                                    blend_idx)

    def cut(self, env: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
        """One traced re-base by the integer phase, then static frame cuts:
        (env, m) → (n_frames, pad_len) signal slices."""
        env_m = jax.lax.dynamic_slice(env, (m,), (self.L0,))
        env_m = jnp.concatenate([
            env_m,
            jnp.broadcast_to(env_m[-1],
                             (self.pad_len - self.frame_len,)).astype(env_m.dtype),
        ])
        return jnp.stack([
            jax.lax.slice(env_m, (int(uf),), (int(uf) + self.pad_len,))
            for uf in self.u
        ])

    def cut_words_am(self, words: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
        """Fused AM demod + cut from raw *interleaved* I/Q words: slice the
        int16 wire buffer FIRST (envelope index ``i`` ↔ words ``2i, 2i+1``,
        so slicing commutes exactly with the pointwise pair demod), then
        demodulate the per-frame rows — ``(words, m) → (n_frames, pad_len)``
        envelope slices, bit-identical to ``cut(am_envelope_from_iq(words),
        m)`` (each output element is the same ``sqrt(I²+Q²)`` pair dot
        through the same one-hot pair-sum matmul; only the row partitioning
        changes).

        The intent was to skip the whole-block envelope, its traced re-base
        and the padded concat (three full-length f32 materialisation
        points) by moving int16 bytes instead.  It lost on the accelerator
        it was built for (one contiguous whole-block demod pass fused better
        than F overlapping per-frame passes); not measured on the GPU yet.
        Selectable through ``ReconstructionConfig.fuse_demod_cut``;
        bit-exactness is regression-tested."""
        from .demod import _PAIRSUM, MOVE_PRECISION  # one-hot pair sum

        w_m = jax.lax.dynamic_slice(words, (2 * m,), (2 * self.L0,))
        pad = self.pad_len - self.frame_len
        # Replicate the last I/Q PAIR: the padded envelope equals the
        # envelope path's broadcast of env_m[-1].
        tail = jnp.broadcast_to(w_m[-2:], (pad, 2)).reshape(-1)
        w_m = jnp.concatenate([w_m, tail.astype(w_m.dtype)])
        rows = jnp.stack([
            jax.lax.slice(w_m, (2 * int(uf),), (2 * (int(uf) + self.pad_len),))
            for uf in self.u
        ])                                             # (F, 2·pad_len) int16
        x = rows.astype(jnp.float32).reshape(self.n_frames, -1, 128)
        e2 = jnp.einsum("frk,ko->fro", x * x, jnp.asarray(_PAIRSUM),
                        preferred_element_type=jnp.float32,
                        precision=MOVE_PRECISION)
        return jnp.sqrt(e2).reshape(self.n_frames, self.pad_len)

    def resample_frames(
        self,
        frames_sig: jnp.ndarray,
        sel_src: jnp.ndarray,
        reg_src: jnp.ndarray,
        blend_idx: jnp.ndarray,
    ) -> jnp.ndarray:
        """(G, pad_len) pre-cut frame slices + per-frame tables → (G, h, w).
        ``G`` may be any frame count (e.g. B·n_frames for batched serving —
        the graph treats frames independently and the weight tensor is
        shared), as long as each slice's tables were built by this plan."""
        F, P = frames_sig.shape[0], self.num_phases
        rows128 = frames_sig.reshape(F, -1, 128).astype(jnp.bfloat16)
        sel = (sel_src[..., None]
               == jnp.arange(self.R, dtype=jnp.int32)).astype(jnp.bfloat16)
        S = jnp.concatenate(
            [jnp.einsum("fgr,frk->fgk", sel, rows128[:, i : self.R + i],
                        preferred_element_type=jnp.float32)
             for i in range(self.n_chunks_per_win)],
            axis=2,
        ).reshape(F, 128, self.per_o, self.win_w)
        aligned = jnp.concatenate(
            [jax.lax.slice(S, (0, o, 0, o),
                           (F, o + 1, self.per_o, o + self.span_w))
             for o in range(128)],
            axis=1,
        ).reshape(F, 128 * self.per_o, self.span_w)
        # Regroup in pure bf16 — LOSSLESS: every `aligned` element is a single
        # envelope sample that already went through the bf16 select cast
        # (bf16 × 1.0 accumulated in f32), so the cast back is exact, and the
        # one-hot is 0/1.  Halves the stage's materialised bytes (max abs
        # err 0.0 against the f32 regroup).
        reg = (reg_src[..., None]
               == jnp.arange(128 * self.per_o, dtype=jnp.int32)).astype(jnp.bfloat16)
        regrouped = jnp.einsum(
            "fgk,fkw->fgw", reg, aligned.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).reshape(F, P, self.per_p, self.span_w)
        if self.einsum_bf16:
            # Weights in bf16 (f32 accumulation): half the weight bytes at
            # <= 2^-9 relative coefficient rounding (~0.2% on the image).
            z = jnp.einsum(
                "fpbs,psw->fpbw", regrouped.astype(jnp.bfloat16),
                jnp.asarray(self.weights, jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        else:
            z = jnp.einsum(
                "fpbs,psw->fpbw", regrouped, jnp.asarray(self.weights),
                preferred_element_type=jnp.float32,
            )
        G_p = P * self.per_p
        blend = (
            jnp.asarray(self.coeff, jnp.float32)[None, :, None]
            * (blend_idx[..., None]
               == jnp.arange(G_p, dtype=jnp.int32)).astype(jnp.float32)
        ).reshape(F, self.h_out, 2, G_p).sum(axis=2)
        return jnp.einsum(
            "fhg,fgw->fhw", blend, z.reshape(F, G_p, self.w_out),
            preferred_element_type=jnp.float32,
        )


def frames_to_screens_aligned(
    env: jnp.ndarray,
    frame_starts: jnp.ndarray | np.ndarray,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> jnp.ndarray:
    """Aligned-chunk resampler: (n_frames,) starts → (n_frames, h, w) screens.

    Built for an accelerator on which gathers with arbitrary element offsets
    were slow but gathers of 128-sample-aligned rows ran near streaming
    speed.  So: gather each scanline's span as whole 128-sample
    chunks of the envelope (alignment offset absorbed into the in-row
    position), then interpolate within rows with ``take_along_axis`` (small
    extent) and blend the two vertical taps.  Bit-compatible with
    ``frame_to_screen`` away from frame edges.
    """
    h_out, w_out = out_shape
    start, frac, wr, cols, ratio = _screen_geometry(frame_len, y_t, x_t, out_shape)
    span = int(np.ceil(cols[-1] + 1)) + 2
    n_chunks = (span + 127) // 128 + 1          # covers span + max offset 127
    span_w = 128 * n_chunks
    n_lines = 2 * h_out

    raw_start = start.reshape(-1)
    line_start = np.maximum(raw_start, 0)
    line_frac = (frac.reshape(-1) + (raw_start - line_start)).astype(np.float32)

    fstarts = jnp.asarray(frame_starts, jnp.int32)
    n_frames = int(fstarts.shape[0])
    abs_start = (fstarts[:, None] + jnp.asarray(line_start, jnp.int32)[None, :]).reshape(-1)
    base_chunk = abs_start // 128
    off = (abs_start % 128).astype(jnp.float32)

    # Envelope as aligned chunk rows, padded so the last spans stay in range.
    pad_to = (int(env.shape[0]) + 128 * (n_chunks + 1) + 127) // 128 * 128
    env_pad = jnp.concatenate(
        [env.astype(jnp.float32),
         jnp.broadcast_to(env[-1], (pad_to - env.shape[0],)).astype(jnp.float32)]
    )
    ch = env_pad.reshape(-1, 128)
    blocks = ch[base_chunk[:, None] + jnp.arange(n_chunks)[None, :]]
    spans = blocks.reshape(n_frames * n_lines, span_w)

    # In-span fractional positions: alignment offset + line frac + c*delta.
    pos = (
        off[:, None]
        + jnp.tile(jnp.asarray(line_frac), n_frames)[:, None]
        + jnp.asarray(cols.astype(np.float32))[None, :]
    )
    pos = jnp.clip(pos, 0.0, span_w - 1.001)
    i0 = pos.astype(jnp.int32)
    fr = pos - i0.astype(jnp.float32)
    lines = (
        jnp.take_along_axis(spans, i0, axis=1) * (1.0 - fr)
        + jnp.take_along_axis(spans, i0 + 1, axis=1) * fr
    )
    lines = lines.reshape(n_frames, h_out, 2, w_out)
    wrj = jnp.asarray(wr)[None]
    return lines[:, :, 0, :] * (1.0 - wrj) + lines[:, :, 1, :] * wrj


def frames_to_screens_fft(
    env: jnp.ndarray,
    frame_starts: jnp.ndarray | np.ndarray,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    l_pad: int | None = None,
) -> jnp.ndarray:
    """Gather-free resampler via spectral line rectification.

    Bandlimited-resample each frame's envelope from ``frame_len`` samples to
    exactly ``y_t * l_pad`` samples (rfft → zero-pad/truncate spectrum →
    irfft): scan line ``l`` then occupies out[l*l_pad : (l+1)*l_pad] *exactly*
    — a plain reshape puts every line at an integer stride, so no per-line
    gathers exist at all.  Columns interpolate through ONE shared
    (l_pad × w_out) weight matrix (the within-line position map is
    line-invariant), and the vertical blend selects whole rows (aligned row
    reads).

    Compared to the linear-interpolation variants this is *sinc*
    interpolation: exact for band-limited content, with circular (not
    clamped) frame-edge semantics.
    """
    h_out, w_out = out_shape
    if l_pad is None:
        l_pad = -(-(int(np.ceil(frame_len / y_t)) + 2) // 128) * 128
    m_out = y_t * l_pad
    n_bins = min(frame_len // 2 + 1, m_out // 2 + 1)
    scale = m_out / frame_len

    # Shared column weights: raster px c maps within any line to
    # q(c) = (cx_c + 0.5) * l_pad / x_t - 0.5 * m_out / frame_len.  The first
    # columns of a line read slightly *before* its boundary (into the previous
    # line's tail) and the last slightly after; each reshaped line is extended
    # by its neighbours' edge samples (rolls, no gathers) so no position is
    # ever clamped.
    cx = np.clip((np.arange(w_out) + 0.5) * (x_t / w_out) - 0.5, 0.0, x_t - 1.0)
    q = (cx + 0.5) * (l_pad / x_t) - 0.5 * scale
    ext_lo = max(0, -int(np.floor(q.min())))          # previous-line tail
    ext_hi = max(0, int(np.floor(q.max())) + 2 - l_pad)  # next-line head
    q = q + ext_lo
    i0 = q.astype(np.int64)
    fr = (q - i0).astype(np.float32)
    width = ext_lo + l_pad + ext_hi
    w_col = np.zeros((width, w_out), np.float32)
    w_col[i0, np.arange(w_out)] = 1.0 - fr
    w_col[i0 + 1, np.arange(w_out)] += fr

    # Vertical geometry (same half-pixel convention as frame_to_screen).
    ry = np.clip((np.arange(h_out) + 0.5) * (y_t / h_out) - 0.5, 0.0, y_t - 1.0)
    r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
    wr = jnp.asarray((ry - r0).astype(np.float32)[:, None])
    r0j = jnp.asarray(r0)
    w_colj = jnp.asarray(w_col)
    halve_nyquist = frame_len % 2 == 0 and m_out > frame_len

    def one_frame(start):
        sig = jax.lax.dynamic_slice(env, (start,), (frame_len,))
        spec = jnp.fft.rfft(sig)[:n_bins]
        if halve_nyquist:
            # The even-length Nyquist bin represents both +/-fs/2; keep only
            # half its weight when embedding into the larger spectrum.
            spec = spec.at[n_bins - 1].multiply(0.5)
        spec_m = jnp.zeros((m_out // 2 + 1,), spec.dtype).at[:n_bins].set(spec)
        lines = (jnp.fft.irfft(spec_m, n=m_out) * scale).reshape(y_t, l_pad)
        parts = []
        if ext_lo:
            parts.append(jnp.roll(lines, 1, axis=0)[:, -ext_lo:])
        parts.append(lines)
        if ext_hi:
            parts.append(jnp.roll(lines, -1, axis=0)[:, :ext_hi])
        ext = jnp.concatenate(parts, axis=1) if len(parts) > 1 else lines
        blended = ext[r0j] * (1.0 - wr) + ext[r0j + 1] * wr   # (h, width)
        return jnp.dot(blended, w_colj, preferred_element_type=jnp.float32)

    return jax.vmap(one_frame)(jnp.asarray(frame_starts, jnp.int32))


def frame_to_screen_dynamic(
    sig: jnp.ndarray,
    y_t: jnp.ndarray,
    x_t: jnp.ndarray,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> jnp.ndarray:
    """``frame_to_screen`` with *traced* raster geometry.

    ``y_t`` / ``x_t`` are data, not trace constants, so one compiled program
    evaluates any candidate video mode — this is what lets the multi-mode
    hypothesis search vmap/shard candidates across devices without a
    recompile per mode (SURVEY.md §2 "parallelism strategies", hypothesis
    parallel).  Costs one dynamic gather instead of a constant-index gather.
    """
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    y_t = jnp.asarray(y_t, jnp.float32)
    x_t = jnp.asarray(x_t, jnp.float32)
    ratio = n_in / (y_t * x_t)
    ry = jnp.clip(
        (jnp.arange(h_out, dtype=jnp.float32) + 0.5) * (y_t / h_out) - 0.5,
        0.0, y_t - 1.0,
    )
    cx = jnp.clip(
        (jnp.arange(w_out, dtype=jnp.float32) + 0.5) * (x_t / w_out) - 0.5,
        0.0, x_t - 1.0,
    )
    r0 = jnp.minimum(jnp.floor(ry), jnp.maximum(y_t - 2.0, 0.0))
    wr = (ry - r0)[:, None]

    def line_sample(line_idx: jnp.ndarray) -> jnp.ndarray:
        flat = line_idx[:, None] * x_t + cx[None, :]
        pos = jnp.clip((flat + 0.5) * ratio - 0.5, 0.0, n_in - 1.0)
        i0 = jnp.minimum(jnp.floor(pos).astype(jnp.int32), max(n_in - 2, 0))
        frac = pos - i0.astype(jnp.float32)
        return sig[i0] * (1.0 - frac) + sig[i0 + 1] * frac

    top = line_sample(r0)
    bot = line_sample(jnp.minimum(r0 + 1.0, y_t - 1.0))
    return top * (1.0 - wr) + bot * wr


def fractional_shift(
    sig: jnp.ndarray,
    frac,
    num_phases: int = 128,
    taps: int = 8,
) -> jnp.ndarray:
    """Windowed-sinc sub-sample advance: ``out[i] ≈ sig(i + frac)`` for a
    (possibly traced) ``frac`` in [0, 1).

    Used for sub-sample-exact frame cuts (super-resolution accumulation): a
    frame boundary generically falls between samples; slicing at the rounded
    integer leaves a ±0.5-sample phase error per frame that blurs the
    multi-frame average.  Interpolating the slice at its true fractional
    offset aligns every frame's sampling grid exactly — and because the AM
    envelope has twice the IQ bandwidth (|z| doubles bandwidth), frames cut
    at diverse fractional offsets genuinely sample *between* each other's
    grid points, so the aligned average recovers detail beyond one frame's
    sampling (no reference counterpart — the reference cuts buffer-aligned
    and drifts, ``GUI.jl:165-166``).
    """
    bank = jnp.asarray(polyphase_filter_bank(num_phases, taps, 1.0))
    phase = jnp.clip(
        (jnp.asarray(frac, jnp.float32) * num_phases).astype(jnp.int32),
        0, num_phases - 1,
    )
    h = bank[phase]                       # (taps,)
    half = taps // 2
    pad = jnp.pad(sig, (half - 1, half), mode="edge")
    n = sig.shape[0]
    out = jnp.zeros_like(sig)
    for j in range(taps):
        out = out + h[j] * jax.lax.dynamic_slice(pad, (j,), (n,))
    return out


def naive_upsample(sig: jnp.ndarray, up: int) -> jnp.ndarray:
    """Sample-repeat upsampling (reference ``naiveResampler``,
    ``Resampler.jl:103-110``)."""
    return jnp.repeat(sig, up)


def make_fft_upsampler_filter(n_fft: int, up: int) -> np.ndarray:
    """Frequency response of a linear-phase Blackman-apodised low-pass with
    cutoff π/up, synthesised by frequency sampling — the same *method* as the
    reference's ``initLPF`` (``Resampler.jl:83-99``), built host-side once per
    (n_fft, up) and folded into the jitted graph as a constant."""
    # Ideal brick wall over the positive-frequency bins only (the reference
    # keeps one side and recovers with 2*Re(.) afterwards; we do the same).
    bound = int(round(n_fft / up / 2))
    mag = np.zeros(n_fft)
    mag[:bound] = 1.0
    # Linear phase (group delay (N-1)/2) centres the impulse response under
    # the Blackman window...
    k = np.arange(n_fft)
    h = np.fft.ifft(mag * np.exp(-1j * np.pi * (n_fft - 1) * k / n_fft))
    h = h * np.blackman(n_fft)
    # ...and the (-1)^k on the *frequency* response circularly shifts the
    # windowed filter back by N/2, undoing that delay (``Resampler.jl:97``).
    return (np.fft.fft(h) * (-1.0) ** k).astype(np.complex64)


def upsample_fft(sig: jnp.ndarray, up: int) -> jnp.ndarray:
    """Integer upsampling by zero-stuffing + frequency-domain low-pass
    (reference ``init_resampler`` closure, ``Resampler.jl:42-60``): output is
    ``2 * up * Re(ifft(fft(stuffed) * H))``."""
    n_fft = sig.shape[0] * up
    stuffed = jnp.zeros((n_fft,), sig.dtype).at[::up].set(sig)
    h = jnp.asarray(make_fft_upsampler_filter(n_fft, up))
    out = jnp.fft.ifft(jnp.fft.fft(stuffed) * h)
    return 2.0 * up * jnp.real(out)


def polyphase_filter_bank(
    num_phases: int = 64, taps_per_phase: int = 8, cutoff: float = 1.0
) -> np.ndarray:
    """Windowed-sinc polyphase bank: (num_phases, taps_per_phase) float32.

    Phase ``p`` holds the interpolation filter for fractional offset
    ``p / num_phases``; ``cutoff`` ≤ 1 scales the passband (set to
    ``min(1, out_rate/in_rate)`` when decimating, for anti-aliasing).
    """
    half = taps_per_phase // 2
    taps = np.empty((num_phases, taps_per_phase), np.float64)
    for p in range(num_phases):
        frac = p / num_phases
        t = np.arange(-half + 1, half + 1) - frac  # offsets of contributing samples
        x = cutoff * t
        s = cutoff * np.sinc(x)
        # Blackman window over the tap support.
        w = np.blackman(2 * taps_per_phase + 1)
        win = np.interp(t, np.linspace(-half, half, 2 * taps_per_phase + 1), w)
        taps[p] = s * win
        total = taps[p].sum()
        if abs(total) > 1e-9:
            taps[p] /= total  # unity DC gain per phase
    return taps.astype(np.float32)


@partial(jax.jit, static_argnames=("n_out", "num_phases", "taps_per_phase"))
def _polyphase_apply(
    sig: jnp.ndarray,
    ratio: jnp.ndarray,
    bank: jnp.ndarray,
    n_out: int,
    num_phases: int,
    taps_per_phase: int,
) -> jnp.ndarray:
    half = taps_per_phase // 2
    # Tap j of phase p weights input sample base - (half-1) + j (the bank's
    # sinc argument grid is arange(-half+1, half+1) - frac).
    pad = jnp.pad(sig, (half - 1, half + 1), mode="edge")
    # Fractional input position of every output sample; ratio may be traced
    # (pixel-clock lock) — only positions depend on it, shapes are static.
    pos = jnp.arange(n_out, dtype=jnp.float32) * ratio
    base = jnp.floor(pos).astype(jnp.int32)
    frac = pos - base
    phase = jnp.clip((frac * num_phases).astype(jnp.int32), 0, num_phases - 1)
    # (n_out, taps) windows + matching phase filters, contracted on taps.
    offs = jnp.arange(taps_per_phase, dtype=jnp.int32)[None, :]
    windows = pad[base[:, None] + offs]
    return jnp.sum(windows * bank[phase], axis=-1)


def polyphase_resample(
    sig: jnp.ndarray,
    n_out: int,
    ratio: jnp.ndarray | float,
    num_phases: int = 64,
    taps_per_phase: int = 8,
    cutoff: float | None = None,
) -> jnp.ndarray:
    """Fractional resampling: output sample ``i`` interpolates the input at
    position ``i * ratio`` through a windowed-sinc polyphase bank.

    ``ratio`` (input samples per output sample) may be a traced scalar, so the
    pipeline can lock the resampling ratio to the *estimated* pixel clock
    without recompiling (SURVEY.md §7 "hard parts" (1)).  ``n_out`` is static.
    """
    if cutoff is None:
        if isinstance(ratio, jnp.ndarray):
            raise ValueError(
                "polyphase_resample: with a traced ratio the anti-aliasing "
                "cutoff cannot be derived at trace time — pass cutoff "
                "explicitly (1.0 for upsampling, <= 1/max_ratio when "
                "decimating)"
            )
        r = float(ratio)
        cutoff = 1.0 if r <= 1.0 else 1.0 / r
    bank = jnp.asarray(polyphase_filter_bank(num_phases, taps_per_phase, cutoff))
    return _polyphase_apply(
        sig,
        jnp.asarray(ratio, jnp.float32),
        bank,
        n_out,
        num_phases,
        taps_per_phase,
    )
