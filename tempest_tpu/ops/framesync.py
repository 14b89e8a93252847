"""Frame synchronisation: locate the blanking interval on each image axis.

Capability parity with the reference's ``FrameSynchronisation`` module
(``/root/reference/src/FrameSynchronisation.jl:19-129``): project the image
onto each axis, smooth with a small Gaussian, and for every candidate blanking
centre ``c`` and blanking width ``w`` score the contrast between the mean level
inside the (circular) window ``[c-w, c+w]`` and outside it —

    beta[w, c] = ((S - S_w(c)) / (2 (n - w)) + S_w(c) / (2 w))^2,
    S_w(c) = 2 * sum_{k=c-w..c+w} profile[k mod n]

(the reference's ``fill_β!`` recurrence, ``FrameSynchronisation.jl:94-112``).
The argmax over (w, c) gives the blanking centre, i.e. the frame offset.

Design: the reference updates ``S_w`` incrementally in an O(n·w) scalar
double loop.  Every circular window sum for *all* (c, w) pairs is a
difference of two entries of one prefix sum over a wrap-padded profile, so the
whole score matrix is static slices + elementwise math — a single XLA fusion
with no sequential dependence (SURVEY.md §7 step 2).

Bug fixed relative to the reference: ``vsync`` there fills ``β_x`` from the
column profile but reads the argmax from ``β_y`` and vice versa
(``FrameSynchronisation.jl:65-66`` vs ``:75-76``), so each axis's answer comes
from the *other* axis's stale scores.  Here each axis is scored and read
consistently.  We also apply the Gaussian smoothing zero-phase ('same'
correlation) instead of the reference's causal ``filt``, which shifted the
detected centre by half the kernel length.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "SyncSpec",
    "sync_spec_for_axis",
    "gaussian_kernel",
    "smooth_profile",
    "blank_scores",
    "contrast_scores",
    "find_blank",
    "find_blank_subpixel",
    "frame_sync",
    "frame_sync_subpixel",
    "align_frame",
    "align_frame_subpixel",
    "align_frame_subpixel_matmul",
    "shift_matrix",
]


@dataclasses.dataclass(frozen=True)
class SyncSpec:
    """Search bounds for one axis (reference ``Sync``,
    ``FrameSynchronisation.jl:19-23``)."""

    w_min: int  # minimum blanking half-width
    w_max: int  # maximum blanking half-width
    n: int      # profile length (lines or columns)


def sync_spec_for_axis(n: int, min_fraction: float) -> SyncSpec:
    """Reference bounds (``FrameSynchronisation.jl:36-41``): w in
    [ceil(min_fraction * n), floor(n / 4)]; min_fraction is 1% for the row
    (y) axis and 5% for the column (x) axis."""
    return SyncSpec(int(np.ceil(min_fraction * n)), int(np.floor(n / 4)), n)


def gaussian_kernel(n: int = 5) -> np.ndarray:
    """Normalised Gaussian FIR ``exp(-2 k^2 / n^2)``, k in [-(n-1)/2, (n-1)/2]
    (reference ``init_gaussian_filter``, ``FrameSynchronisation.jl:124-129``)."""
    assert n % 2 == 1, "Gaussian kernel length must be odd"
    k = np.arange(n) - (n - 1) // 2
    h = np.exp(-2.0 * k**2 / n**2)
    return (h / h.sum()).astype(np.float32)


def smooth_profile(profile: jnp.ndarray, kernel_len: int = 5) -> jnp.ndarray:
    """Zero-phase Gaussian smoothing with circular wrap (the profile is a
    circular quantity — the blanking window itself wraps).

    Computed as ``kernel_len`` shifted slice-multiplies (exact f32 adds) —
    an f32 convolution at DEFAULT precision may run reduced-precision passes
    (TF32 on the GPU), whose quantisation perturbs the downstream argmax and
    sub-pixel parabola."""
    h = gaussian_kernel(kernel_len)
    half = kernel_len // 2
    n = profile.shape[0]
    padded = jnp.concatenate([profile[-half:], profile, profile[:half]])
    out = h[0] * jax.lax.slice(padded, (0,), (n,))
    for k in range(1, kernel_len):
        out = out + h[k] * jax.lax.slice(padded, (k,), (k + n,))
    return out


def _circular_prefix(profile: jnp.ndarray, w_max: int) -> jnp.ndarray:
    """Prefix sum (leading zero) of the wrap-padded profile: ``P[k] =
    sum(ext[:k])`` with ``ext = [tail w_max | profile | head w_max]``."""
    ext = jnp.concatenate([profile[-w_max:], profile, profile[:w_max]])
    return jnp.concatenate([jnp.zeros((1,), profile.dtype), jnp.cumsum(ext)])


def _window_sums(profile: jnp.ndarray, spec: SyncSpec) -> jnp.ndarray:
    """Circular window sums ``W[w, c] = sum(profile[c-w : c+w+1])`` for all
    (w in [w_min, w_max], c) as a (W, n) matrix.

    One prefix sum over the wrap-padded profile, then row w of the matrix is
    ``P[c + w_max+w+1] − P[c + w_max−w]`` — a STATIC SLICE pair per width,
    stacked.  Pure f32 adds: exact, no matmul or convolution involved.

    Of the three formulations tried, an index-matrix read lowers to
    per-element gathers; the Toeplitz ±delta-kernel conv is one op but a
    reduced-precision conv pass (bf16 then, TF32 on the GPU) rounds the
    large-magnitude prefix and corrupted the argmax (−0.8 dB PSNR); the
    slice stack is bit-exact and XLA folds the static slice/concat family."""
    n = spec.n
    w_max = spec.w_max
    prefix = _circular_prefix(profile, w_max)
    rows = [
        jax.lax.slice(prefix, (w_max + w + 1,), (w_max + w + 1 + n,))
        - jax.lax.slice(prefix, (w_max - w,), (w_max - w + n,))
        for w in range(spec.w_min, w_max + 1)
    ]
    return jnp.stack(rows)


def _blank_score(window, total, w, n):
    """Reference ``fill_β!`` score from a window sum (scalar or array) —
    the single definition shared by the (w, c) matrix and the sub-pixel
    parabola's exact re-reads."""
    beta = (total - 2.0 * window) / (2.0 * (n - w)) + window / w
    return beta * beta


def _contrast_score(window, total, w, n):
    """Polarity-symmetric score ``(mean inside − mean outside)^2`` from a
    window sum — shared like :func:`_blank_score`."""
    size = 2.0 * w + 1.0
    d = window / size - (total - window) / (n - size)
    return d * d


def blank_scores(profile: jnp.ndarray, spec: SyncSpec) -> jnp.ndarray:
    """Score matrix beta of shape (w_max - w_min + 1, n) for all blanking
    hypotheses — the vectorised ``fill_β!``."""
    total = jnp.sum(profile)
    ws = jnp.arange(spec.w_min, spec.w_max + 1)[:, None].astype(profile.dtype)
    window = _window_sums(profile, spec)             # sum over [c-w, c+w]
    return _blank_score(window, total, ws, spec.n)


def contrast_scores(profile: jnp.ndarray, spec: SyncSpec) -> jnp.ndarray:
    """Polarity-symmetric blanking score: ``(mean inside − mean outside)^2``
    for every circular window.

    The reference's formula (``blank_scores``) grows with the window *sum*, so
    it only finds blanking that is brighter than content — true for its live
    captures (intermodulation makes blanking bright; the code comment at
    ``FrameSynchronisation.jl:51-53`` notes the polarity ambiguity but the
    shipped path hardcodes ``findmax``).  Scoring the squared difference of
    means instead locks onto the band most *different* from the rest, which
    works for dark or bright blanking without configuration.
    """
    total = jnp.sum(profile)
    wi = jnp.arange(spec.w_min, spec.w_max + 1)[:, None].astype(profile.dtype)
    window = _window_sums(profile, spec)
    return _contrast_score(window, total, wi, spec.n)


def find_blank(
    profile: jnp.ndarray, spec: SyncSpec, method: str = "contrast"
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best blanking centre for one smoothed profile: returns (centre, score).
    ``method="contrast"`` uses the symmetric score (default);
    ``method="reference"`` reproduces the reference's ``findmax`` over
    ``fill_β!`` scores (``FrameSynchronisation.jl:53,66``)."""
    scores = contrast_scores if method == "contrast" else blank_scores
    beta = scores(profile, spec)
    flat = jnp.argmax(beta)
    centre = flat % spec.n
    return centre, beta.reshape(-1)[flat]


def find_blank_subpixel(
    profile: jnp.ndarray, spec: SyncSpec, method: str = "contrast"
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Best blanking centre with *sub-pixel* refinement: parabolic
    interpolation of the score around the integer argmax along the centre
    axis (at the winning width).  Returns ``(centre_f32, score)``.

    The reference stops at the integer ``findmax``
    (``FrameSynchronisation.jl:66``); with a smoothed profile the contrast
    score is locally quadratic in the centre, so the 3-point parabola
    recovers the true blanking position to a fraction of a pixel — the
    registration accuracy that makes multi-frame sub-pixel accumulation
    (shift-and-add super-resolution over the EMA) possible."""
    scores = contrast_scores if method == "contrast" else blank_scores
    beta = scores(profile, spec)
    n = spec.n
    flat = jnp.argmax(beta)
    row, c = flat // n, flat % n
    # Re-evaluate the three scores around the argmax EXACTLY from an f32
    # prefix sum (six scalar reads): any reduced-precision pass in the score
    # matrix flattens the tiny curvature the parabola needs (a bf16 conv
    # once made every fraction exactly 0).
    w = (spec.w_min + row).astype(profile.dtype)
    w_max = spec.w_max
    prefix = _circular_prefix(profile, w_max)
    total = jnp.sum(profile)
    hi = row + spec.w_min + w_max + 1  # prefix index offsets for width w
    lo = w_max - spec.w_min - row

    score = _contrast_score if method == "contrast" else _blank_score

    def score_at(ci):
        ci = ci % n
        win = prefix[ci + hi] - prefix[ci + lo]
        return score(win, total, w, n)

    b0, b1, b2 = score_at(c - 1), score_at(c), score_at(c + 1)
    denom = b0 - 2.0 * b1 + b2
    frac = jnp.where(
        jnp.abs(denom) > 1e-12 * (jnp.abs(b1) + 1e-30),
        0.5 * (b0 - b2) / denom,
        0.0,
    )
    frac = jnp.clip(frac, -0.5, 0.5)
    return c.astype(jnp.float32) + frac, b1


@partial(jax.jit, static_argnames=("y_min_frac", "x_min_frac", "method"))
def frame_sync_subpixel(
    image: jnp.ndarray,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """:func:`frame_sync` with parabolic sub-pixel refinement on both axes:
    returns float32 ``(s_y, s_x, score)``."""
    y_t, x_t = image.shape
    row_profile = smooth_profile(jnp.sum(image, axis=1))
    col_profile = smooth_profile(jnp.sum(image, axis=0))
    s_y, score_y = find_blank_subpixel(
        row_profile, sync_spec_for_axis(y_t, y_min_frac), method)
    s_x, score_x = find_blank_subpixel(
        col_profile, sync_spec_for_axis(x_t, x_min_frac), method)
    return s_y, s_x, score_y + score_x


@partial(jax.jit, static_argnames=("y_min_frac", "x_min_frac", "method"))
def frame_sync(
    image: jnp.ndarray,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Find the (row, column) blanking position of ``image`` — the fixed
    ``vsync`` (``FrameSynchronisation.jl:56-79``).

    Returns ``(s_y, s_x, score)`` where score (sum of both axes' best
    contrasts) doubles as the sync-quality metric used by the sharded
    video-mode hypothesis search.
    """
    y_t, x_t = image.shape
    row_profile = smooth_profile(jnp.sum(image, axis=1))  # one value per line
    col_profile = smooth_profile(jnp.sum(image, axis=0))  # one value per column
    s_y, score_y = find_blank(row_profile, sync_spec_for_axis(y_t, y_min_frac), method)
    s_x, score_x = find_blank(col_profile, sync_spec_for_axis(x_t, x_min_frac), method)
    return s_y, s_x, score_y + score_x


def align_frame(image: jnp.ndarray, s_y: jnp.ndarray, s_x: jnp.ndarray) -> jnp.ndarray:
    """Roll the blanking position to the image border
    (reference ``GUI.jl:172``: ``circshift(image, (-s_y, -s_x))``)."""
    return jnp.roll(image, shift=(-s_y, -s_x), axis=(0, 1))


def _roll_frac(
    image: jnp.ndarray, s: jnp.ndarray, axis: int, interp: str = "linear"
) -> jnp.ndarray:
    """Circular shift by a *fractional* −s along ``axis``: integer roll by
    −floor(s) blended with neighbouring rolls (2-tap linear or 4-tap
    Catmull-Rom interpolation — cubic keeps more high-frequency content,
    which matters when many registered frames are averaged)."""
    k = jnp.floor(s).astype(jnp.int32)
    f = (s - k).astype(image.dtype)
    offs, ws = _interp_weights(f, interp)
    out = None
    for off, w in zip(offs, ws):
        term = w * jnp.roll(image, shift=-(k + off), axis=axis)
        out = term if out is None else out + term
    return out


def align_frame_subpixel(
    image: jnp.ndarray,
    s_y: jnp.ndarray,
    s_x: jnp.ndarray,
    interp: str = "linear",
) -> jnp.ndarray:
    """:func:`align_frame` for fractional offsets: separable circular shift
    with interpolation on each axis.  With sub-pixel sync estimates this
    registers every frame to the same grid phase before the EMA, so deep
    averaging accumulates detail instead of blurring across the residual
    ±0.5-pixel jitter integer rolls leave behind."""
    return _roll_frac(_roll_frac(image, s_y, 0, interp), s_x, 1, interp)


def _interp_weights(f: jnp.ndarray, interp: str):
    """(tap offsets, tap weights) of a fractional shift ``f`` ∈ [0, 1) —
    the shared kernel definition of :func:`_roll_frac` and
    :func:`shift_matrix` (2-tap linear / 4-tap Catmull-Rom)."""
    if interp == "linear":
        return (0, 1), (1.0 - f, f)
    f2, f3 = f * f, f * f * f
    w0 = 0.5 * (-f3 + 2.0 * f2 - f)
    w1 = 0.5 * (3.0 * f3 - 5.0 * f2 + 2.0)
    w2 = 0.5 * (-3.0 * f3 + 4.0 * f2 + f)
    w3 = 0.5 * (f3 - f2)
    return (-1, 0, 1, 2), (w0, w1, w2, w3)


def shift_matrix(n: int, s: jnp.ndarray, interp: str = "linear",
                 dtype=jnp.float32) -> jnp.ndarray:
    """(n, n) circulant fractional-shift operator built ON DEVICE from the
    traced shift ``s``: ``S @ v`` equals ``_roll_frac(v, s)`` along a
    length-``n`` axis.

    Built by broadcast compares against the integer tap positions (the
    framework's device-rebuilt-one-hot trick, cf. StreamingExactPlan) — no
    host round trip, no gathers.  The point: applying the shift as a
    MATMUL replaces 4-8 full-image dynamic rolls per frame.  At DEFAULT
    precision the GPU runs it in TF32 (10 mantissa bits per operand)."""
    k = jnp.floor(s).astype(jnp.int32)
    f = (s - k).astype(dtype)
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    cols = jnp.arange(n, dtype=jnp.int32)[None, :]
    offs, ws = _interp_weights(f, interp)
    S = jnp.zeros((n, n), dtype)
    for off, w in zip(offs, ws):
        S = S + w * (cols == (rows + k + off) % n).astype(dtype)
    return S


def align_frame_subpixel_matmul(
    image: jnp.ndarray,
    s_y: jnp.ndarray,
    s_x: jnp.ndarray,
    interp: str = "linear",
) -> jnp.ndarray:
    """:func:`align_frame_subpixel` as two shift-operator matmuls:
    ``S_y @ image @ S_x^T`` — same separable interpolation (equal up to f32
    reassociation), but the work is two matmuls instead of 4-8 dynamic
    full-image rolls.  The reference stops at integer
    ``circshift`` (``GUI.jl:172``)."""
    h, w = image.shape
    Sy = shift_matrix(h, s_y, interp, image.dtype)
    Sx = shift_matrix(w, s_x, interp, image.dtype)
    return Sy @ image @ Sx.T
