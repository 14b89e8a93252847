"""Step-by-step offline analysis of an IQ capture — the framework's analogue
of the reference's canonical walkthrough script
(``/root/reference/production/investigate_data.jl``), fully automated.

Usage:
    python examples/investigate_capture.py [capture.dat] [--fs 20e6]

Without a capture it synthesises one (the repo ships no recorded IQ).  Each
stage prints what the reference script inspects manually: spectrum summary,
autocorrelation peaks, refresh estimate, line-count estimate, chosen mode,
frame cut, sync offsets, and writes the reconstructed screen to PNG.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")  # run from the repo root

import jax
import jax.numpy as jnp

import tempest_tpu as tt
from tempest_tpu.ops.autocorr import autocorrelation, zoom_autocorr
from tempest_tpu.ops.spectrum import get_welch
from tempest_tpu.pipeline.offline import auto_reconstruct
from tempest_tpu.render.screen import write_png


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("--fs", type=float, default=16e6)
    ap.add_argument("--format", default="single")
    ap.add_argument("--out", default="investigate_out.png")
    args = ap.parse_args()

    if args.capture:
        iq = tt.read_complex_binary(args.capture, args.format)
        print(f"[1] loaded {len(iq)} samples from {args.capture}")
    else:
        mode = tt.ALL_VIDEO_MODES["1024x768 @ 60Hz"]
        cap = tt.generate_iq(mode, args.fs, int(args.fs * 0.5), snr_db=18.0)
        iq = cap.iq
        print(f"[1] synthesised {len(iq)} samples of {mode} @ {args.fs/1e6:.1f} MHz")

    # [2] envelope + spectrum (investigate_data.jl:37-46).  The capture goes
    # to the device as PLANAR (2, N) float32 (host de-interleave) and is
    # re-assembled to complex inside the jitted program — no complex dtype
    # crosses the host->device boundary and the device does no strided
    # de-interleave (see ops/demod.py).
    from tempest_tpu.ops.demod import to_planar_iq

    env = np.abs(iq).astype(np.float32)
    planar = to_planar_iq(np.ascontiguousarray(iq[: 1 << 18], np.complex64))

    @jax.jit
    def welch_planar(p):
        return get_welch(args.fs, p[0] + 1j * p[1])

    freq, psd = welch_planar(jnp.asarray(planar))
    peak_f = float(freq[int(np.argmax(np.asarray(psd)))])
    print(f"[2] AM envelope: mean {env.mean():.3f}; Welch PSD peak at "
          f"{peak_f/1e3:.1f} kHz offset")

    # [3] autocorrelation + refresh zoom (investigate_data.jl:52-63)
    gamma, lags = autocorrelation(jnp.asarray(env**2), args.fs, 0.0, 0.1)
    rates, gz = zoom_autocorr(gamma, args.fs, rate_min=50, rate_max=90)
    top = int(np.argmax(np.asarray(gz)))
    print(f"[3] autocorr over {len(np.asarray(gamma))} lags; refresh-band "
          f"argmax at {float(np.asarray(rates)[top]):.3f} Hz")

    # [4]-[7] the automated pipeline: timing -> mode -> frames -> sync -> EMA
    timing, recon = auto_reconstruct(iq, args.fs, alpha=0.5)
    print(f"[4] refresh estimate : {timing.refresh_hz:.4f} Hz")
    print(f"[5] line count est   : {timing.line_count:.1f} -> mode "
          f"{timing.mode_name} ({timing.mode.width}x{timing.mode.height})")
    print(f"[6] frames averaged  : {recon.frames.shape[0]}; sync offsets "
          f"first/last {recon.sync[0].tolist()}/{recon.sync[-1].tolist()}")
    write_png(recon.image, args.out)
    print(f"[7] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
