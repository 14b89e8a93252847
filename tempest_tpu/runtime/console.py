"""Live operator console: drive a running stream interactively.

The reference's defining workflow is an operator *watching* the live image
and correlation panels and intervening — clicking a correlation peak to fix
the line count (``/root/reference/src/GUI.jl:512-523``), nudging ±1 line
(``:529-543``), retyping fv/y_t (``:463-523``), moving gain/α sliders
(``:617-658``), toggling start/pause/correlate/record (``:394-459``).  This
module binds the runtime's scriptable override surface to a *running* stream
as a line-command loop — the same operations with no GUI toolkit: commands
arrive on stdin (or any iterable — scripted sessions and tests), dispatch
between blocks, and the view/HUD refresh as the stream runs.

Why a command loop and not a GUI port: the runtime is headless-first (accelerator
hosts), every control is equally scriptable and testable, and a remote
operator gets the full surface over ssh.
"""

from __future__ import annotations

import queue
import sys
import threading
from collections import deque

import numpy as np

from .stream import StreamingRuntime

__all__ = ["OperatorConsole", "HELP"]

HELP = """\
commands (reference GUI widget in parens):
  status            one-line mode/alpha/fidelity/throughput summary
  health            full health snapshot (ring, producer, rates)
  pause / start     stop/resume block processing (start-pause toggle)
  correlate [sec]   re-estimate timing from the live stream (task 1)
  peaks             ranked line-period peaks from the last correlate
  pick N            adopt ranked line peak N (click on the correlation plot)
  fv X              override refresh rate [Hz] (fv textbox)
  lines N           override total line count (y_t textbox)
  + [n] / - [n]     nudge line count (the +1/-1 buttons)
  snap              re-match (lines, fv) to the closest video mode
  alpha X           EMA averaging coefficient (the LPF slider)
  gain X            SDR RX gain (gain slider; hardware sources)
  carrier X         retune carrier frequency [Hz] (carrier textbox)
  rate X            change sample rate [Hz] (rate textbox)
  fidelity on|off   sub-sample-exact cuts <-> sync chain hot-swap
  drift             refine refresh from observed sync drift (closed loop)
  scan F1 F2 ...    retune across carriers [Hz], score screen-ness per dwell,
                    tune to the best (no reference equivalent: its operator
                    hunts the waterfall by eye)
  combine auto|off|am|fm|excise [dB|off]|F1 F2 ...
                    live multi-harmonic fusion: channelise every block at
                    these carrier offsets [Hz] and reconstruct the MRC-fused
                    envelope; `auto` scans the stream for the strongest
                    screen's harmonics (no reference equivalent)
  record [n]        dump n raw IQ blocks to auto-rotated dumpIQ_N.dat (task 3)
  crosshair on|off  sync crosshair overlay on the live view
  help              this text
  quit              stop the session
"""


class OperatorConsole:
    """Line-command loop around a :class:`StreamingRuntime`.

    ``commands``: None reads stdin on a daemon thread (interactive/ssh);
    any iterable is consumed one command per block cycle — deterministic
    scripted sessions (and the test harness).  ``sink`` receives the live
    frames exactly as in ``process_blocks``, with the sync crosshair
    overlaid when enabled (the reference's ``displayScreen_vsync!``,
    ``ScreenRenderer.jl:182-187``, on the *live* view)."""

    def __init__(
        self,
        runtime: StreamingRuntime,
        sink=None,
        commands=None,
        out=None,
        crosshair: bool = False,
    ) -> None:
        self.rt = runtime
        self.sink = sink
        self.out = out if out is not None else sys.stdout
        self.crosshair = crosshair
        self.running = True          # task 2 active (False = paused)
        self.alive = True            # quit flag
        self.blocks_done = 0
        self._sync_hist: deque[np.ndarray] = deque(maxlen=64)
        self._scripted = None
        self._q: queue.Queue[str] | None = None
        self._stdin_thread: threading.Thread | None = None
        if commands is None:
            # The stdin reader starts lazily in run(): a dispatch-only
            # console (tests, programmatic drivers) must not own stdin.
            self._q = queue.Queue()
        else:
            self._scripted = iter(commands)

    # ------------------------------------------------------------- plumbing
    def _stdin_reader(self) -> None:
        for line in sys.stdin:
            self._q.put(line)
        self._q.put("quit")  # EOF ends the session

    def _say(self, text: str) -> None:
        print(text, file=self.out, flush=True)

    def _next_commands(self) -> list[str]:
        """Commands to dispatch at this block boundary: everything queued
        (interactive) or exactly one (scripted — deterministic ordering)."""
        if self._scripted is not None:
            try:
                return [next(self._scripted)]
            except StopIteration:
                self.alive = False
                return []
        cmds = []
        try:
            while True:
                cmds.append(self._q.get_nowait())
        except queue.Empty:
            pass
        return cmds

    def _wrapped_sink(self, img: np.ndarray, info: dict) -> None:
        if self.rt.config.do_align:
            # Only real sync measurements feed the drift estimator — in
            # fidelity mode the stage is off and returns zeros, which would
            # silently bias `drift` toward a no-op.
            self._sync_hist.append(np.asarray(info.get("sync")))
        if self.sink is None:
            return
        if self.crosshair:
            from ..render.screen import _maybe_crosshair

            img = _maybe_crosshair(img, info, True)
        self.sink(img, info)

    # ------------------------------------------------------------- dispatch
    def dispatch(self, line: str) -> None:
        """Execute one command line; errors are reported, never fatal (an
        operator typo must not kill the stream)."""
        parts = line.strip().split()
        if not parts:
            return
        cmd, args = parts[0].lower(), parts[1:]
        rt = self.rt
        try:
            if cmd in ("quit", "q", "exit"):
                self.alive = False
            elif cmd in ("help", "h", "?"):
                self._say(HELP)
            elif cmd == "pause":
                self.running = False
                self._say("paused (stream keeps running; blocks drop)")
            elif cmd in ("start", "resume"):
                self.running = True
                self._say("resumed")
            elif cmd == "status":
                h = rt.health()
                m = rt.mode
                self._say(
                    f"mode {m.width}x{m.height} @ {m.refresh:.4f} Hz | "
                    f"alpha {rt.alpha} | fidelity {rt.fidelity} | "
                    f"{'running' if self.running else 'PAUSED'} | "
                    f"blocks {self.blocks_done} frames {rt.frames_out} | "
                    f"consumer {h['consumer_msps']} MS/s "
                    f"(x{h['realtime_factor']} RT) | "
                    f"ring {h['ring_available']}/{rt.ring.depth} "
                    f"overflows {h['ring_overflows']}"
                )
            elif cmd == "health":
                self._say(str(rt.health()))
            elif cmd == "correlate":
                secs = float(args[0]) if args else 0.1
                timing = rt.correlate(seconds=secs, keep_evidence=True)
                self._say(f"correlate: {timing.mode_name} "
                          f"fv={timing.refresh_hz:.4f} Hz "
                          f"y_t={timing.line_count:.1f}")
                if rt.corr_spark:
                    self._say(f"  {rt.corr_spark}")
            elif cmd == "peaks":
                ev = rt.last_evidence
                if ev is None or ev.line_peaks is None:
                    self._say("no evidence — run `correlate` first")
                else:
                    s0 = max(float(ev.line_peaks[0][2]), 1e-12)
                    for i, (lag, y, sc) in enumerate(ev.line_peaks):
                        self._say(f"  #{i}: lag {lag:9.2f} -> {y:7.1f} lines "
                                  f"(score {sc / s0:.2f})")
            elif cmd == "pick":
                name = rt.pick_line_peak(int(args[0]))
                self._say(f"picked peak {args[0]} -> {name} "
                          f"({rt.mode.width}x{rt.mode.height})")
            elif cmd == "fv":
                rt.set_refresh(float(args[0]))
                self._say(f"fv = {rt.mode.refresh:.4f} Hz")
            elif cmd == "lines":
                rt.set_line_count(int(args[0]))
                self._say(f"lines = {rt.mode.height}")
            elif cmd in ("+", "-"):
                n = int(args[0]) if args else 1
                rt.nudge_lines(n if cmd == "+" else -n)
                self._say(f"lines = {rt.mode.height}")
            elif cmd == "snap":
                name = rt.snap_to_mode()
                self._say(f"snapped to {name} "
                          f"({rt.mode.width}x{rt.mode.height})")
            elif cmd == "alpha":
                rt.alpha = float(args[0])
                self._say(f"alpha = {rt.alpha}")
            elif cmd == "gain":
                rt.set_gain(float(args[0]))
                self._say(f"gain = {args[0]}")
            elif cmd == "carrier":
                rt.set_carrier(float(args[0]))
                self._say(f"carrier = {args[0]} Hz")
                if getattr(rt, "_combine_centers", None):
                    # Combine offsets are relative to the capture center;
                    # the emissions did not move with the retune.
                    self._say("note: combine carriers are now relative to "
                              "the NEW center — rerun `combine auto` (or "
                              "`combine off`)")
            elif cmd == "rate":
                rt.set_sample_rate(float(args[0]))
                self._say(f"sample rate = {args[0]} Hz")
            elif cmd == "fidelity":
                on = args[0].lower() in ("on", "1", "true") if args else True
                rt.set_fidelity(on)
                self._say(f"fidelity = {on}")
            elif cmd == "drift":
                hist = [s for s in self._sync_hist if s is not None and s.size]
                if not self.rt.config.do_align and not hist:
                    self._say("fidelity mode skips the sync stage — "
                              "`fidelity off`, stream a few blocks, then "
                              "`drift`")
                elif not hist:
                    self._say("no sync history yet (need processed blocks "
                              "with the sync stage on)")
                else:
                    fv = rt.refine_refresh_from_drift(np.concatenate(hist))
                    self._say(f"drift lock: fv -> {fv:.5f} Hz")
            elif cmd == "scan":
                freqs = [float(a) for a in " ".join(args).replace(",", " ").split()]
                if not freqs:
                    self._say("usage: scan F1 F2 ... [Hz] — retune-and-score "
                              "each carrier, leave the best tuned")
                else:
                    for f, score, floor, fv in rt.scan(freqs):
                        margin = score - floor
                        verdict = ("EMISSION" if margin >= 5.0
                                   else "noise-level")
                        self._say(f"  {f/1e6:10.3f} MHz: screen-ness "
                                  f"{score:5.1f} dB = floor {floor:4.1f} "
                                  f"{margin:+5.1f} ({verdict}), "
                                  f"refresh {fv:7.3f} Hz")
                    self._say("tuned to best candidate")
            elif cmd == "combine":
                if not args or args[0].lower() == "status":
                    info = rt.health().get("combine")
                    self._say(f"combine: {info}" if info else "combine: off")
                elif args[0].lower() == "off":
                    rt.set_combine(None)
                    self._say("combine off — chain back at the source rate")
                elif args[0].lower() == "auto":
                    secs = float(args[1]) if len(args) > 1 else 0.4
                    centers = rt.combine_auto(seconds=secs)
                    if centers:
                        self._say("combining "
                                  + ", ".join(f"{c/1e6:+.2f} MHz"
                                              for c in centers))
                    else:
                        self._say("no emissions detected — combine off")
                elif args[0].lower() in ("am", "fm"):
                    # Switch the front's per-channel demodulator in place
                    # (rebuilds only if combining is active).
                    rt.set_combine(rt._combine_centers, demod=args[0].lower())
                    self._say(f"combine demod = {args[0].lower()}")
                elif args[0].lower() == "excise":
                    val = (None if len(args) < 2 or args[1].lower() == "off"
                           else float(args[1]))
                    rt.set_combine(rt._combine_centers, excise_db=val)
                    self._say(f"combine excise = "
                              f"{'off' if val is None else f'{val:g} dB'}")
                else:
                    centers = [float(a) for a in
                               " ".join(args).replace(",", " ").split()]
                    rt.set_combine(centers)
                    self._say("combining "
                              + ", ".join(f"{c/1e6:+.2f} MHz"
                                          for c in centers))
            elif cmd == "record":
                n = int(args[0]) if args else 10
                wrote = rt.record(None, n_blocks=n)
                self._say(f"recorded {wrote} samples to {rt.last_record_path}")
            elif cmd == "crosshair":
                self.crosshair = (args[0].lower() in ("on", "1", "true")
                                  if args else not self.crosshair)
                self._say(f"crosshair = {self.crosshair}")
            else:
                self._say(f"unknown command: {cmd} (try `help`)")
        except Exception as exc:  # operator errors must not kill the stream
            self._say(f"error: {exc!r}")

    # ------------------------------------------------------------ main loop
    def run(self, max_blocks: int | None = None):
        """Drive the session: dispatch pending commands, process one block,
        repeat — until `quit`, EOF, a scripted command stream runs out, the
        source closes, or ``max_blocks``.  Returns the final EMA image."""
        if self._q is not None and self._stdin_thread is None:
            self._stdin_thread = threading.Thread(
                target=self._stdin_reader, daemon=True, name="console-stdin")
            self._stdin_thread.start()
        img = None
        while self.alive:
            for line in self._next_commands():
                self.dispatch(line)
            if not self.alive:
                break
            if not self.running:
                if self._scripted is None:
                    # Interactive pause: wait for the next command.
                    try:
                        self.dispatch(self._q.get(timeout=0.25))
                    except queue.Empty:
                        pass
                continue
            if self._scripted is None and self.rt.ring.available == 0:
                # Source quiet (stalled hardware, slow replay): keep the
                # command loop responsive instead of blocking inside
                # ring.take — `quit`/`status`/`health` must keep working,
                # they are the failure-diagnosis surface.
                try:
                    self.dispatch(self._q.get(timeout=0.25))
                except queue.Empty:
                    pass
                continue
            before = self.rt.frames_out
            out = self.rt.process_blocks(1, sink=self._wrapped_sink)
            if self.rt.frames_out == before:
                break  # ring closed / source ended — nothing was delivered
            img = out
            self.blocks_done += 1
            if max_blocks is not None and self.blocks_done >= max_blocks:
                break
        return img
