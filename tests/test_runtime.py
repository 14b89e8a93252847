"""Tests for the host runtime (ring buffer, sources, streaming executor),
renderers, and the CLI."""

import threading
import time

import numpy as np
import pytest

import tempest_tpu as tt
from tempest_tpu.app.cli import main as cli_main
from tempest_tpu.render.screen import (
    TerminalRenderer,
    full_scale,
    overlay_sync,
    write_pgm,
    write_png,
)
from tempest_tpu.runtime.ring import RingBuffer
from tempest_tpu.runtime.sources import (
    HardwareSource,
    ReplaySource,
    SyntheticSource,
    open_source,
)
from tempest_tpu.runtime.stream import StreamingRuntime

MODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6


# ------------------------------------------------------------------- ring
def test_ring_put_take_order():
    ring = RingBuffer(4, depth=3)
    for i in range(3):
        ring.put(np.full(4, i, np.complex64))
    for i in range(3):
        out = ring.take()
        assert out[0] == i
    assert ring.overflows == 0


def test_ring_overwrites_oldest():
    ring = RingBuffer(2, depth=2)
    for i in range(5):
        ring.put(np.full(2, i, np.complex64))
    assert ring.overflows == 3
    # The two newest blocks survive.
    assert ring.take()[0] == 3
    assert ring.take()[0] == 4


def test_ring_sequence_tracks_drops():
    """Every taken block carries its production sequence so consumers can
    keep absolute stream position across overflow drops (carry-phase
    correctness — blind `pos += block_size` shears the frame grid)."""
    ring = RingBuffer(2, depth=2)
    assert ring.last_seq == -1
    assert ring.produced == 0
    for i in range(5):
        ring.put(np.full(2, i, np.complex64))
    assert ring.produced == 5
    assert ring.take()[0] == 3 and ring.last_seq == 3
    assert ring.take()[0] == 4 and ring.last_seq == 4
    ring.put(np.full(2, 5, np.complex64))
    assert ring.produced == 6
    assert ring.take()[0] == 5 and ring.last_seq == 5
    # The retune-fence contract (StreamingRuntime.scan): every block taken
    # after `produced` was observed with seq >= that observation is
    # guaranteed to have been put afterwards.
    barrier = ring.produced
    ring.put(np.full(2, 7, np.complex64))
    ring.take()
    assert ring.last_seq >= barrier


def test_native_ring_sequence_tracks_drops():
    from tempest_tpu.native import NativeRing, native_available

    if not native_available():
        pytest.skip("no C++ toolchain")
    ring = NativeRing(2, depth=2)
    assert ring.last_seq == -1
    assert ring.produced == 0
    for i in range(5):
        ring.put(np.full(2, i, np.complex64))
    assert ring.produced == 5
    assert ring.take()[0] == 3 and ring.last_seq == 3
    assert ring.take()[0] == 4 and ring.last_seq == 4


def test_streaming_phase_survives_ring_drops():
    """If the ring drops blocks while the consumer is busy, the runtime must
    re-anchor its absolute position to the delivered block's sequence —
    the reconstructed geometry must match an uninterrupted stream's."""
    block = int(FS * 0.12)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=22)
    blocks = []
    buf = np.empty(block, np.complex64)
    for _ in range(5):
        src.read(buf)
        blocks.append(buf.copy())

    def run(ring_depth, n_consume):
        s2 = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=22)
        # alpha=0.5 over 6-frame blocks: by the end, blocks 0-1's EMA weight
        # is 0.5^18 ≈ 4e-6 — the clean (all 5 blocks) and dropped (blocks
        # 2-4 only) runs end with the same effective average IF the dropped
        # run anchors those blocks at their true positions.
        rt = StreamingRuntime(s2, MODE, alpha=0.5, fidelity=True)
        rt.ring = type(rt.ring)(block, ring_depth)
        for b in blocks:
            rt.ring.put(b)
        img = rt.process_blocks(n_consume)
        rt.stop()
        return rt, img

    rt_c, clean = run(8, 5)
    assert rt_c.ring.overflows == 0
    rt_d, dropped = run(3, 3)  # blocks 0 and 1 overwritten before consuming
    assert rt_d.ring.overflows == 2
    d = np.abs(clean - dropped) / (clean.max() - clean.min() + 1e-9)
    assert d.mean() < 0.02, d.mean()


def test_ring_blocking_take_and_close():
    ring = RingBuffer(2, depth=2)
    results = []

    def consumer():
        results.append(ring.take(timeout=5.0))

    th = threading.Thread(target=consumer)
    th.start()
    time.sleep(0.05)
    ring.put(np.ones(2, np.complex64))
    th.join(timeout=2.0)
    assert results and results[0][0] == 1.0
    ring.close()
    assert ring.take(timeout=0.1) is None


def test_ring_threaded_throughput_counts():
    ring = RingBuffer(64, depth=8)
    n_blocks = 200

    def producer():
        b = np.zeros(64, np.complex64)
        for i in range(n_blocks):
            b[:] = i
            ring.put(b)
        ring.close()

    got = 0
    th = threading.Thread(target=producer)
    th.start()
    while ring.take(timeout=1.0) is not None:
        got += 1
    th.join()
    assert got + ring.overflows == n_blocks
    assert ring.producer.blocks == n_blocks


# ---------------------------------------------------------------- sources
def test_replay_source_loops(tmp_path):
    path = tmp_path / "cap.dat"
    tt.write_complex_binary(np.arange(32, dtype=np.complex64), path)
    src = ReplaySource(path, FS, 16)
    out = np.empty(16, np.complex64)
    src.read(out)
    assert out[0] == 0
    src.read(out)
    assert out[0] == 16
    src.read(out)  # wraps
    assert out[0] == 0


def test_synthetic_source_phase_continuous():
    """Two consecutive blocks must splice into the same signal as one big
    block (phase carried across reads), up to per-block noise."""
    src = SyntheticSource(MODE, FS, 5000, snr_db=300.0, seed=1)
    a = np.empty(5000, np.complex64)
    b = np.empty(5000, np.complex64)
    src.read(a)
    src.read(b)
    cap = tt.generate_iq(MODE, FS, 10000, snr_db=300.0, seed=1)
    np.testing.assert_allclose(np.abs(a), np.abs(cap.iq[:5000]), rtol=1e-4)
    np.testing.assert_allclose(np.abs(b), np.abs(cap.iq[5000:]), rtol=1e-4)


def test_hardware_source_raises_helpfully():
    with pytest.raises(RuntimeError, match="No SDR driver"):
        HardwareSource("uhd", 764e6, 20e6, 50, 1024)
    with pytest.raises(RuntimeError, match="rtlsdr"):
        open_source("rtlsdr", sample_rate=2e6, block_size=1024)


# ---------------------------------------------------------------- runtime
def test_streaming_runtime_end_to_end():
    block = int(FS * 0.1)  # ~5 frames per block after phase headroom
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=2)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    images, syncs = [], []
    try:
        def sink(img, info):
            images.append(img.copy())
            syncs.append(info["sync"])
        rt.process_blocks(3, sink=sink)
    finally:
        rt.stop()
    assert len(images) == 3
    assert images[-1].shape == (600, 800)
    assert rt.frames_out == 3 * rt.config.n_frames
    # Phase carry: frame cuts are continuous across block boundaries, so the
    # detected blanking position must NOT jump between blocks (it did before
    # phase carry — each block restarted the frame grid).
    all_sync = np.concatenate(syncs)       # (n_blocks*n_frames, 2)
    for axis, n in ((0, 600), (1, 800)):
        s = all_sync[:, axis].astype(int)
        d = np.abs(np.diff(s))
        d = np.minimum(d, n - d)           # circular distance
        assert d.max() <= 8, f"sync jump across blocks on axis {axis}: {s}"
    # The reconstruction must carry real structure, not noise.
    assert images[-1].std() > 0.01


def test_streaming_runtime_correlate_hotswap():
    block = int(FS * 0.15)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=4)
    wrong = tt.ALL_VIDEO_MODES["800x600 @ 60Hz"]
    rt = StreamingRuntime(src, wrong, alpha=0.5)
    rt.start()
    try:
        timing = rt.correlate(seconds=0.1)
        assert timing.mode_name == "640x480 @ 60Hz"
        assert rt.mode.height == MODE.height  # hot-swapped
        rt.process_blocks(1)
    finally:
        rt.stop()


def test_streaming_correlate_gap_proofing():
    """correlate() must not concatenate across ring-overflow gaps: a torn
    window carries a frame-phase discontinuity that dilutes the refresh comb
    (the scan() dwell bug class, measured ~10 dB).  Force an overflow gap
    mid-correlate with a scripted just-in-time feeder on a REAL ring and
    assert the estimate still locks, from a contiguous run only."""
    block = int(FS * 0.05)
    cap = tt.generate_iq(MODE, FS, 10 * block, snr_db=25.0, seed=7)
    blocks = np.asarray(cap.iq, np.complex64).reshape(10, block)
    wrong = tt.ALL_VIDEO_MODES["800x600 @ 60Hz"]
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    rt = StreamingRuntime(src, wrong, alpha=0.5, ring_depth=4)
    ring = rt.ring
    # Scripted production, fed just-in-time before each take: the consumer
    # sees seqs 0, 1, then blocks 2..9 land on a depth-4 ring (2-5 dropped),
    # so the next take jumps to seq 6 — an overflow gap mid-window.
    schedule = [list(blocks[0:2]), [], list(blocks[2:10]), [], []]
    orig_take = ring.take

    def take_hook(out=None, timeout=None):
        if schedule:
            for b in schedule.pop(0):
                ring.put(b)
        return orig_take(out, timeout)

    ring.take = take_hook
    timing = rt.correlate(seconds=0.1)
    assert ring.overflows == 4          # the gap really happened
    assert rt.last_correlate_gaps == 1  # ... and was detected
    # The estimate locks despite the torn takes (the pre-fix code would
    # correlate across the discontinuity and silently degrade).
    assert timing.mode_name == "640x480 @ 60Hz"
    assert abs(timing.refresh_hz - 60.0) < 0.2


def test_streaming_operator_overrides():
    """The reference GUI's manual overrides (fv/y_t textboxes, ±1-line
    buttons, auto mode re-match — GUI.jl:463-580) as runtime methods."""
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=4)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.set_refresh(59.94)
    assert abs(rt.mode.refresh - 59.94) < 1e-9
    assert rt.mode.height == MODE.height
    assert rt.nudge_lines(+1) == MODE.height + 1
    rt.nudge_lines(-1)
    assert rt.mode.height == MODE.height
    rt.set_line_count(MODE.height + 2)  # slightly off -> snaps back
    name = rt.snap_to_mode()
    assert name == "640x480 @ 60Hz"
    assert rt.mode.height == MODE.height
    assert abs(rt.mode.refresh - 59.94) < 1e-9  # measured refresh kept
    # The swapped program still runs.
    rt.start()
    try:
        rt.process_blocks(1)
    finally:
        rt.stop()


def test_streaming_runtime_record(tmp_path):
    block = 4096
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=5)
    rt = StreamingRuntime(src, MODE, n_frames_per_block=None, alpha=0.5) \
        if block > int(FS / MODE.refresh) else None
    # block < one frame: build runtime with explicit small frame count not
    # possible — record directly through ring instead.
    ring_src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=5)
    from tempest_tpu.runtime.ring import RingBuffer

    ring = RingBuffer(block, 8)
    for _ in range(4):
        buf = np.empty(block, np.complex64)
        ring_src.read(buf)
        ring.put(buf)
    # emulate the record task
    out = tmp_path / "rec.dat"
    chunks = [ring.take() for _ in range(4)]
    tt.write_complex_binary(np.concatenate(chunks), out)
    back = tt.read_complex_binary(out)
    assert len(back) == 4 * block


# ----------------------------------------------------------------- render
def test_full_scale_and_overlay():
    img = np.random.default_rng(0).random((60, 80)).astype(np.float32)
    fs = full_scale(img)
    assert fs.min() == 0.0 and fs.max() == 1.0
    ov = overlay_sync(img, 10, 20, half=2)
    assert np.all(ov[10, :] == 1.0)
    assert np.all(ov[:, 20] == 1.0)


def test_png_pgm_writers(tmp_path):
    img = np.linspace(0, 1, 60 * 80, dtype=np.float32).reshape(60, 80)
    png = tmp_path / "x.png"
    pgm = tmp_path / "x.pgm"
    write_png(img, str(png))
    write_pgm(img, str(pgm))
    data = png.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IEND" in data
    head = pgm.read_bytes()
    assert head.startswith(b"P5\n80 60\n255\n")


def test_terminal_renderer_ansi():
    img = np.random.default_rng(1).random((30, 40)).astype(np.float32)
    out = TerminalRenderer(rows=10, cols=20).render(img, {"mode": "m", "frames_out": 1})
    assert out.startswith("\x1b[H")
    assert "\x1b[48;5;" in out
    assert out.count("\n") >= 10


# -------------------------------------------------------------------- CLI
def test_cli_synth_analyze_reconstruct(tmp_path, capsys):
    cap = tmp_path / "c.dat"
    out = tmp_path / "r.png"
    assert cli_main([
        "synth", "--mode", "640x480 @ 60Hz", "--fs", str(FS),
        "--seconds", "0.4", "--snr", "20", "--out", str(cap),
    ]) == 0
    assert cli_main(["analyze", str(cap), "--fs", str(FS)]) == 0
    text = capsys.readouterr().out
    assert "640x480 @ 60Hz" in text
    assert cli_main([
        "reconstruct", str(cap), "--fs", str(FS), "--alpha", "0.5",
        "--out", str(out),
    ]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # Fidelity flags: sub-pixel registration on the auto path, exact cuts
    # (mxu3 tables) + subpixel on the explicit-mode path.
    out2 = tmp_path / "r2.png"
    assert cli_main([
        "reconstruct", str(cap), "--fs", str(FS), "--alpha", "0.5",
        "--subpixel", "--out", str(out2),
    ]) == 0
    out3 = tmp_path / "r3.png"
    assert cli_main([
        "reconstruct", str(cap), "--fs", str(FS), "--alpha", "0.5",
        "--mode", "640x480 @ 60Hz", "--subsample-align", "--subpixel",
        "--out", str(out3),
    ]) == 0
    assert out3.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # Ranked peak list + explicit pick (the reference's interactive
    # click-the-other-peak, GUI.jl:512-523, as CLI surface).
    assert cli_main([
        "analyze", str(cap), "--fs", str(FS), "--peaks", "3",
        "--pick-line-peak", "0",
    ]) == 0
    text = capsys.readouterr().out
    assert "ranked line peaks" in text and "#0" in text and "*picked" in text


def test_runtime_pick_line_peak():
    """The runtime override: correlate with evidence, then adopt a ranked
    peak — must hot-swap the mode like the reference's click."""
    block = int(FS * 0.15)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=17)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    try:
        rt.correlate(seconds=0.1, keep_evidence=True)
        assert rt.last_evidence is not None
        assert rt.last_evidence.line_peaks is not None
        name = rt.pick_line_peak(0)   # peak 0 = the automatic choice
        assert name == "640x480 @ 60Hz"
        assert rt.mode.height == MODE.height
    finally:
        rt.stop()


def test_operator_console_scripted_session(tmp_path, monkeypatch):
    """A scripted command stream drives a LIVE session end-to-end: overrides,
    correlate, peak pick, fidelity hot-swap, record, pause/resume — the
    reference's interactive layer (GUI.jl:394-658) bound to a running
    stream, with every effect asserted."""
    import io

    from tempest_tpu.runtime.console import OperatorConsole

    monkeypatch.chdir(tmp_path)
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=33)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    out = io.StringIO()
    sunk = []
    cmds = [
        "status",
        "+ 2",          # nudge: 525 -> 527
        "lines 500",    # textbox override
        "snap",         # re-match -> back to 525
        "alpha 0.7",
        "correlate",    # task 1: live re-estimate (keeps evidence)
        "peaks",
        "pick 0",
        "fidelity on",  # hot-swap to the quantised exact-cut chain
        "crosshair on",
        "record 1",     # task 3: one raw block to auto-rotated dumpIQ_N.dat
        "pause",
        "start",
        "bogus 123",    # operator typo must not kill the session
        "quit",
    ]
    console = OperatorConsole(
        rt, sink=lambda img, info: sunk.append(img.shape),
        commands=cmds, out=out,
    )
    img = console.run()
    rt.stop()
    text = out.getvalue()
    assert rt.mode.height == 525 and rt.mode.width == 800  # snap restored
    assert rt.alpha == 0.7
    assert rt.fidelity and rt.config.phase_bins == 64
    assert console.crosshair
    assert rt.last_record_path and (tmp_path / rt.last_record_path).exists()
    assert "lines = 527" in text and "lines = 500" in text
    assert "snapped to 640x480 @ 60Hz" in text
    assert "correlate: 640x480 @ 60Hz" in text
    assert "#0:" in text                      # ranked peaks listed
    assert "picked peak 0 -> 640x480 @ 60Hz" in text
    assert "paused" in text and "resumed" in text
    assert "unknown command: bogus" in text
    assert img is not None and img.shape == (600, 800)
    assert sunk and console.blocks_done >= 5


def test_cli_stream_console(tmp_path, monkeypatch, capsys):
    """`stream --console` binds stdin to the live session."""
    import io

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO("status\n+ 1\nquit\n"))
    assert cli_main([
        "stream", "--source", "synthetic", "--mode", "640x480 @ 60Hz",
        "--fs", str(FS), "--block-seconds", "0.1", "--snr", "25",
        "--console", "--render", "none",
    ]) == 0
    text = capsys.readouterr().out
    assert "commands (reference GUI widget in parens)" in text
    assert "lines = 526" in text


def test_terminal_renderer_crosshair():
    from tempest_tpu.render.screen import TerminalRenderer

    img = np.zeros((60, 80), np.float32)
    img[10:50, 10:70] = np.linspace(0, 1, 60)[None, :]
    info = {"sync": np.array([[5, 7]]), "mode": MODE, "frames_out": 1}
    r_on = TerminalRenderer(rows=12, cols=24, crosshair=True).render(img, info)
    r_off = TerminalRenderer(rows=12, cols=24).render(img, info)
    assert r_on != r_off  # the crosshair rows/cols change the cells


def test_cli_modes(capsys):
    assert cli_main(["modes"]) == 0
    text = capsys.readouterr().out
    assert "1920x1080 @ 60Hz" in text
    assert text.count("\n") >= 80


def test_runtime_health_snapshot():
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=8)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    try:
        rt.process_blocks(2)
        h = rt.health()
    finally:
        rt.stop()
    assert h["producer_alive"] is True
    assert h["producer_error"] is None
    assert h["frames_out"] == rt.frames_out > 0
    assert h["consumer_msps"] > 0


def test_refresh_drift_feedback_locks():
    """Start with a deliberately wrong refresh; the sync-drift feedback must
    recover the true rate."""
    from tempest_tpu.video.modes import VideoMode

    block = int(FS * 0.2)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=12)  # true 60 Hz
    wrong = VideoMode(MODE.width, MODE.height, 60.02)  # 20 mHz off
    rt = StreamingRuntime(src, wrong, alpha=0.5)
    rt.start()
    syncs = []
    try:
        rt.process_blocks(3, sink=lambda img, info: syncs.append(info["sync"]))
        fv = rt.refine_refresh_from_drift(np.concatenate(syncs))
    finally:
        rt.stop()
    assert abs(fv - 60.0) < abs(60.02 - 60.0) / 4, f"refined fv {fv}"


def test_fidelity_mode_streams_and_hot_swaps():
    """fidelity=True streams with sub-sample-exact cuts (sync skipped), and
    set_fidelity hot-swaps the compiled chain mid-session."""
    block = int(FS * 0.15)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=14)
    rt = StreamingRuntime(src, MODE, alpha=0.5, fidelity=True)
    assert rt.config.subsample_align and not rt.config.do_align
    rt.start()
    try:
        img = rt.process_blocks(2)
        assert img.std() > 0
        syncs = []
        rt.process_blocks(1, sink=lambda i, info: syncs.append(info["sync"]))
        assert np.all(syncs[0] == 0)  # sync stage skipped
        rt.set_fidelity(False)
        assert rt.config.do_align and not rt.config.subsample_align
        rt.process_blocks(1, sink=lambda i, info: syncs.append(info["sync"]))
        assert np.any(syncs[1] != 0)  # sync measurements back
    finally:
        rt.stop()


def test_streaming_fidelity_quantised_matches_gather():
    """fidelity=True now defaults to the phase-quantised mxu3 exact-cut
    tables (one compiled program, matmul speed); over a multi-block stream
    its EMA must match the traced-offset gather fidelity chain (the carry
    phase is quantised to 1/64 sample — far below the envelope's detail
    scale)."""
    block = int(FS * 0.12)

    def run(bins):
        src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=21)
        rt = StreamingRuntime(src, MODE, alpha=0.6, fidelity=True,
                              fidelity_bins=bins)
        # Feed the ring deterministically (no producer thread): both runs
        # must consume the *same* blocks — a free-running producer overflows
        # the ring while the consumer compiles, dropping a run-dependent
        # subset.
        buf = np.empty(block, np.complex64)
        for _ in range(4):
            src.read(buf)
            rt.ring.put(buf)
        try:
            img = rt.process_blocks(4)
        finally:
            rt.stop()
        return rt, img

    rt_q, img_q = run(64)
    assert rt_q.config.phase_bins == 64
    assert rt_q.config.resampler == "mxu3" and rt_q.config.subsample_align
    rt_g, img_g = run(0)
    assert rt_g.config.resampler == "gather" and rt_g.config.phase_bins == 0
    scale = img_g.max() - img_g.min() + 1e-9
    d = np.abs(img_q - img_g) / scale
    # Pointwise agreement: the quantisation error (<=1/128 sample) plus the
    # gather path's 3-tap vs the tables' 2-tap interpolation difference.
    assert d[:-2].mean() < 0.01 and d[:-2].max() < 0.08, (d.mean(), d.max())


def test_blanking_polarity_detection():
    from tempest_tpu.pipeline.offline import auto_reconstruct

    cap = tt.generate_iq(MODE, FS, int(FS * 0.3), snr_db=20.0, seed=13)
    _, recon = auto_reconstruct(cap.iq, FS, alpha=0.5)
    # Generator blanking level is 0 (dark), content bright.
    assert recon.blanking_is_dark is True


def test_streaming_with_native_ring():
    from tempest_tpu.native import native_available

    if not native_available():
        pytest.skip("no C++ toolchain")
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=31)
    rt = StreamingRuntime(src, MODE, alpha=0.5, ring_impl="native")
    rt.start()
    try:
        out = rt.process_blocks(2)
    finally:
        rt.stop()
    assert out.shape == (600, 800)
    assert rt.frames_out > 0
    assert "NativeRing" in rt.summary()


def test_streaming_emit_every_frame():
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=32)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    frames = []
    try:
        rt.process_blocks(2, sink=lambda img, info: frames.append(img.shape),
                          emit_every_frame=True)
    finally:
        rt.stop()
    # Per-frame emission: one sink call per reconstructed frame.
    assert len(frames) == rt.frames_out
    assert all(s == (600, 800) for s in frames)


def test_cli_warmup(capsys):
    assert cli_main([
        "warmup", "--fs", str(FS), "--frames", "1",
        "--modes", "640x480 @ 60Hz",
    ]) == 0
    text = capsys.readouterr().out
    assert "compiled 640x480 @ 60Hz (stream/f32)" in text
    assert "compiled 640x480 @ 60Hz (stream fidelity/tables)" in text
    assert "compiled timing estimator" in text


def test_cli_convert(tmp_path, capsys):
    src = tmp_path / "a.dat"
    dst = tmp_path / "b.dat"
    x = (np.arange(64) + 1j * np.arange(64)).astype(np.complex64)
    tt.write_complex_binary(x, src, "single")
    assert cli_main([
        "convert", str(src), str(dst),
        "--from-format", "single", "--to-format", "double",
    ]) == 0
    assert "converted 64 samples" in capsys.readouterr().out
    np.testing.assert_allclose(tt.read_complex_binary(dst, "double"), x)


def test_cli_search(tmp_path, capsys):
    cap = tmp_path / "c.dat"
    assert cli_main([
        "synth", "--mode", "640x480 @ 60Hz", "--fs", str(FS),
        "--seconds", "0.2", "--snr", "20", "--out", str(cap),
    ]) == 0
    # Default is the static-table path (same winners as the dynamic one).
    assert cli_main(["search", str(cap), "--fs", str(FS), "--tol", "0.5"]) == 0
    text = capsys.readouterr().out
    assert "static-table" in text
    assert "640x480 @ 60Hz" in text and "best" in text
    # The sharded dynamic-geometry variant stays available behind --dynamic.
    assert cli_main(["search", str(cap), "--fs", str(FS), "--tol", "0.5",
                     "--dynamic", "--devices", "2"]) == 0
    text = capsys.readouterr().out
    assert "static-table" not in text
    assert "640x480 @ 60Hz" in text and "best" in text


def test_record_rotation(tmp_path, monkeypatch):
    """record() with no path auto-rotates dumpIQ_N.dat like the reference's
    task 3 (GUI.jl:182-190)."""
    monkeypatch.chdir(tmp_path)
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=17)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    try:
        n0 = rt.record(n_blocks=1)
        assert rt.last_record_path == "dumpIQ_0.dat"
        n1 = rt.record(n_blocks=1)
        assert rt.last_record_path == "dumpIQ_1.dat"
    finally:
        rt.stop()
    assert n0 == n1 == block
    assert len(tt.read_complex_binary("dumpIQ_0.dat")) == block
    assert len(tt.read_complex_binary("dumpIQ_1.dat")) == block


def test_streaming_correlate_band_100hz():
    """Live mode detection outside the default 50-90 Hz band, via the
    rate_min/rate_max plumbing on correlate() (VERDICT r1 #6)."""
    mode100 = tt.ALL_VIDEO_MODES["640x480 @ 100Hz"]
    fs = 8e6
    block = int(fs * 0.12)
    src = SyntheticSource(mode100, fs, block, snr_db=20.0, seed=71)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    try:
        timing = rt.correlate(seconds=0.1, rate_min=95.0, rate_max=110.0)
        assert timing.mode_name == "640x480 @ 100Hz"
        assert abs(rt.mode.refresh - 100.0) < 0.05
        rt.process_blocks(1)
    finally:
        rt.stop()


def test_mesh_streaming_matches_single_chip():
    """The multi-chip STREAMING runtime (r4 verdict #2): T consecutive ring
    blocks through MeshStreamingRuntime (each block laid out as 8 time
    spans across the virtual mesh, halos over ppermute, last-shard halo
    from the one-block lookahead) must produce the same EMA as the
    single-chip carry-phase runtime fed the same stream in span-sized
    blocks — same frame grid, same cut windows, same fold."""
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime
    from tempest_tpu.runtime.sources import SyntheticSource

    n_sh, T = 8, 2
    S = int(FS * 0.05)                       # one shard span (≥ 2 frames)
    cap = tt.generate_iq(MODE, FS, (T + 1) * n_sh * S, snr_db=20.0, seed=12)
    sig = np.asarray(cap.iq, np.complex64)

    def _feed(rt, block, count):
        for t in range(count):
            rt.ring.put(np.ascontiguousarray(sig[t * block:(t + 1) * block]))

    # Mesh runtime: T dispatches need T+1 blocks (one-block lookahead).
    msrc = SyntheticSource(MODE, FS, n_sh * S, snr_db=25.0, seed=0)
    mrt = MeshStreamingRuntime(msrc, MODE, make_mesh(n_sh), alpha=0.5)
    _feed(mrt, n_sh * S, T + 1)
    img_m = mrt.process_blocks(T)

    # Single-chip runtime on span-sized blocks over the same signal.
    ssrc = SyntheticSource(MODE, FS, S, snr_db=25.0, seed=0)
    srt = StreamingRuntime(ssrc, MODE, alpha=0.5)
    assert srt._n_frames == mrt._n_frames    # same per-span frame count
    _feed(srt, S, T * n_sh)
    img_s = srt.process_blocks(T * n_sh)

    assert mrt.frames_out == srt.frames_out == T * n_sh * mrt._n_frames
    np.testing.assert_allclose(img_m, img_s, atol=2e-3)
    h = mrt.health()["mesh"]
    assert h["n_shards"] == n_sh and h["pending_block"] is True


def test_mesh_streaming_fidelity_matches_single_chip():
    """The quantised-table FIDELITY chain on the mesh (round 5): per-shard
    carry phases quantise to per-shard bins host-side, the (K, F, …) table
    stacks live device-resident and each shard gathers its slab by traced
    bin index.  Must reproduce the single-chip fidelity runtime fed the
    same stream in span-sized blocks — same bins, same exact cuts, same
    EMA."""
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime
    from tempest_tpu.runtime.sources import SyntheticSource

    n_sh, T = 8, 2
    S = int(FS * 0.05)
    cap = tt.generate_iq(MODE, FS, (T + 1) * n_sh * S, snr_db=20.0, seed=12)
    sig = np.asarray(cap.iq, np.complex64)

    def _feed(rt, block, count):
        for t in range(count):
            rt.ring.put(np.ascontiguousarray(sig[t * block:(t + 1) * block]))

    msrc = SyntheticSource(MODE, FS, n_sh * S, snr_db=25.0, seed=0)
    mrt = MeshStreamingRuntime(msrc, MODE, make_mesh(n_sh), alpha=0.5,
                               fidelity=True, fidelity_bins=16)
    assert mrt.config.phase_bins == 16 and mrt.config.subsample_align
    _feed(mrt, n_sh * S, T + 1)
    img_m = mrt.process_blocks(T)

    ssrc = SyntheticSource(MODE, FS, S, snr_db=25.0, seed=0)
    srt = StreamingRuntime(ssrc, MODE, alpha=0.5, fidelity=True,
                           fidelity_bins=16)
    assert srt._n_frames == mrt._n_frames
    _feed(srt, S, T * n_sh)
    img_s = srt.process_blocks(T * n_sh)

    assert mrt.frames_out == srt.frames_out
    np.testing.assert_allclose(img_m, img_s, atol=2e-3)


def _fm_truth():
    from tempest_tpu.ops.resample import downgrade_image
    import jax.numpy as jnp

    return np.asarray(downgrade_image(jnp.asarray(
        tt.generate_iq(MODE, FS, 1024, snr_db=25.0, seed=13).frame)))


def test_fm_fidelity_streaming_chain():
    """FM demod composes with the quantised fidelity chain on the live
    runtime (config_overrides demod='fm' + fidelity tables): the
    discriminator output flows through the exact-cut tables like AM.
    (SyntheticSource grew a modulation knob — the live counterpart of
    `cli synth --modulation`.)"""
    from tempest_tpu.render.screen import aligned_psnr

    src = SyntheticSource(MODE, FS, int(FS * 0.2), snr_db=25.0, seed=13,
                          modulation="fm")
    rt = StreamingRuntime(src, MODE, alpha=0.5, fidelity=True,
                          fidelity_bins=16,
                          config_overrides={"demod": "fm"})
    assert rt.config.demod == "fm" and rt.config.phase_bins == 16
    rt.start()
    try:
        img = rt.process_blocks(3)
    finally:
        rt.stop()
    p, _ = aligned_psnr(_fm_truth(), img)
    assert p > 10.0, p


def test_mesh_streaming_fm_chain():
    """FM demod on the MESH runtime (cli stream --mesh --demod fm): each
    shard's chain demodulates with the discriminator."""
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.render.screen import aligned_psnr
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime

    # Larger spans than the AM tests: the FM discriminator average is
    # noisier, and a 0.05 s span holds only 1 frame in ~3 periods (the
    # mesh matches single-chip span-block parity either way — measured
    # 4.8 dB single vs 5.3 mesh at the small spans; 4 frames/span
    # restores the depth).
    S = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, 8 * S, snr_db=25.0, seed=13,
                          modulation="fm")
    rt = MeshStreamingRuntime(src, MODE, make_mesh(8), alpha=0.5,
                              config_overrides={"demod": "fm"})
    assert rt.config.demod == "fm"
    rt.start()
    try:
        img = rt.process_blocks(3)
    finally:
        rt.stop()
    p, _ = aligned_psnr(_fm_truth(), img)
    # Functional composition check, not a quality record: the FM sync
    # chain at span geometry measures ~8 dB (min-max-normalised PSNR).
    assert p > 7.0, p


def test_mesh_streaming_phase_survives_ring_drops():
    """Ring drops on the MESH runtime: the pending/lookahead bookkeeping
    must re-anchor the dispatched block's phase to its production
    sequence, so the reconstructed geometry matches an uninterrupted
    stream's (the same invariant the single-chip runtime pins, with the
    extra subtlety that a dropped block also breaks the halo pairing)."""
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime

    S = int(FS * 0.05)
    block = 8 * S
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=22)
    blocks = []
    buf = np.empty(block, np.complex64)
    for _ in range(6):
        src.read(buf)
        blocks.append(buf.copy())

    def run(ring_depth, n_dispatch):
        s2 = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=22)
        rt = MeshStreamingRuntime(s2, MODE, make_mesh(8), alpha=0.5)
        rt.ring = type(rt.ring)(block, ring_depth)
        for b in blocks:
            rt.ring.put(b)
        img = rt.process_blocks(n_dispatch)
        rt.stop()
        return rt, img

    rt_c, clean = run(8, 5)
    assert rt_c.ring.overflows == 0
    rt_d, dropped = run(3, 2)   # blocks 0-2 overwritten before consuming
    assert rt_d.ring.overflows == 3
    d = np.abs(clean - dropped) / (clean.max() - clean.min() + 1e-9)
    assert d.mean() < 0.02, d.mean()


def test_mesh_streaming_checkpoint_resume(tmp_path):
    """Checkpoint/resume is inherited by the mesh runtime: a resumed
    session rebuilds the mesh program and continues frame-phase-continuous
    averaging at the saved absolute position (the one-block lookahead must
    not shift the restored grid)."""
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime

    S = int(FS * 0.05)
    block = 8 * S
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    rt = MeshStreamingRuntime(src, MODE, make_mesh(8), alpha=0.5)
    rt.start()
    try:
        rt.process_blocks(2)
    finally:
        rt.stop()
    p = str(tmp_path / "mesh.npz")
    rt.save_checkpoint(p)

    src2 = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    rt2 = MeshStreamingRuntime(src2, MODE, make_mesh(8), alpha=0.1)
    rt2.load_checkpoint(p)
    assert rt2.alpha == 0.5
    assert rt2.frames_out == rt.frames_out
    np.testing.assert_array_equal(rt2._ema, rt._ema)
    saved = rt2._abs_pos
    rt2.start()
    try:
        rt2.process_blocks(1)
    finally:
        rt2.stop()
    assert rt2._abs_pos == saved + block
    assert rt2.frames_out > rt.frames_out


def test_mesh_streaming_reconstruction_quality():
    """End-to-end quality through the mesh runtime: the reconstructed EMA
    correlates with the synthesised raster (the flagship drive, on the
    8-device virtual mesh, with the producer thread and ring in the loop)
    and hot-swapping the mode rebuilds the mesh program."""
    from tempest_tpu.ops.resample import downgrade_image
    from tempest_tpu.parallel.mesh import make_mesh
    from tempest_tpu.render.screen import aligned_psnr
    from tempest_tpu.runtime.mesh_stream import MeshStreamingRuntime
    from tempest_tpu.runtime.sources import SyntheticSource
    import jax.numpy as jnp

    n_sh = 8
    S = int(FS * 0.05)
    src = SyntheticSource(MODE, FS, n_sh * S, snr_db=25.0, seed=3)
    rt = MeshStreamingRuntime(src, MODE, make_mesh(n_sh), alpha=0.5)
    rt.start()
    try:
        img = rt.process_blocks(3)
    finally:
        rt.stop()
    assert rt.frames_out >= 3 * n_sh * rt._n_frames // 2
    # The synthetic source renders the deterministic default test pattern:
    # regenerate it for ground truth.
    truth = np.asarray(downgrade_image(jnp.asarray(
        tt.generate_iq(MODE, FS, 1024, snr_db=25.0, seed=3).frame)))
    p, _ = aligned_psnr(truth, img)
    assert p > 10.0, p
    # Mode hot-swap rebuilds the sharded program (console `+ 1` path).
    rt.set_line_count(MODE.height + 1)
    assert rt.mode.height == MODE.height + 1
    assert rt.health()["mesh"]["pending_block"] is False  # dropped on rebuild


def test_cli_stream_mesh(tmp_path, monkeypatch):
    """`cli stream --mesh 8`: the live multi-chip runtime from the CLI on
    the virtual mesh (blocks split into 8 time spans); combine/fidelity
    are refused loudly (single-chip only for now)."""
    monkeypatch.chdir(tmp_path)
    assert cli_main([
        "stream", "--source", "synthetic", "--mode", "640x480 @ 60Hz",
        "--fs", str(FS), "--block-seconds", "0.4", "--blocks", "2",
        "--mesh", "8", "--render", "png", "--out-prefix", "mshot",
    ]) == 0
    assert (tmp_path / "mshot_00000.png").exists()
    # Fidelity on the mesh (quantised per-shard bins) from the CLI too.
    assert cli_main([
        "stream", "--source", "synthetic", "--mode", "640x480 @ 60Hz",
        "--fs", str(FS), "--block-seconds", "0.4", "--blocks", "1",
        "--mesh", "8", "--fidelity", "--fidelity-bins", "16",
        "--render", "png", "--out-prefix", "fshot",
    ]) == 0
    assert (tmp_path / "fshot_00000.png").exists()


def test_cli_stream_fm_single_carrier(tmp_path, monkeypatch):
    """`cli stream --demod fm`: single-carrier live FM through the chain's
    demod config (r4 verdict: stream lacked the flag analyze/reconstruct
    had, forcing operators to fake it with a one-carrier --combine)."""
    monkeypatch.chdir(tmp_path)
    dat = tmp_path / "fm.dat"
    assert cli_main([
        "synth", "--mode", "640x480 @ 60Hz", "--fs", str(FS),
        "--seconds", "0.4", "--snr", "25", "--modulation", "fm",
        "--seed", "3", "--out", str(dat),
    ]) == 0
    assert cli_main([
        "stream", "--source", "replay", "--file", str(dat),
        "--mode", "640x480 @ 60Hz", "--fs", str(FS), "--blocks", "2",
        "--demod", "fm", "--render", "png", "--out-prefix", "fmshot",
    ]) == 0
    assert (tmp_path / "fmshot_00000.png").exists()
    # --demod targets the single-carrier chain; with --combine the front
    # demodulates per channel (--combine-demod) — refused loudly.
    with pytest.raises(SystemExit):
        cli_main([
            "stream", "--source", "replay", "--file", str(dat),
            "--mode", "640x480 @ 60Hz", "--fs", str(FS), "--blocks", "1",
            "--demod", "fm", "--combine", "1e6",
        ])


def test_cli_stream_png_renderer(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli_main([
        "stream", "--source", "synthetic", "--mode", "640x480 @ 60Hz",
        "--fs", str(FS), "--blocks", "2", "--render", "png",
        "--out-prefix", "shot",
    ]) == 0
    shots = sorted(p.name for p in tmp_path.glob("shot_*.png"))
    assert shots == ["shot_00000.png", "shot_00001.png"]
