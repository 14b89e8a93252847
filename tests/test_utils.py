"""Tests for checkpoints, metrics, and runtime failure propagation."""

import numpy as np
import pytest

import tempest_tpu as tt
from tempest_tpu.runtime.stream import StreamingRuntime
from tempest_tpu.utils.checkpoint import RuntimeState, load_state, save_state
from tempest_tpu.utils.profiling import Metrics

MODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6


def test_checkpoint_roundtrip(tmp_path):
    state = RuntimeState(
        ema=np.random.default_rng(0).random((600, 800)).astype(np.float32),
        abs_pos=123456,
        mode=MODE,
        sample_rate=FS,
        alpha=0.25,
        frames_out=42,
    )
    p = str(tmp_path / "ckpt.npz")
    save_state(state, p)
    back = load_state(p)
    np.testing.assert_array_equal(back.ema, state.ema)
    assert back.abs_pos == 123456
    assert back.mode == MODE
    assert back.alpha == pytest.approx(0.25)
    assert back.frames_out == 42


def test_runtime_checkpoint_resume(tmp_path):
    from tempest_tpu.runtime.sources import SyntheticSource

    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    rt = StreamingRuntime(src, MODE, alpha=0.5)
    rt.start()
    try:
        rt.process_blocks(2)
    finally:
        rt.stop()
    p = str(tmp_path / "rt.npz")
    rt.save_checkpoint(p)

    src2 = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    rt2 = StreamingRuntime(src2, MODE, alpha=0.1)
    rt2.load_checkpoint(p)
    assert rt2.frames_out == rt.frames_out
    assert rt2.alpha == 0.5
    assert rt2._abs_pos == rt._abs_pos
    np.testing.assert_array_equal(rt2._ema, rt._ema)

    # Phase-continuous resume must survive actually processing a block: the
    # ring's sequence-based re-anchoring (ring seq 0 of the NEW source) must
    # not clobber the restored absolute position — the resumed stream's next
    # block continues the checkpointed signal at abs_pos, so after one block
    # the position is abs_pos + block, not block.
    saved_pos = rt2._abs_pos
    rt2.start()
    try:
        rt2.process_blocks(1)
    finally:
        rt2.stop()
    assert rt2._abs_pos == saved_pos + block
    assert rt2.frames_out > rt.frames_out


def test_checkpoint_resumes_full_chain_state(tmp_path):
    """The COMPLETE runtime state rides the checkpoint (r4 verdict: excise/
    fidelity/invert were silently dropped): a resumed session built with
    all-default constructor args must be indistinguishable from the saved
    one — same rebuilt ReconstructionConfig, same health()['combine']."""
    from tempest_tpu.runtime.sources import SyntheticSource

    block = int(FS * 0.2)
    carriers = [-1.2e6, 1.2e6]
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    # AM + excision (fm + excision is refused by check_excise_demod —
    # its own test asserts the raise).
    rt = StreamingRuntime(src, MODE, alpha=0.5, fidelity=True,
                          fidelity_bins=32, invert=True, combine=carriers,
                          combine_bw=1.5e6, combine_demod="am",
                          combine_excise_db=3.0)
    p = str(tmp_path / "full.npz")
    rt.save_checkpoint(p)

    src2 = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=7)
    rt2 = StreamingRuntime(src2, MODE)  # every knob at its default
    rt2.load_checkpoint(p)
    assert rt2.fidelity is True
    assert rt2.fidelity_bins == 32
    assert rt2.invert is True
    assert rt2._combine_excise == 3.0
    assert rt2.config == rt.config
    assert rt2.health()["combine"] == rt.health()["combine"]

    # FM demod (excise off) and the None-excise NaN sentinel round-trip.
    rt.set_combine(carriers, demod="fm", excise_db=None)
    rt.save_checkpoint(p)
    rt2.load_checkpoint(p)
    assert rt2._combine_demod == "fm"
    assert rt2._combine_excise is None


def test_producer_error_propagates():
    class FailingSource:
        sample_rate = FS
        block_size = 140000

        def __init__(self):
            self.n = 0

        def read(self, out):
            self.n += 1
            if self.n > 2:
                raise IOError("radio unplugged")
            out[:] = 0

        def close(self):
            pass

    rt = StreamingRuntime(FailingSource(), MODE, alpha=0.5, n_frames_per_block=1)
    rt.start()
    try:
        with pytest.raises(RuntimeError, match="sample source failed"):
            rt.process_blocks(10)
    finally:
        rt.stop()


def test_metrics_registry():
    m = Metrics()
    m.count("frames", 30)
    m.count("frames", 30)
    m.gauge("alpha", 0.1)
    snap = m.snapshot()
    assert snap["counters"]["frames"] == 60
    assert snap["gauges"]["alpha"] == 0.1
    assert m.rate("frames") > 0
    assert "frames" in m.json()


def test_profiler_trace_writes(tmp_path):
    import jax.numpy as jnp

    from tempest_tpu.utils.profiling import annotate, trace

    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("toy"):
            _ = jnp.arange(8).sum().block_until_ready()
    import os

    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert found, "profiler trace produced no files"


def test_profile_stages_counts_matmuls_in_their_stage(tmp_path):
    """A matmul under a named scope is charged to that stage, not "other"."""
    import jax
    import jax.numpy as jnp

    from tempest_tpu.utils.profiling import profile_stages

    def f(a, b):
        with jax.named_scope("demod"):
            e = jnp.dot(a * a, b, precision="highest")
        with jax.named_scope("ema"):
            return jnp.tanh(e) + 1.0

    args = (jnp.ones((512, 128)), jnp.ones((128, 64)))
    st = profile_stages(jax.jit(f).lower(*args), args, str(tmp_path),
                        ("demod", "ema"))
    assert st["events"] > 0
    assert st["demod"] > 0 and st["ema"] > 0
    assert st["total"] == pytest.approx(st["demod"] + st["ema"] + st["other"])


def test_hlo_op_names_library_gemm():
    """GPU library GEMMs are custom calls whose backend_config follows the
    metadata; their instruction still maps to its scope."""
    from tempest_tpu.utils.profiling import _hlo_op_names

    text = (
        '  %cublas-gemm.3 = (f32[96,64]{1,0}, s8[0]{0}) custom-call('
        'f32[96,128]{1,0} %a, f32[128,64]{1,0} %b), '
        'custom_call_target="__cublas$gemm", metadata={op_name="jit(step)'
        '/demod/dot_general" source_file="x.py" source_line=3}, '
        'backend_config={"gemm_backend_config":{"alpha_real":1}}\n'
        '  ROOT %loop_add_fusion = f32[96,64]{1,0} fusion(%x), kind=kLoop, '
        'calls=%fused, metadata={op_name="jit(step)/vmap(sync)/add"}\n')
    assert _hlo_op_names(text) == {
        "cublas-gemm.3": "jit(step)/demod/dot_general",
        "loop_add_fusion": "jit(step)/vmap(sync)/add"}


def test_file_renderer(tmp_path):
    import numpy as np

    from tempest_tpu.render.screen import FileRenderer

    sink = FileRenderer(prefix=str(tmp_path / "f"), every=2)
    img = np.random.default_rng(0).random((30, 40)).astype(np.float32)
    for _ in range(4):
        sink(img, {})
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["f_00000.png", "f_00002.png"]


def test_roofline_report():
    import jax.numpy as jnp

    from tempest_tpu.utils.roofline import RooflineReport, device_peaks, roofline

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    rep = roofline(lambda a, b: a @ b, jnp.ones((256, 256)), jnp.ones((256, 256)))
    assert rep.flops > 0
    assert rep.bound(peaks) in ("compute", "memory")
    assert rep.speed_of_light_s(peaks) > 0
    assert "GFLOP" in rep.summary(peaks, measured_s=1e-3)
    # Hand-built report sanity: 1 GFLOP over 1 GB is memory-bound on an H100
    # (bf16 ridge ~295 flop/B), and its light-speed time is the HBM time.
    r = RooflineReport(flops=1e9, bytes_accessed=1e9, transcendentals=0)
    assert r.bound(peaks) == "memory"
    assert r.speed_of_light_s(peaks) == pytest.approx(1e9 / 3.35e12)


@pytest.mark.parametrize("compute,flops", [("bf16", 989e12), ("tf32", 495e12),
                                           ("f32", 67e12)])
def test_device_peaks_h100(compute, flops):
    from tempest_tpu.utils.roofline import device_peaks

    p = device_peaks("NVIDIA H100 80GB HBM3", compute)
    assert p == {"flops_per_s": flops, "bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100"])
def test_device_peaks_unknown_device_raises(kind):
    """No default peak: a device missing from the table is an error (the
    CPU test backend included)."""
    from tempest_tpu.utils.roofline import device_peaks

    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(kind)


def test_device_peaks_default_is_the_running_device():
    import jax

    from tempest_tpu.utils.roofline import device_peaks

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(ValueError, match=repr(jax.devices()[0].device_kind)):
        device_peaks()


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from tempest_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert compile_cache.configure_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert compile_cache.configure_compile_cache() == ""
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import os

    import jax

    from tempest_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        first = compile_cache.configure_compile_cache()
        assert compile_cache.configure_compile_cache() == first
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert first == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
