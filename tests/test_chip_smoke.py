"""chip_smoke.py's phases, run end to end at a tiny size (640x480@60 at
4 Msps) on the CPU backend, and its refusal to run without a GPU.  The
full-width run happens on the card (``python chip_smoke.py``)."""

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODE = "640x480 @ 60Hz"
FS = 4e6


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()


def test_phase_offline_tiny(tmp_path):
    r = cs.phase_offline(str(tmp_path), MODE, FS, 0.3)
    assert r["mode"] == MODE
    assert r["refresh_err_mhz"] <= 5.0
    assert r["aligned_psnr_db"] >= cs.PSNR_FLOOR_DB
    assert "frames averaged" in r["reconstruct"]


@pytest.mark.parametrize("fidelity", [False, True])
def test_phase_streaming_tiny(fidelity):
    r = cs.phase_streaming(MODE, FS, 0.1, 2, fidelity)
    assert r["health"]["frames_out"] == 3 * 4
    assert r["warm_s_per_block"] > 0
    assert r["health"]["producer_error"] is None
    assert r["aligned_psnr_db"] >= cs.PSNR_FLOOR_DB
    assert f"fidelity={fidelity}" in r["ran"]


def _capture(cfg, seed=1):
    from tempest_tpu.io.synthetic import generate_iq

    return generate_iq(cfg.mode, FS, cfg.block_samples, snr_db=20.0,
                       seed=seed).iq


def test_phase_judged_tiny(tmp_path):
    cfg = cs.judged_config(MODE, FS, 4, 16)
    words = cs.int16_words(_capture(cfg))
    assert words.dtype == np.int16 and words.size == 2 * cfg.block_samples
    r = cs.phase_judged(cfg, words, str(tmp_path / "trace"), warm_blocks=2)
    assert r["aligned_psnr_db"] >= cs.PSNR_FLOOR_DB
    assert r["memory_analysis"]["output_size_in_bytes"] > 0
    st = r["stage_ms_one_block"]
    # Every stage of the judged step shows up in the trace.
    assert st["events"] > 0
    for stage in ("demod", "resample", "sync", "ema"):
        assert st[stage] > 0, st
    assert st["total"] >= st["resample"]


@pytest.mark.parametrize("judged", [True, False])
def test_phase_agreement_tiny(judged):
    """On the CPU f32 matmuls are true f32, so the only difference from the
    oracle is the judged step's bf16 weights einsum; both sit well inside
    the tolerances stated for the card."""
    from tempest_tpu.runtime.sources import SyntheticSource
    from tempest_tpu.runtime.stream import StreamingRuntime
    from tempest_tpu.video.modes import ALL_VIDEO_MODES

    if judged:
        cfg = cs.judged_config(MODE, FS, 4, 16)
        iq, tol = cs.int16_words(_capture(cfg)), cs.TOL_TF32_BF16
    else:
        mode = ALL_VIDEO_MODES[MODE]
        cfg = StreamingRuntime(SyntheticSource(mode, FS, int(FS * 0.1)),
                               mode).config
        iq = np.ascontiguousarray(_capture(cfg)).view(np.float32)
        tol = cs.TOL_TF32
    r = cs.phase_agreement("tiny", cfg, iq, tol)
    assert r["max_abs_diff_over_range"] <= tol
    if not judged:  # nothing differs on the CPU but the einsum precision
        assert r["max_abs_diff_over_range"] < 1e-5
        assert r["max_sync_diff_px"] == 0.0


def test_phase_wideband_tiny(tmp_path):
    r = cs.phase_wideband(str(tmp_path), MODE, 16e6, 0.3, "-4e6,3e6")
    assert r["screens"][0]["mode"] == MODE
    assert r["screens"][0]["carriers"] == 2
    assert r["emissions"] == 2


def test_phase_mesh_tiny():
    r = cs.phase_mesh(jax.devices()[:4], MODE, FS, 0.1)
    assert r["mesh_vs_one_card_max_abs_diff_over_range"] <= cs.TOL_MESH
    assert r["search_best_n_cards"] == MODE
    assert r["search_ranking_equal_one_card_same_program"]


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert "needs an NVIDIA GPU" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails_and_prints_no_result(tmp_path):
    """Outside a checkout (the script with nothing else of the repo) the
    script exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_read_png_roundtrip(tmp_path):
    from tempest_tpu.render.screen import read_png, to_uint8, write_png

    img = np.random.default_rng(0).random((30, 40)).astype(np.float32)
    write_png(img, str(tmp_path / "x.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "x.png")),
                                  to_uint8(img))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "bad.png"))


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_host):
    """The full-width smoke run on the card, from a child process (one JAX
    process per card; this suite's own process stays on the CPU)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
