"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite runs on the CPU; per SURVEY.md §4 kernels and sharding/collectives
are validated on XLA's host-platform virtual devices.  The GPU is reached by
``python chip_smoke.py`` (``--devices 4`` for the mesh paths), and tests that
need the card carry the ``gpu`` marker and skip here (see the ``gpu_host``
fixture).

``XLA_FLAGS`` has to be in the environment before the CPU backend
initialises, which this import-time hook guarantees; the platform is also
pinned through ``jax.config`` in case an installed plugin overrides the
environment variable.  Tests write no persistent compilation cache: an empty
``JAX_COMPILATION_CACHE_DIR`` disables it (``utils.compile_cache``).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect 8 virtual CPU devices"


# Smoke tier (`pytest -m smoke`, target ≤5 min): one fast representative per
# subsystem, biased toward jitted-call signatures — the class of test that
# catches static_argnames/tracer regressions (VERDICT r4 Weak #1).  Kept as a
# central list (rather than scattered decorators) so the whole tier is
# reviewable at a glance.  Bare function name = every parametrization.
_SMOKE = {
    # io + synthetic generator
    "test_dat_roundtrip_short",
    "test_generate_iq_envelope_matches_raster",
    # video-mode DB
    "test_self_consistency_exact",
    # ops jit boundaries: demod / autocorr / framesync / resample / ingest
    "test_am_demod",
    "test_autocorrelation_matches_numpy_oracle",
    "test_refresh_and_line_count_from_synthetic",
    "test_frame_sync_finds_blanking",
    "test_align_frame_subpixel_matmul_matches_rolls",
    "test_frame_to_screen_matches_two_stage",
    "test_iq_ingest_formulations_match_oracle",
    # offline pipeline (incl. the evidence path that broke in r4)
    "test_estimate_timing_exact_mode",
    "test_auto_reconstruct_fidelity",
    "test_pick_line_peak_recovers_true_mode",
    "test_timing_evidence_matches_estimate",
    # sharded mirrors (virtual mesh)
    "test_sharded_reconstruct_matches_single_chip",
    "test_sharded_combine_matches_single_device",
    # streaming runtime + console/evidence surface
    "test_streaming_runtime_end_to_end",
    "test_streaming_runtime_correlate_hotswap",
    "test_runtime_pick_line_peak",
    # scan / combine / enhance
    "test_scan_band_localises_emission",
    "test_combine_single_carrier_is_channel_envelope",
    "test_auto_reconstruct_restores_by_default",
    # checkpoint/resume + hardware read loop
    "test_checkpoint_roundtrip",
    "test_runtime_checkpoint_resume",
    "test_read_survives_timeout_and_overflow_storm",
    # driver contract: flagship forward step compiles
    "test_entry_compiles_and_runs",
}


@pytest.fixture
def gpu_host():
    """For tests marked ``gpu``: skip unless this host has an NVIDIA card.

    Decided here, at run time, never at import or collection (every xdist
    worker must collect the same tests).  The suite's own process stays on
    the CPU backend, so a ``gpu`` test drives the card from a child process
    — one JAX process per card."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (none visible to nvidia-smi)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.originalname in _SMOKE or item.name in _SMOKE:
            item.add_marker(pytest.mark.smoke)
