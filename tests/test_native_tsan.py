"""Race detection for the native ring: build the C++ stress harness under
ThreadSanitizer and run it (SURVEY.md §5 — the reference has no sanitizers)."""

import os
import shutil
import subprocess

import pytest

NATIVE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tempest_tpu",
    "native",
)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_ring_tsan_stress(tmp_path):
    exe = tmp_path / "ring_stress"
    build = subprocess.run(
        [
            "g++", "-O1", "-g", "-std=c++17", "-fsanitize=thread", "-fPIE",
            os.path.join(NATIVE, "host_core.cpp"),
            os.path.join(NATIVE, "ring_stress.cpp"),
            "-o", str(exe), "-lpthread",
        ],
        capture_output=True, text=True, timeout=180,
    )
    assert build.returncode == 0, build.stderr[-800:]
    run = subprocess.run(
        [str(exe)], capture_output=True, text=True, timeout=300,
        env={**os.environ, "TSAN_OPTIONS": "halt_on_error=1 exitcode=66"},
    )
    assert run.returncode == 0, (
        f"TSan/stress failure (rc={run.returncode}):\n"
        f"{run.stdout[-400:]}\n{run.stderr[-1200:]}"
    )
    assert run.stdout.startswith("OK")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_host_core_rebuilds_under_a_new_key(tmp_path, monkeypatch):
    """A library keyed by other source or other flags is never loaded:
    loading builds one under the current key."""
    from tempest_tpu import native

    src = tmp_path / "host_core.cpp"
    shutil.copyfile(os.path.join(NATIVE, "host_core.cpp"), src)
    monkeypatch.setattr(native, "_SRC", str(src))

    def fresh_load():
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        lib = native.load_host_core()
        assert lib is not None
        return lib

    # A library left by a build with other flags.
    flags = native._FLAGS
    monkeypatch.setattr(native, "_FLAGS", (*flags, "-DSTALE_BUILD"))
    stale = native.library_path(str(src))
    assert fresh_load()._name == stale
    monkeypatch.setattr(native, "_FLAGS", flags)
    here = native.library_path(str(src))
    assert here != stale and not os.path.exists(here)
    assert fresh_load()._name == here
    # An edited source is a new key too: rebuilt, not the old binary.
    with open(src, "a") as f:
        f.write("\n// edited\n")
    edited = native.library_path(str(src))
    assert edited not in (here, stale)
    lib = fresh_load()
    assert lib._name == edited
    assert sorted(p.name for p in (tmp_path / "_build").glob("*.so")) == sorted(
        os.path.basename(p) for p in (stale, here, edited))
    # The rebuilt library works.
    h = lib.ring_create(8, 2)
    assert h and lib.ring_available(h) == 0
    lib.ring_destroy(h)
