"""native/build.py: the lazy C++ toolchain driver.

Every process compiles its native components from source into a private
directory, so these tests drive the compile, failure, and rebuild paths
against a scratch target — never the real libspectpu_png.so.
"""

import os
import subprocess
import sys

import pytest

from spectral_tpu.native import build as nb


@pytest.fixture
def scratch_target(tmp_path, monkeypatch):
    """Point the build module at tmp_path with one tiny C++ target."""
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int forty_two() { return 42; }\n')
    monkeypatch.setattr(nb, "_DIR", str(tmp_path))
    monkeypatch.setattr(nb, "TARGETS", {"libtiny.so": (["tiny.cpp"], [])})
    return tmp_path


def test_build_compiles_and_freshness_caches(scratch_target, tmp_path_factory):
    """The library comes from the source on every build: a library already
    sitting in the output directory, or built from an older source, is
    never reused."""
    import ctypes
    out_dir = tmp_path_factory.mktemp("out1")
    path = nb.build("libtiny.so", str(out_dir))
    assert path == str(out_dir / "libtiny.so") and os.path.exists(path)
    assert ctypes.CDLL(path).forty_two() == 42
    # an edited source is what the next build compiles, even into a
    # directory that already holds the old library
    (scratch_target / "tiny.cpp").write_text(
        'extern "C" int forty_two() { return 43; }\n')
    path2 = nb.build("libtiny.so", str(tmp_path_factory.mktemp("out2")))
    assert ctypes.CDLL(path2).forty_two() == 43


def test_build_compile_error_returns_false(scratch_target, tmp_path_factory,
                                           capsys):
    (scratch_target / "tiny.cpp").write_text("this is not C++\n")
    out_dir = tmp_path_factory.mktemp("out")
    assert nb.build("libtiny.so", str(out_dir)) is None
    assert not (out_dir / "libtiny.so").exists()
    # verbose surfaces the compiler's stderr
    assert nb.build("libtiny.so", str(out_dir), verbose=True) is None
    assert "error" in capsys.readouterr().err.lower()


def test_build_missing_toolchain_returns_false(scratch_target, monkeypatch,
                                               tmp_path_factory):
    def no_gxx(*a, **k):
        raise OSError("g++ not found")
    monkeypatch.setattr(nb.subprocess, "run", no_gxx)
    out_dir = tmp_path_factory.mktemp("out")
    assert nb.build("libtiny.so", str(out_dir)) is None
    assert os.listdir(out_dir) == []


def test_build_all_and_module_entrypoint(scratch_target):
    assert nb.build_all() is True
    # python -m spectral_tpu.native.build (the documented toolchain check)
    res = subprocess.run([sys.executable, "-m", "spectral_tpu.native.build"],
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0
    assert "ok" in res.stdout
