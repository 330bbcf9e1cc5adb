"""Fallback/error branches of the native PNG binding and the NIX loader's
hostile-metadata edges (covlite r5 gaps: native/png_native.py 84%,
io/nix.py 93%)."""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest

from spectral_tpu.native import png_native as pn


@pytest.fixture
def fresh_binding(monkeypatch):
    """Each test re-resolves the lazy binding from a clean slate."""
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_load_attempted", False)
    return pn


def test_build_failure_means_unavailable(fresh_binding, monkeypatch):
    monkeypatch.setattr(pn._build, "build", lambda name, out_dir: None)
    assert pn.available() is False
    with pytest.raises(RuntimeError, match="unavailable"):
        pn.encode(np.zeros((2, 2, 4), np.uint8))
    with pytest.raises(RuntimeError, match="unavailable"):
        pn.encode_palette(np.zeros((2, 2), np.uint8),
                          np.zeros((4, 3), np.uint8))


def test_cdll_load_failure_means_unavailable(fresh_binding, monkeypatch):
    monkeypatch.setattr(pn._build, "build",
                        lambda name, out_dir: f"{out_dir}/{name}")

    def no_dlopen(path):
        raise OSError("not a shared object")
    monkeypatch.setattr(ctypes, "CDLL", no_dlopen)
    assert pn.available() is False
    # the failed attempt is cached — no second dlopen storm
    assert pn._load_attempted is True and pn._lib is None


def test_encoder_error_codes_raise(fresh_binding, monkeypatch):
    fake = SimpleNamespace(
        png_encode_bound=lambda h, w, c: 1024,
        png_encode=lambda *a: -2,
        png_encode_pal=lambda *a: -3)
    monkeypatch.setattr(pn, "_lib", fake)
    monkeypatch.setattr(pn, "_load_attempted", True)
    with pytest.raises(RuntimeError, match=r"code -2"):
        pn.encode(np.zeros((2, 2, 4), np.uint8))
    with pytest.raises(RuntimeError, match=r"code -3"):
        pn.encode_palette(np.zeros((2, 2), np.uint8),
                          np.zeros((4, 3), np.uint8))


def test_encode_palette_shape_validation():
    if not pn.available():
        pytest.skip("native encoder not built")
    with pytest.raises(ValueError, match="palette"):
        pn.encode_palette(np.zeros((2, 2, 1), np.uint8),
                          np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match="palette"):
        pn.encode_palette(np.zeros((2, 2), np.uint8),
                          np.zeros((4, 4), np.uint8))


# ---- io/nix.py hostile-metadata edges --------------------------------------

h5py = pytest.importorskip("h5py")


def _nix_skeleton(path, si_value=None, si_unit="s", dim_type="sample"):
    """One block / one segment / one signal whose sampling dimension is
    parameterized for hostile-metadata tests."""
    with h5py.File(path, "w") as f:
        block = f.create_group("data/block0")
        das = block.create_group("data_arrays")
        groups = block.create_group("groups")
        seg = groups.create_group("segment0")
        seg_das = seg.create_group("data_arrays")
        da = seg_das.create_group("sig0")
        da.attrs["name"] = "AnalogSignal"
        da.create_dataset("data", data=np.arange(64, dtype=np.float32))
        dims = da.create_group("dimensions")
        d1 = dims.create_group("1")
        d1.attrs["dimension_type"] = dim_type
        if si_value is not None:
            d1.attrs["sampling_interval"] = si_value
        d1.attrs["unit"] = si_unit


@pytest.mark.parametrize("kw,why", [
    (dict(si_value=b"not-a-number"), "non-numeric sampling_interval"),
    (dict(si_value=0.001, si_unit="furlongs"), "unknown time unit"),
    (dict(si_value=-0.001), "negative interval"),
    (dict(si_value=float("nan")), "NaN interval"),
    (dict(si_value=None), "missing interval"),
    (dict(si_value=0.001, dim_type="range"), "non-sample dimension"),
])
def test_nix_corrupt_sampling_metadata_skips_sweep(tmp_path, kw, why):
    """An unknowable rate must SKIP the sweep (SweepManager.py:130-132
    semantics), never register one that divides to nonsense downstream."""
    from spectral_tpu.io.nix import load_nix_h5
    from spectral_tpu.io.registry import SweepRegistry
    p = str(tmp_path / "bad.h5")
    _nix_skeleton(p, **kw)
    reg = SweepRegistry()
    assert load_nix_h5(p, reg) == [], why


def test_nix_millisecond_unit_converts(tmp_path):
    from spectral_tpu.io.nix import load_nix_h5
    from spectral_tpu.io.registry import SweepRegistry
    p = str(tmp_path / "ms.h5")
    _nix_skeleton(p, si_value=1.0, si_unit="ms")     # 1 ms -> 1 kHz
    reg = SweepRegistry()
    names = load_nix_h5(p, reg)
    assert len(names) == 1
    _x, fs = reg.get_signal(names[0])
    assert fs == pytest.approx(1000.0)


def test_generic_h5_nonnumeric_fs_attr_skipped(tmp_path):
    """Generic (non-NIX) fallback: a string fs attr is hostile metadata —
    try the other keys, then skip, never crash."""
    from spectral_tpu.io.nix import load_nix_h5
    from spectral_tpu.io.registry import SweepRegistry
    p = str(tmp_path / "gen.h5")
    with h5py.File(p, "w") as f:
        ds = f.create_dataset("trace", data=np.arange(32, dtype=np.float32))
        ds.attrs["fs"] = b"fast"                    # non-numeric
        ds.attrs["sampling_rate"] = -44100.0        # negative
    reg = SweepRegistry()
    assert load_nix_h5(p, reg) == []
