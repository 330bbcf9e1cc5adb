"""STFT engine auto-routing (core.stft.default_use_matmul).

use_matmul=None must resolve to XLA's O(N log N) FFT engine on every
backend — the CPU here and the GPU (cuFFT) on the card — and the resolved
path must be bit-identical to the explicitly pinned engine. The dense DFT
and CT matmul engines run only when pinned.
"""

import jax
import numpy as np
import pytest

from spectral_tpu.config import SpecConfig
from spectral_tpu.core import stft as st


@pytest.fixture
def x():
    rng = np.random.RandomState(7)
    return rng.randn(4096).astype(np.float32)


def test_default_use_matmul_backend_aware(monkeypatch):
    # conftest pins the cpu platform
    assert st.default_use_matmul() is False
    monkeypatch.setattr(st.jax, "default_backend", lambda: "gpu")
    assert st.default_use_matmul() is False


@pytest.mark.parametrize("cfg", [
    SpecConfig.scipy_default(128), SpecConfig.north_star(128, 32),
    SpecConfig(nperseg=100, nfft=128, hop=25), SpecConfig.scipy_default(64),
    SpecConfig.scipy_default(256), SpecConfig.scipy_default(1024),
    SpecConfig.scipy_default(8192)], ids=lambda c: f"{c.nperseg}_{c.nfft_}")
def test_auto_routes_to_fft_under_gpu_backend_every_shape(cfg, monkeypatch):
    """No shape exception: every nfft — including the sizes the CT and
    dense engines cover — auto-routes to the FFT engine on the GPU."""
    monkeypatch.setattr(st.jax, "default_backend", lambda: "gpu")
    assert st.default_use_matmul(cfg) is False


def test_auto_routes_to_fft_on_cpu(x):
    cfg = SpecConfig.north_star(256, 64)
    auto = np.asarray(st.power_spectrogram(x, 1000.0, cfg))
    fft = np.asarray(st.power_spectrogram(x, 1000.0, cfg, use_matmul=False))
    assert np.array_equal(auto, fft)


def test_auto_routes_to_fft_under_gpu_backend(x, monkeypatch):
    monkeypatch.setattr(st.jax, "default_backend", lambda: "gpu")
    cfg = SpecConfig.north_star(256, 64)
    auto = np.asarray(st.power_spectrogram(x, 1000.0, cfg))
    fft = np.asarray(st.power_spectrogram(x, 1000.0, cfg, use_matmul=False))
    assert np.array_equal(auto, fft)
    # sanity: on this input the two engines differ in the low ulps, so
    # array_equal above genuinely distinguishes the routes
    mm = np.asarray(st.power_spectrogram(x, 1000.0, cfg, use_matmul=True))
    assert not np.array_equal(mm, fft)
    assert np.allclose(mm, fft, rtol=1e-4, atol=1e-9)


def test_stft_and_spectrogram_accept_auto(x):
    cfg = SpecConfig.scipy_default(512)
    z_auto = np.asarray(st.stft(x, cfg))
    z_fft = np.asarray(st.stft(x, cfg, use_matmul=False))
    assert np.array_equal(z_auto, z_fft)
    f, t, sxx = st.spectrogram(x, 1000.0, cfg)
    f2, t2, sxx2 = st.spectrogram(x, 1000.0, cfg, use_matmul=False)
    assert np.array_equal(np.asarray(sxx), np.asarray(sxx2))


def test_streaming_defaults_auto_route(x, monkeypatch):
    """The streaming drivers' use_matmul=None must follow the same routing
    (the CLI stream command relies on this default)."""
    from spectral_tpu.parallel.streaming import scan_spectrogram
    cfg = SpecConfig.north_star(256, 64)
    out_auto = np.asarray(scan_spectrogram(x, 1000.0, cfg, chunk_size=512))
    mono = np.asarray(st.power_spectrogram(x, 1000.0, cfg, use_matmul=False))
    np.testing.assert_allclose(out_auto, mono, rtol=1e-4, atol=1e-10)
    monkeypatch.setattr(st.jax, "default_backend", lambda: "gpu")
    out_gpu = np.asarray(scan_spectrogram(x, 1000.0, cfg, chunk_size=512))
    np.testing.assert_allclose(out_gpu, mono, rtol=1e-4, atol=1e-10)


def test_center_true_fft_engine_matches_matmul_and_manual_pad(x):
    """The rFFT engine's centered framing (core.stft._prep_frames pad
    branch) ran only through the matmul route in the rest of the suite —
    cross-check all three derivations: FFT engine == matmul engine ==
    explicit reflect-pad + center=False, and the centered time axis is
    k*hop/fs."""
    import dataclasses
    fs = 1000.0
    cfg = SpecConfig(nperseg=256, hop=64, center=True)
    fft = np.asarray(st.power_spectrogram(x, fs, cfg, use_matmul=False))
    mm = np.asarray(st.power_spectrogram(x, fs, cfg, use_matmul=True))
    np.testing.assert_allclose(fft, mm, rtol=2e-4, atol=1e-9)

    p = cfg.nperseg // 2
    xp = np.pad(x, (p, p), mode="reflect")
    uncfg = dataclasses.replace(cfg, center=False)
    manual = np.asarray(st.power_spectrogram(xp, fs, uncfg,
                                             use_matmul=False))
    np.testing.assert_array_equal(fft, manual)

    t = st.time_axis(cfg, fs, len(x))
    assert t.shape == (fft.shape[0],)
    np.testing.assert_allclose(t, np.arange(len(t)) * cfg.hop_ / fs)
    # uncentered axis starts at the frame CENTER instead
    tu = st.time_axis(uncfg, fs, len(x))
    assert tu[0] == cfg.nperseg / 2.0 / fs
