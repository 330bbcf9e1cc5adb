"""Randomized config fuzz vs scipy: many (nperseg, hop, window, n, fs)
combinations beyond the fixed golden matrix (tests/test_stft_golden.py).

The GUI's legal parameter space is nperseg in 32..8192 step 32 with the
scipy-default hop (GUI.py:87-90); the north-star space adds explicit hops
and window families. Seeded sampling keeps runs reproducible.
"""

import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from spectral_tpu.config import SpecConfig
from spectral_tpu.core import stft as stft_mod

RNG = np.random.RandomState(20260816)


def _signal(n, fs, kind, seed):
    r = np.random.RandomState(seed)
    t = np.arange(n) / fs
    if kind == 0:
        return r.randn(n)
    if kind == 1:
        return np.sin(2 * np.pi * (fs * 0.05) * t) + 0.1 * r.randn(n)
    return r.randn(n) + 3.0 * r.rand()        # offset -> detrend matters


@pytest.mark.parametrize("trial", range(10))
def test_fuzz_scipy_default_grid(trial):
    r = np.random.RandomState(trial * 7 + 1)
    nperseg = int(r.randint(1, 257)) * 32      # the GUI's 32..8192 step 32
    fs = float(r.choice([250.0, 1000.0, 16000.0, 48000.0]))
    n = int(nperseg * r.uniform(3.0, 8.0))
    x = _signal(n, fs, int(r.randint(3)), trial)
    cfg = SpecConfig.scipy_default(nperseg)

    f_ref, t_ref, sxx_ref = scipy.signal.spectrogram(
        x, fs=fs, nperseg=nperseg, scaling="density", mode="psd")
    f, t, sxx = stft_mod.spectrogram(jnp.asarray(x, jnp.float32), fs, cfg)
    np.testing.assert_allclose(f, f_ref, atol=1e-9)
    np.testing.assert_allclose(t, t_ref, atol=1e-9)
    err = np.max(np.abs(np.asarray(sxx) - sxx_ref)) / sxx_ref.max()
    assert err < 4e-5, (nperseg, fs, n, err)


@pytest.mark.parametrize("trial", range(10))
def test_fuzz_north_star_combos(trial):
    r = np.random.RandomState(trial * 13 + 5)
    nperseg = int(2 ** r.randint(6, 13))       # 64..4096
    hop = max(1, nperseg // int(2 ** r.randint(1, 4)))
    window = ["hann", "hamming", "blackman", ("tukey", 0.25)][r.randint(4)]
    fs = float(r.choice([1000.0, 8000.0, 16000.0]))
    n = int(nperseg * r.uniform(4.0, 10.0))
    x = _signal(n, fs, int(r.randint(3)), trial + 100)
    cfg = SpecConfig.north_star(nperseg, hop, window=window)

    f_ref, t_ref, sxx_ref = scipy.signal.spectrogram(
        x, fs=fs, window=scipy.signal.get_window(window, nperseg,
                                                 fftbins=True),
        nperseg=nperseg, noverlap=nperseg - hop, detrend=False,
        scaling="density", mode="psd")
    use_matmul = bool(r.randint(2))
    f, t, sxx = stft_mod.spectrogram(jnp.asarray(x, jnp.float32), fs, cfg,
                                     use_matmul=use_matmul)
    np.testing.assert_allclose(t, t_ref, atol=1e-9)
    np.testing.assert_allclose(f, f_ref, atol=1e-9)
    err = np.max(np.abs(np.asarray(sxx) - sxx_ref)) / sxx_ref.max()
    assert err < 4e-5, (nperseg, hop, window, fs, n, use_matmul, err)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_zero_padded_nfft(trial):
    """Random zero-padded transforms (scipy's nfft > nperseg) through both
    engines vs scipy. The nfft draw deliberately spans the routing space:
    non-128-multiples (dense only), CT-sized nfft with small nperseg
    (cost-gated back to dense), and genuine CT shapes."""
    r = np.random.RandomState(trial * 17 + 3)
    nperseg = int(r.randint(1, 33)) * 32              # 32..1024
    nfft = nperseg + int(r.randint(1, 65)) * 32       # up to nperseg+2048
    hop = max(1, nperseg // int(2 ** r.randint(1, 4)))
    window = ["hann", "hamming", ("tukey", 0.25)][r.randint(3)]
    fs = float(r.choice([1000.0, 16000.0]))
    n = int(nperseg * r.uniform(4.0, 8.0))
    x = _signal(n, fs, int(r.randint(3)), trial + 300)
    cfg = SpecConfig.north_star(nperseg, hop, window=window, nfft=nfft)

    f_ref, t_ref, sxx_ref = scipy.signal.spectrogram(
        x, fs=fs, window=scipy.signal.get_window(window, nperseg,
                                                 fftbins=True),
        nperseg=nperseg, noverlap=nperseg - hop, nfft=nfft, detrend=False,
        scaling="density", mode="psd")
    use_matmul = bool(r.randint(2))
    f, t, sxx = stft_mod.spectrogram(jnp.asarray(x, jnp.float32), fs, cfg,
                                     use_matmul=use_matmul)
    np.testing.assert_allclose(t, t_ref, atol=1e-9)
    np.testing.assert_allclose(f, f_ref, atol=1e-9)
    err = np.max(np.abs(np.asarray(sxx) - sxx_ref)) / sxx_ref.max()
    assert err < 4e-5, (nperseg, hop, nfft, window, fs, use_matmul, err)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_freq_major_parity(trial):
    """Random configs through power_spectrogram_fm (both flip senses, both
    engines) vs the transposed frame-major result — covers the dense fold,
    the CT/FFT transpose fallback, zero-padding, and detrend draws the
    fixed CASES table in test_freq_major.py cannot."""
    r = np.random.RandomState(trial * 23 + 11)
    nperseg = int(r.randint(1, 65)) * 32              # 32..2048
    nfft = nperseg if r.randint(2) else \
        nperseg + int(r.randint(0, 33)) * 64
    hop = max(1, nperseg // int(2 ** r.randint(1, 4)))
    window = ["hann", "hamming", ("tukey", 0.25)][r.randint(3)]
    detrend = ["none", "constant", "linear"][r.randint(3)]
    mode = ["psd", "magnitude"][r.randint(2)]
    fs = float(r.choice([1000.0, 16000.0]))
    n = int(nperseg * r.uniform(3.0, 7.0))
    x = _signal(n, fs, int(r.randint(3)), trial + 400).astype(np.float32)
    cfg = SpecConfig(nperseg=nperseg, hop=hop, window=window, nfft=nfft,
                     detrend=detrend, mode=mode)
    use_matmul = bool(r.randint(2))
    flip = bool(r.randint(2))

    tf = np.asarray(stft_mod.power_spectrogram(
        jnp.asarray(x), fs, cfg, use_matmul=use_matmul))
    ref = tf.swapaxes(-1, -2)
    if flip:
        ref = ref[::-1]
    fm = np.asarray(stft_mod.power_spectrogram_fm(
        jnp.asarray(x), fs, cfg, use_matmul=use_matmul, flip_freqs=flip))
    assert fm.shape == ref.shape, (nperseg, hop, nfft, use_matmul, flip)
    # CPU XLA canonicalizes the freq-major einsum to a differently-
    # accumulated dot than the frame-major matmul (see test_freq_major.py
    # header) — near-zero bins carry
    # ~1e-10-absolute noise that exceeds a bare 2e-5 rtol
    np.testing.assert_allclose(
        fm, ref, rtol=5e-5, atol=1e-7 * float(ref.max()) + 1e-30,
        err_msg=str((nperseg, hop, nfft, window, detrend, mode,
                     use_matmul, flip)))
