"""Cooley-Tukey two-stage matmul DFT (core/stft.py::_ct_dft).

Above CT_MIN_NFFT the matmul engine factorizes the transform as two
GEMM stages (N = 128 * N2) instead of one dense window-folded
matrix. These tests pin the dispatch gating and prove the factorized
path bit-parity-class equal to both the dense path it replaces and the
scipy f64 oracle (reference contract: PlotEngine.py:113).
"""

import dataclasses

import numpy as np
import pytest
import scipy.signal

import jax.numpy as jnp

from spectral_tpu.config import SpecConfig
from spectral_tpu.core import stft as stft_mod


def test_ct_factors_gating():
    # below the threshold: dense path (at 1024 the factorized path's
    # display error, 5.9e-3 dB on chip, exceeds the matmul-tier budget)
    assert stft_mod.ct_factors(SpecConfig.scipy_default(1024)) is None
    # at/above: (128, N//128)
    assert stft_mod.ct_factors(SpecConfig.scipy_default(2048)) == (128, 16)
    assert stft_mod.ct_factors(SpecConfig.scipy_default(4096)) == (128, 32)
    assert stft_mod.ct_factors(SpecConfig.scipy_default(8192)) == (128, 64)
    # nfft > nperseg (zero-padded transform): CT pads the windowed frames
    cfg = dataclasses.replace(SpecConfig.scipy_default(4096), nfft=8192)
    assert stft_mod.ct_factors(cfg) == (128, 64)
    # nfft not a multiple of 128 cannot tile stage 1
    odd = dataclasses.replace(SpecConfig.scipy_default(4096),
                              nperseg=4100, nfft=4100)
    assert stft_mod.ct_factors(odd) is None


@pytest.mark.parametrize("nperseg", [2048, 4096, 8192])
def test_ct_matches_dense(nperseg, monkeypatch):
    """The factorized DFT must reproduce the dense window-folded matmul
    to f32 roundoff — same inputs, same precision flag, only the
    factorization differs."""
    fs = 16000.0
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(nperseg * 4), jnp.float32)
    cfg = SpecConfig.scipy_default(nperseg=nperseg)
    assert stft_mod.ct_factors(cfg) is not None

    ct_re, ct_im = stft_mod._matmul_dft(x, cfg)
    monkeypatch.setattr(stft_mod, "ct_factors", lambda c: None)
    de_re, de_im = stft_mod._matmul_dft(x, cfg)

    scale = float(jnp.max(jnp.abs(de_re)))
    np.testing.assert_allclose(np.asarray(ct_re), np.asarray(de_re),
                               atol=2e-5 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(ct_im), np.asarray(de_im),
                               atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("sig", ["noise", "offset"])
def test_ct_scipy_parity_4096(sig):
    """End-to-end PSD through the CT path vs the scipy f64 oracle, at the
    same relative budget the dense golden tests enforce."""
    fs = 1000.0
    n = 4096 * 6
    rng = np.random.RandomState(0)
    x = rng.randn(n) + (7.5 if sig == "offset" else 0.0)
    cfg = SpecConfig.scipy_default(nperseg=4096)

    _, _, ref = scipy.signal.spectrogram(
        x, fs=fs, nperseg=4096, scaling="density", mode="psd")
    _, _, ours = stft_mod.spectrogram(jnp.asarray(x, jnp.float32), fs, cfg,
                                      use_matmul=True)
    ours = np.asarray(ours)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) / ref.max() < 2e-5


def test_ct_batched_leading_dims():
    """The factorized path must keep the engine's (..., n) batch contract
    (parallel/sharding.py vmaps over leading axes)."""
    fs = 1000.0
    rng = np.random.RandomState(1)
    xb = jnp.asarray(rng.randn(3, 4096 * 3), jnp.float32)
    cfg = SpecConfig.scipy_default(nperseg=4096)
    _, _, batched = stft_mod.spectrogram(xb, fs, cfg, use_matmul=True)
    _, _, single = stft_mod.spectrogram(xb[1], fs, cfg, use_matmul=True)
    np.testing.assert_array_equal(np.asarray(batched[1]), np.asarray(single))


@pytest.mark.parametrize("mode", ["complex", "magnitude"])
def test_ct_nonpsd_modes_engine_parity(mode):
    """stft()/power_spectrogram route complex and magnitude modes through
    the same matmul engine; at CT sizes those must match the rFFT engine
    (previously only tested at nperseg=256, below the CT threshold)."""
    fs = 16000.0
    x = jnp.asarray(np.random.RandomState(9).randn(8192).astype(np.float32))
    cfg = dataclasses.replace(SpecConfig.scipy_default(2048), mode=mode)
    assert stft_mod.ct_factors(cfg) is not None
    if mode == "complex":
        a = np.asarray(stft_mod.stft(x, cfg, use_matmul=True))
        b = np.asarray(stft_mod.stft(x, cfg, use_matmul=False))
    else:
        a = np.asarray(stft_mod.power_spectrogram(x, fs, cfg,
                                                  use_matmul=True))
        b = np.asarray(stft_mod.power_spectrogram(x, fs, cfg,
                                                  use_matmul=False))
    scale = np.max(np.abs(b))
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("nperseg,nfft", [
    (1000, 1024),   # dense path, zero-padded
    (1024, 2048),   # CT path, zero-padded, nperseg below the CT floor
    (3000, 4096),   # CT path, non-128-multiple window length
])
def test_matmul_zero_padded_nfft_scipy_parity(nperseg, nfft):
    """scipy's nfft zero-padding through the matmul engine: the dense
    matrices are the first nperseg rows of the nfft transform and the CT
    form pads the windowed frames — both must match the scipy oracle
    (previously the engine refused nfft != nperseg outright, which
    crashed pipelines that default use_matmul=True)."""
    fs = 1000.0
    x = np.random.RandomState(4).randn(nfft * 5)
    cfg = SpecConfig(nperseg=nperseg, nfft=nfft, hop=None)

    _, _, ref = scipy.signal.spectrogram(
        x, fs=fs, nperseg=nperseg, nfft=nfft,
        scaling="density", mode="psd")
    _, _, ours = stft_mod.spectrogram(jnp.asarray(x, jnp.float32), fs, cfg,
                                      use_matmul=True)
    ours = np.asarray(ours)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) / ref.max() < 2e-5


def test_ct_factors_cost_gating_small_nperseg():
    """A zero-padded transform with a SMALL nperseg must stay on the dense
    path: the dense window-folded matrices are (nperseg, n_freqs), so at
    e.g. nperseg=256/nfft=2048 they cost fewer MACs than the factorized
    stages (and 9x fewer at nperseg=32)."""
    for nperseg in (32, 64, 128, 256):
        cfg = dataclasses.replace(SpecConfig.scipy_default(nperseg),
                                  nfft=2048)
        assert stft_mod.ct_factors(cfg) is None, nperseg
    # from 512 up the factorization's FLOP cut wins again
    cfg = dataclasses.replace(SpecConfig.scipy_default(512), nfft=2048)
    assert stft_mod.ct_factors(cfg) == (128, 16)


# ---------------------------------------------------------------------------
# Compensated f32 prep + twiddle (error-free transformations)
# ---------------------------------------------------------------------------

def test_two_sum_two_prod_are_exact():
    """Knuth two-sum / Dekker two-product: the residual is EXACT — the f64
    promotion of (s, e) reproduces the f64 operation on the f32 inputs
    bit-for-bit (f32 products and sums are exactly representable in f64)."""
    rng = np.random.RandomState(0)
    a = jnp.asarray(rng.randn(4096).astype(np.float32) * 10.0 **
                    rng.randint(-6, 6, 4096))
    b = jnp.asarray(rng.randn(4096).astype(np.float32) * 10.0 **
                    rng.randint(-6, 6, 4096))
    s, e = stft_mod._two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact)
    p, e = stft_mod._two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact)


@pytest.mark.parametrize("nperseg", [96, 1024, 8192])  # incl. non-pow2
def test_mean_2sum_matches_f64(nperseg):
    rng = np.random.RandomState(1)
    fr = jnp.asarray(rng.randn(7, nperseg).astype(np.float32) + 3.25)
    m_hi, m_lo = stft_mod._mean_2sum(fr, nperseg)
    m = np.asarray(m_hi, np.float64) + np.asarray(m_lo, np.float64)
    ref = np.mean(np.asarray(fr, np.float64), axis=-1, keepdims=True)
    np.testing.assert_allclose(m, ref, rtol=1e-13, atol=0)


def test_compensated_ct_routing_gates():
    """The compensated route: f32 + 'accurate' + constant/none detrend on
    a CT-size config; f64 inputs, the fast tier, and linear detrend keep
    the plain path."""
    import jax
    cfg = SpecConfig.scipy_default(8192)
    x32 = jnp.zeros(9000, jnp.float32)
    assert stft_mod._use_compensated_ct(x32, cfg)
    jax.config.update("jax_enable_x64", True)  # f64 exists only under x64
    try:
        assert not stft_mod._use_compensated_ct(
            np.zeros(9000, np.float64), cfg)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert not stft_mod._use_compensated_ct(
        x32, dataclasses.replace(cfg, precision="fast"))
    assert not stft_mod._use_compensated_ct(
        x32, dataclasses.replace(cfg, detrend="linear"))
    # int PCM promotes to f32 downstream -> compensated applies
    assert stft_mod._use_compensated_ct(
        jnp.zeros(9000, jnp.int16), cfg)


def test_compensated_ct_beats_plain_at_8192():
    """The display-dB error at the contract's worst point (scipy-compat
    nperseg=8192, PlotEngine.py:113 at the GUI legal max GUI.py:87-90)
    must improve on the plain CT path and stay well inside the 1e-3
    contract even on this CPU rig (chip HIGHEST arithmetic is tighter:
    9.3e-5 measured — bench.py records the driver artifact)."""
    fs = 16000.0
    x = np.random.RandomState(0).randn(160000).astype(np.float32)
    cfg = SpecConfig.scipy_default(8192, log_scale=True)
    _, _, ref = scipy.signal.spectrogram(
        x.astype(np.float64), fs=fs, nperseg=8192,
        scaling="density", mode="psd")

    def db_img(s):
        s = np.asarray(s, np.float64)
        norm = np.clip(s / (s.max() + 1e-20), 0, 1)
        db = np.nan_to_num(10 * np.log10(norm + 1e-12))
        return (db - db.min()) / (db.max() - db.min()), db.max() - db.min()

    ref_img, rng_db = db_img(ref)

    p_comp = np.asarray(stft_mod.power_spectrogram(
        jnp.asarray(x), fs, cfg, use_matmul=True)).T
    xr, xi = stft_mod._matmul_dft(jnp.asarray(x), cfg)
    p_plain = np.asarray(stft_mod._scale_psd(xr * xr + xi * xi, cfg, fs)).T

    err_comp = np.max(np.abs(db_img(p_comp)[0] - ref_img)) * rng_db
    err_plain = np.max(np.abs(db_img(p_plain)[0] - ref_img)) * rng_db
    assert err_comp < err_plain, (err_comp, err_plain)
    assert err_comp <= 5e-4, err_comp


def test_compensated_ct_values_stay_scipy_close():
    """Compensation must not MOVE the PSD away from scipy anywhere: the
    relative error budget of the plain goldens still holds."""
    fs = 1000.0
    x = np.random.RandomState(2).randn(8192 * 6)
    for nperseg in (2048, 4096):
        cfg = SpecConfig.scipy_default(nperseg)
        _, _, ref = scipy.signal.spectrogram(
            x, fs=fs, nperseg=nperseg, scaling="density", mode="psd")
        _, _, ours = stft_mod.spectrogram(jnp.asarray(x, jnp.float32), fs,
                                          cfg, use_matmul=True)
        assert np.max(np.abs(np.asarray(ours) - ref)) / ref.max() < 2e-5


def _dot_precisions(jaxpr):
    """Collect the precision of every dot_general in a (nested) jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):           # ClosedJaxpr
                out.extend(_dot_precisions(v.jaxpr))
            elif hasattr(v, "eqns"):          # bare Jaxpr
                out.extend(_dot_precisions(v))
    return out


def test_compensated_route_precision_mix_is_pinned():
    """CLAUDE.md's rule — every contract-path dot carries explicit
    HIGHEST — has ONE deliberate, measured exemption: the compensated CT
    route's residual transforms (core/stft.py ct_dft_frames residual
    einsums + the _ct_power_compensated residual pass). Those operands
    are O(eps * |frame|), so single-pass bf16 contributes O(1e-2 * eps)
    — two orders below the term being recovered (verified on chip:
    display error identical to 6-pass). This guard pins the exact mix so
    a refactor can neither silently downgrade a MAIN transform dot nor
    feed a non-eps-scale operand through a new DEFAULT dot unnoticed:

      HIGHEST: stage-1 (2) + stage-2 (4) of the main transform = 6
      DEFAULT: 4 residual einsums inside compensate=True, plus the
               residual signal's own 6-dot plain CT transform = 10
    """
    import jax

    x = jnp.zeros(8192 * 3, jnp.float32)
    cfg = SpecConfig.scipy_default(8192)
    assert stft_mod._use_compensated_ct(x, cfg)
    closed = jax.make_jaxpr(
        lambda s: stft_mod.power_spectrogram(s, 1000.0, cfg,
                                             use_matmul=True))(x)
    precs = _dot_precisions(closed.jaxpr)
    hp = jax.lax.Precision.HIGHEST
    dp = jax.lax.Precision.DEFAULT
    n_hi = sum(1 for p in precs if p == (hp, hp))
    n_lo = sum(1 for p in precs if p in (None, (dp, dp)))
    assert (n_hi, n_lo, len(precs)) == (6, 10, 16), precs
