"""Both XLA STFT engines against the scipy float64 oracle over the framing
shape sets that stress them: dividing and non-dividing hops (gcd framing),
hop > nperseg, partial trailing frames, huge nperseg (CT route), DC offsets
under constant detrend, integer PCM input and zero-frame signals.

use_matmul=True runs the dense window-folded DFT (and the two-stage
Cooley-Tukey route at nfft >= 2048); use_matmul=False runs rFFT — the
engine use_matmul=None resolves to on the GPU. Also: a jaxpr guard that
every dot on the STFT-contract paths names its precision (an unnamed f32
dot may run in TF32 on the GPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal

from spectral_tpu.config import SpecConfig
from spectral_tpu.core import stft as st

ENGINES = pytest.mark.parametrize("um", [True, False],
                                  ids=["dense_or_ct", "rfft"])
REL = 4e-5       # max |ours - scipy| / max(scipy), as in test_stft_fuzz


def _oracle(x, fs, cfg):
    """scipy.signal.spectrogram in float64 for a SpecConfig, frame-major."""
    win = scipy.signal.get_window(cfg.window, cfg.nperseg, fftbins=True)
    _f, _t, sxx = scipy.signal.spectrogram(
        np.asarray(x, np.float64), fs=fs, window=win, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_, nfft=cfg.nfft_,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        scaling="density", mode="psd")
    return np.swapaxes(sxx, -1, -2)


def _assert_matches_scipy(x, fs, cfg, um):
    out = np.asarray(st.power_spectrogram(jnp.asarray(x), fs, cfg,
                                          use_matmul=um))
    ref = _oracle(x, fs, cfg)
    n = np.asarray(x).shape[-1]
    assert out.shape == ref.shape == np.asarray(x).shape[:-1] + (
        st.num_frames(n, cfg.nperseg, cfg.hop_), cfg.n_freqs)
    err = np.max(np.abs(out - ref)) / ref.max()
    assert err < REL, (cfg.nperseg, cfg.hop_, n, um, err)


@ENGINES
@pytest.mark.parametrize("nperseg,hop,n", [
    (1024, 256, 160000),   # north-star config 1
    (1024, 256, 5000),     # short signal, partial trailing frame
    (512, 128, 16000),
    (256, 64, 4096),
    (1024, 1024, 20000),   # non-overlapping frames
    (256, 128, 10000),     # 50% overlap
])
def test_north_star_shapes_vs_scipy(nperseg, hop, n, um):
    x = np.random.RandomState(0).randn(n).astype(np.float32)
    _assert_matches_scipy(x, 16000.0, SpecConfig.north_star(nperseg, hop), um)


@ENGINES
@pytest.mark.parametrize("nperseg,n", [
    (1024, 160000),   # the reference's exact default path (hop 896, g 128)
    (512, 30000),     # hop 448, g 64
    (256, 10000),     # hop 224, g 32
    (2048, 120000),   # hop 1792: the CT route on the matmul engine
    (8192, 200000),   # hop 7168: the GUI ceiling, compensated CT route
])
def test_scipy_default_hop_with_dc_offset_vs_scipy(nperseg, n, um):
    """The reference's own config (PlotEngine.py:113: Tukey 0.25, hop =
    nperseg - nperseg//8, constant detrend): the non-dividing hop runs the
    gcd framing; the DC offset makes the detrend matter."""
    cfg = SpecConfig.scipy_default(nperseg)
    assert cfg.nperseg % cfg.hop_ != 0
    x = np.random.RandomState(7).randn(n).astype(np.float32) + 2.5
    _assert_matches_scipy(x, 16000.0, cfg, um)


@ENGINES
@pytest.mark.parametrize("nperseg,hop,n", [
    (2048, 512, 60000),
    (4096, 1024, 60000),
    (8192, 2048, 120000),
])
def test_large_transforms_vs_scipy(nperseg, hop, n, um):
    x = np.random.RandomState(5).randn(n).astype(np.float32)
    _assert_matches_scipy(x, 16000.0, SpecConfig.north_star(nperseg, hop), um)


@ENGINES
@pytest.mark.parametrize("trial", range(8))
def test_fuzz_gcd_framing_vs_scipy(trial, um):
    """Random (nperseg, hop) pairs — dividing, non-dividing (gcd framing)
    and hop > nperseg — plus a trailing remainder that fills no frame."""
    r = np.random.RandomState(trial * 31 + 9)
    g = int(2 ** r.randint(3, 8))              # gcd 8..128
    nperseg = max(32, g * int(r.randint(2, 17)))
    hop = g * int(r.randint(1, 24))
    n = int(nperseg * r.uniform(3.0, 9.0)) + int(r.randint(0, hop))
    x = np.random.RandomState(trial + 200).randn(n).astype(np.float32)
    assert math.gcd(nperseg, hop) >= 8
    _assert_matches_scipy(x, 16000.0, SpecConfig.north_star(nperseg, hop), um)


@ENGINES
def test_hop_larger_than_nperseg_vs_scipy(um):
    x = np.random.RandomState(13).randn(20000).astype(np.float32)
    _assert_matches_scipy(x, 16000.0, SpecConfig.north_star(256, 384), um)


@ENGINES
def test_batched_scipy_detrend_vs_scipy(um):
    """A batch of clips with a DC offset under scipy's constant detrend."""
    xb = np.random.RandomState(1).randn(3, 8192).astype(np.float32) + 5.0
    _assert_matches_scipy(xb, 1000.0, SpecConfig(nperseg=512, hop=256), um)


@ENGINES
def test_integer_input_promotes(um):
    """Integer PCM promotes to float32 before the windowed DFT: int16 and
    its float32 copy give identical PSDs, and both match scipy."""
    fs = 1000.0
    xf = (np.sin(2 * np.pi * 40 * np.arange(4096) / fs) * 1000
          + np.random.RandomState(3).randn(4096) * 50).astype(np.float32)
    xi = xf.astype(np.int16)
    cfg = SpecConfig(nperseg=256, hop=128)
    pi = np.asarray(st.power_spectrogram(jnp.asarray(xi), fs, cfg,
                                         use_matmul=um))
    pf = np.asarray(st.power_spectrogram(
        jnp.asarray(xi.astype(np.float32)), fs, cfg, use_matmul=um))
    assert pi.dtype == np.float32
    np.testing.assert_array_equal(pi, pf)
    _assert_matches_scipy(xi.astype(np.float32), fs, cfg, um)


@ENGINES
def test_zero_frames_shape(um):
    """A signal shorter than one frame under an explicit hop keeps the
    static shape and yields zero frames, batched or not."""
    cfg = SpecConfig.north_star(1024, 256)
    out = st.power_spectrogram(jnp.zeros(100), 16000.0, cfg, use_matmul=um)
    assert out.shape == (0, 513)
    outb = st.power_spectrogram(jnp.zeros((3, 100)), 16000.0, cfg,
                                use_matmul=um)
    assert outb.shape == (3, 0, 513)


# ---- every contract dot names its precision --------------------------------

def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                if hasattr(sub, "jaxpr"):
                    out.extend(_dot_precisions(sub.jaxpr))
                elif hasattr(sub, "eqns"):
                    out.extend(_dot_precisions(sub))
    return out


def _contract_paths():
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    from spectral_tpu.parallel.sweep_grid import default_grid, sweep_grid
    fs = 16000.0
    head = SpecConfig.north_star(1024, 256, log_scale=True)
    return {
        "dense_headline": lambda x: st.power_spectrogram(
            x, fs, head, use_matmul=True),
        "dense_scipy_1024_fm_band": lambda x: st.power_spectrogram_fm(
            x, fs, SpecConfig.scipy_default(1024), use_matmul=True,
            flip_freqs=True, band=(0, 64)),
        "ct_compensated_8192": lambda x: st.power_spectrogram(
            x, fs, SpecConfig.scipy_default(8192), use_matmul=True),
        "ct_plain_linear_detrend_2048": lambda x: st.power_spectrogram(
            x, fs, SpecConfig(nperseg=2048, hop=512, detrend="linear"),
            use_matmul=True),
        "device_dft_linear_1024": lambda x: st.power_spectrogram(
            x, fs, SpecConfig(nperseg=4096, hop=1024, nfft=4096,
                              detrend="linear", window="hann"),
            use_matmul=True),
        "batched_mel_pipeline": lambda x: batched_spectrogram_fn(
            fs, SpecConfig.north_star(1024, 256, log_scale=True, n_mels=128),
            use_matmul=True)(x[None]),
        "sweep_grid": lambda x: sweep_grid(x, fs, default_grid()),
        "fast_tier": lambda x: st.power_spectrogram(
            x, fs, SpecConfig.north_star(1024, 256, precision="fast"),
            use_matmul=True),
    }


@pytest.mark.parametrize("path", sorted(_contract_paths()))
def test_every_contract_dot_names_its_precision(path):
    """An unnamed f32 dot runs at the backend's default precision — TF32 on
    the GPU, bf16 on other accelerators — which breaks the 1e-3 dB
    contract. Every dot_general on these paths must carry an explicit
    precision (HIGHEST, the 'fast' tier's algorithm preset, or the
    compensated route's deliberate DEFAULT residual passes)."""
    x = jax.ShapeDtypeStruct((32768,), jnp.float32)
    closed = jax.make_jaxpr(_contract_paths()[path])(x)
    precs = _dot_precisions(closed.jaxpr)
    assert precs, f"{path}: no dot_general traced"
    assert all(p is not None for p in precs), (path, precs)
