"""Freq-major PSD spine (core.stft.power_spectrogram_fm).

The display pipeline consumes (B, F, T); power_spectrogram_fm folds that
transpose into the dense DFT contraction (no device relayout — chip:
0.0906 -> 0.0803 ms/clip on the headline pipeline). These tests pin: exact
equality with the transposed frame-major result on every route (dense,
device-matrix dense, CT, FFT, magnitude, linear detrend, zero-padded),
and that the batched pipeline's outputs are unchanged by the rewire.

Equality note: on the previous accelerator the freq-major einsum produced
BIT-identical packed images; on the CPU backend XLA canonicalizes the einsum
to a differently-accumulated dot, so these tests assert tight float
parity rather than bitwise equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spectral_tpu.config import SpecConfig
from spectral_tpu.core import stft as st


@pytest.fixture
def x():
    rng = np.random.RandomState(17)
    return rng.randn(2, 16384).astype(np.float32)


CASES = [
    ("dense", SpecConfig.north_star(256, 64), True),
    ("dense_scipy", SpecConfig.scipy_default(512), True),
    ("dense_zero_padded", SpecConfig(nperseg=256, nfft=512, hop=64,
                                     window="hann"), True),
    ("dense_linear_detrend", SpecConfig(nperseg=256, hop=64, window="hann",
                                        detrend="linear"), True),
    ("dense_magnitude", SpecConfig(nperseg=256, hop=64, window="hann",
                                   mode="magnitude"), True),
    ("ct", SpecConfig.scipy_default(2048), True),
    ("fft", SpecConfig.north_star(256, 64), False),
]


@pytest.mark.parametrize("name,cfg,um", CASES, ids=[c[0] for c in CASES])
def test_fm_equals_transposed_frame_major(x, name, cfg, um):
    fm = np.asarray(st.power_spectrogram_fm(x, 1000.0, cfg, use_matmul=um))
    tf = np.asarray(st.power_spectrogram(x, 1000.0, cfg, use_matmul=um))
    ref = tf.swapaxes(-1, -2)
    assert fm.shape == ref.shape
    np.testing.assert_allclose(fm, ref, rtol=2e-5, atol=1e-9 * ref.max())


def test_fm_device_matrix_route(x):
    """Above DEVICE_DFT_BYTES (device-generated matrices) the freq-major
    einsum must still match the frame-major result exactly."""
    cfg = SpecConfig(nperseg=1024, nfft=2496, hop=256, window="hann",
                     detrend="none")
    assert st.use_device_dft(cfg) and st.ct_factors(cfg) is None
    fm = np.asarray(st.power_spectrogram_fm(x[0], 1000.0, cfg,
                                            use_matmul=True))
    tf = np.asarray(st.power_spectrogram(x[0], 1000.0, cfg,
                                         use_matmul=True))
    ref = tf.swapaxes(-1, -2)
    # the device-built matrices go through f32 trig, so near-zero bins
    # carry slightly more noise than the host-constant routes
    np.testing.assert_allclose(fm, ref, rtol=2e-5, atol=1e-8 * ref.max())


@pytest.mark.parametrize("name,cfg,um", CASES, ids=[c[0] for c in CASES])
def test_fm_flip_freqs_reverses_rows(x, name, cfg, um):
    """flip_freqs=True must equal the row-reversed unflipped result on
    every route — the dense fold (matrix columns reversed) and the CT/FFT
    fallback (jnp.flip) must agree with plain indexing."""
    fm = np.asarray(st.power_spectrogram_fm(x, 1000.0, cfg, use_matmul=um))
    fl = np.asarray(st.power_spectrogram_fm(x, 1000.0, cfg, use_matmul=um,
                                            flip_freqs=True))
    np.testing.assert_allclose(fl, fm[:, ::-1, :], rtol=2e-5,
                               atol=1e-9 * fm.max())


def test_fm_rejects_complex_mode(x):
    cfg = SpecConfig(nperseg=256, hop=64, mode="complex")
    with pytest.raises(ValueError):
        st.power_spectrogram_fm(x, 1000.0, cfg)


def test_pipeline_outputs_unchanged_by_fm_spine(x):
    """batched_spectrogram_fn's psd/image/rgb_packed must equal the
    reference composition (frame-major power_spectrogram + transpose +
    normalize + colormap)."""
    from spectral_tpu.core.scale import normalize
    from spectral_tpu.ops.colormap import apply_colormap_packed
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    import jax

    fs = 1000.0
    cfg = SpecConfig.north_star(256, 64, log_scale=True)
    out = jax.jit(batched_spectrogram_fn(fs, cfg, use_matmul=True,
                                         colormap="jet"))(x)
    psd_ref = np.asarray(st.power_spectrogram(x, fs, cfg, use_matmul=True))
    np.testing.assert_allclose(np.asarray(out["psd"]), psd_ref, rtol=2e-5,
                               atol=1e-9 * psd_ref.max())
    img_ref = np.asarray(jax.vmap(
        lambda s: normalize(s, True, None))(
            jnp.swapaxes(jnp.asarray(psd_ref), -1, -2)))
    np.testing.assert_allclose(np.asarray(out["image"]), img_ref, atol=1e-5)
    packed_ref = np.asarray(apply_colormap_packed(jnp.asarray(img_ref),
                                                  "jet", flip_rows=True))
    # packed uint32 words quantize the image to 256 levels: identical to
    # the reference composition except where a pixel sits within float
    # noise of a bin edge
    pr = np.asarray(out["rgb_packed"])
    assert pr.shape == packed_ref.shape
    assert (pr == packed_ref).mean() > 0.999


def test_batched_fn_flip_image_fold(x):
    """flip_image=True folds the PNG row flip into the DFT matrix columns:
    the image must be the row-flip of the unflipped image and rgb_packed
    must match the flip_rows=True composition; psd stays unflipped."""
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    import jax

    fs = 1000.0
    cfg = SpecConfig.north_star(256, 64, log_scale=True)
    out_f = jax.jit(batched_spectrogram_fn(fs, cfg, use_matmul=True,
                                           colormap="jet",
                                           flip_image=True))(x)
    out_0 = jax.jit(batched_spectrogram_fn(fs, cfg, use_matmul=True,
                                           colormap="jet"))(x)
    np.testing.assert_allclose(np.asarray(out_f["image"]),
                               np.asarray(out_0["image"])[:, ::-1, :],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_f["psd"]),
                               np.asarray(out_0["psd"]), rtol=2e-5,
                               atol=1e-9 * float(np.asarray(out_0["psd"]).max()))
    pf, p0 = np.asarray(out_f["rgb_packed"]), np.asarray(out_0["rgb_packed"])
    assert pf.shape == p0.shape
    # identical up to LUT-bin-edge pixels within float noise of an edge
    assert (pf == p0).mean() > 0.999


def test_batched_fn_flip_image_mel(x):
    """With mel rows the flip applies to the mel axis (no DFT fold); the
    image is exactly the row-flip of the unflipped mel image."""
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    import jax

    fs = 1000.0
    cfg = SpecConfig.north_star(256, 64, log_scale=True, n_mels=24)
    out_f = jax.jit(batched_spectrogram_fn(fs, cfg, use_matmul=True,
                                           colormap=None,
                                           flip_image=True))(x)
    out_0 = jax.jit(batched_spectrogram_fn(fs, cfg, use_matmul=True,
                                           colormap=None))(x)
    np.testing.assert_array_equal(np.asarray(out_f["image"]),
                                  np.asarray(out_0["image"])[:, ::-1, :])
    np.testing.assert_array_equal(np.asarray(out_f["mel"]),
                                  np.asarray(out_0["mel"]))


def test_export_png_row_orientation(tmp_path):
    """The exported PNG's row 0 must be the HIGHEST frequency (the
    reference renders origin='lower' then saves display-flipped). A pure
    low-frequency tone must land its energy in the BOTTOM rows. Guards the
    flip_image fold: palette and rgba paths share the flip, so their
    mutual-consistency test cannot catch a lost flip."""
    from spectral_tpu.parallel.pipeline import export_spectrograms
    from spectral_tpu.render.png import decode_png

    fs = 8000.0
    n = 8000
    t = np.arange(n) / fs
    tone = np.sin(2 * np.pi * 100.0 * t).astype(np.float32)  # bin ~3 of 129
    cfg = SpecConfig.north_star(256, 64, log_scale=True)
    export_spectrograms(iter([("tone", tone)]), fs, cfg, str(tmp_path),
                        clip_samples=n, batch=1)
    img = decode_png(str(tmp_path / "tone.png")).astype(np.int64)
    # jet: energetic pixels are red-ish (high R), background deep blue
    redness = (img[..., 0] - img[..., 2]).mean(axis=1)
    h = redness.shape[0]
    assert redness[-8:].mean() > redness[:8].mean() + 50, (
        "low-frequency energy must appear in the bottom PNG rows")
    assert int(np.argmax(redness)) > h - 10


def test_pipeline_mel_output_unchanged_by_fm_spine(x):
    """The mel projection moved to a freq-major contraction — same values
    within float tolerance of the frame-major psd @ fb.T form."""
    from spectral_tpu.core.mel import mel_filterbank
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    import jax

    fs = 1000.0
    cfg = SpecConfig.north_star(256, 64, log_scale=True, n_mels=32)
    out = jax.jit(batched_spectrogram_fn(fs, cfg, use_matmul=True,
                                         colormap=None))(x)
    psd = np.asarray(st.power_spectrogram(x, fs, cfg, use_matmul=True))
    fb = mel_filterbank(32, psd.shape[-1], fs, cfg.mel_fmin, cfg.mel_fmax,
                        cfg.mel_htk)
    mel_ref = psd.astype(np.float64) @ fb.T
    mel = np.asarray(out["mel"])
    assert mel.shape == mel_ref.shape
    np.testing.assert_allclose(mel, mel_ref, rtol=1e-5,
                               atol=1e-7 * mel_ref.max())


@pytest.mark.parametrize("um", [True, False])
@pytest.mark.parametrize("flip", [False, True])
def test_fm_band_fold_matches_full(x, um, flip):
    """band=(lo,hi) must equal slicing the full freq-major result AT THE
    SAME flip sense — on the dense route the band folds into the DFT
    matrix columns and each retained element is the same dot product;
    CT/FFT routes slice. CPU XLA retiles the gemm for the narrower
    matrix, reassociating the contraction (~1e-8 noise, same class as
    the module-header note), so the assertion is a tight allclose here."""
    for cfg in (SpecConfig.scipy_default(256),
                SpecConfig.north_star(512, 128),
                SpecConfig.scipy_default(2048)):   # CT route when um
        full = np.asarray(st.power_spectrogram_fm(
            x, 1000.0, cfg, use_matmul=um, flip_freqs=flip))
        F = full.shape[-2]
        lo, hi = 3, 2 * F // 3
        got = np.asarray(st.power_spectrogram_fm(
            x, 1000.0, cfg, use_matmul=um, flip_freqs=flip, band=(lo, hi)))
        # band rows of the flipped axis sit at [F-hi, F-lo)
        ref = full[..., F - hi:F - lo, :] if flip else full[..., lo:hi, :]
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=1e-7 * float(ref.max()))


def test_fm_band_requires_onesided(x):
    cfg = SpecConfig(nperseg=256, hop=64, onesided=False, detrend="none",
                     window="hann")
    with pytest.raises(ValueError, match="one-sided"):
        st.power_spectrogram_fm(x, 1000.0, cfg, band=(1, 5))
