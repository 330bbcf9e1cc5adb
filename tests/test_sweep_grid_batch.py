"""Sweep-grid vmap and batched detection tests."""

import numpy as np
import pytest
import jax.numpy as jnp

from spectral_tpu.config import SpecConfig
from spectral_tpu.core.stft import power_spectrogram, num_frames, time_axis, freq_axis
from spectral_tpu.core import events as ev
from spectral_tpu.parallel.sweep_grid import sweep_grid, default_grid
from spectral_tpu.models.batch import batch_unsupervised_detect, batch_viterbi_detect
from spectral_tpu.models import hmm


def test_default_grid_is_16_combos():
    grid = default_grid()
    assert len(grid) == 16
    assert len({(c.nperseg, c.hop_, c.window) for c in grid}) == 16


def test_sweep_grid_matches_individual_configs():
    fs = 8000.0
    x = jnp.asarray(np.random.RandomState(0).randn(16384).astype(np.float32))
    configs = [
        SpecConfig(nperseg=256, hop=64, window="hann", detrend="none"),
        SpecConfig(nperseg=256, hop=64, window="hamming", detrend="none"),
        SpecConfig(nperseg=256, hop=64, window=("tukey", 0.25), detrend="constant"),
        SpecConfig(nperseg=512, hop=128, window="hann", detrend="none"),
    ]
    outs = sweep_grid(x, fs, configs)
    assert len(outs) == 4
    for cfg, out in zip(configs, outs):
        ref = np.asarray(power_spectrogram(x, fs, cfg, use_matmul=True))
        assert out.shape == ref.shape
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                                   atol=ref.max() * 1e-7)


def test_sweep_grid_full_north_star():
    fs = 16000.0
    x = jnp.asarray(np.random.RandomState(1).randn(32768).astype(np.float32))
    grid = default_grid()
    outs = sweep_grid(x, fs, grid)
    for cfg, out in zip(grid, outs):
        T = num_frames(32768, cfg.nperseg, cfg.hop_)
        assert out.shape == (T, cfg.n_freqs)
        assert np.isfinite(np.asarray(out)).all()


def test_sweep_grid_shards_over_clip_batch():
    """Config-3 at scale is embarrassingly CLIP-parallel: the batched grid
    jitted with the batch dim sharded over an 8-device mesh must (a) equal
    the unsharded result and (b) lower with NO cross-clip collectives —
    each device sweeps its own clips."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    fs = 8000.0
    grid = default_grid(n_ffts=(256, 1024), hop_divisor=4)
    B, n = 8, 16384
    xb = np.random.RandomState(5).randn(B, n).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    sh = NamedSharding(mesh, P("data"))

    def grid_stack(xs):
        outs = sweep_grid(xs, fs, grid)
        return jnp.stack([jnp.sum(o, axis=(-2, -1)) for o in outs])

    ref = np.asarray(jax.jit(grid_stack)(jnp.asarray(xb)))
    f_sh = jax.jit(grid_stack, in_shardings=sh)
    got = np.asarray(f_sh(jax.device_put(jnp.asarray(xb), sh)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    hlo = f_sh.lower(jax.device_put(jnp.asarray(xb), sh)).compile()
    txt = hlo.as_text()
    for coll in ("all-reduce", "all-gather", "all-to-all",
                 "collective-permute", "reduce-scatter"):
        assert coll not in txt, f"unexpected {coll} in clip-dp sweep grid"


# ---- batched detection -----------------------------------------------------

def _batch_features(B=3, fs=1000.0, dur=60.0):
    cfg = SpecConfig.scipy_default(1024)
    rng = np.random.RandomState(7)
    feats, truths = [], []
    n = int(fs * dur)
    tt = np.arange(n) / fs
    for b in range(B):
        bursts = ((10 + b, 16 + b), (35 - b, 42 - b))
        x = 0.02 * rng.randn(n)
        for a, c in bursts:
            m = (tt >= a) & (tt < c)
            x[m] += 0.6 * np.hanning(m.sum()) * np.sin(2 * np.pi * 6.0 * tt[m])
        psd = power_spectrogram(jnp.asarray(x, jnp.float32), fs, cfg)
        f = freq_axis(cfg, fs)
        feats.append(np.asarray(ev.features_from_psd(f, psd, 0.0, 30.0)))
        truths.append(bursts)
    t = time_axis(cfg, fs, n)
    return t, np.stack(feats), truths


def _iou(a, b):
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    return inter / (max(a[1], b[1]) - min(a[0], b[0]))


def test_batch_unsupervised_detect():
    t, feats, truths = _batch_features()
    results = batch_unsupervised_detect(t, feats)
    assert len(results) == 3
    for evs, truth in zip(results, truths):
        assert len(evs) == 2, evs
        for found, true in zip(evs, truth):
            assert _iou(found, true) > 0.6, (found, true)


def test_batch_viterbi_detect_supervised_on_source_clip():
    t, feats, truths = _batch_features()
    # supervised model from clip 0's ground-truth labels decodes clip 0
    # exactly; its tight variance floors make it clip-specific by design
    # (reference-faithful, PlotEngine.py:337-355)
    labels = ev.build_label_track(t, truths[0])
    params = hmm.supervised_fit(feats[0], labels, 4)
    results = batch_viterbi_detect(params, t, feats, scan="label")
    assert len(results) == 3
    evs = results[0]
    assert len(evs) == 2
    for found, true in zip(sorted(evs), truths[0]):
        assert _iou(found, true) > 0.6, (found, true)


def test_batch_viterbi_detect_em_model_generalizes():
    t, feats, truths = _batch_features()
    # EM-fitted (then escape-patched) model from clip 0 decodes every clip
    params0 = hmm.init_params(feats[0], 4, seed=42)
    params, _, _ = hmm.fit(params0, np.asarray(feats[0]), n_iter=100)
    baseline = int(np.argmin(np.asarray(params.means)[:, 0]))
    import jax.numpy as jnp
    params = params._replace(transmat=jnp.asarray(
        hmm.patch_escape_routes(np.asarray(params.transmat), baseline),
        jnp.float32))
    results = batch_viterbi_detect(params, t, feats, scan="baseline")
    for evs, truth in zip(results, truths):
        big = sorted(evs, key=lambda e: e[1] - e[0], reverse=True)[:2]
        assert len(big) == 2, evs
        for found, true in zip(sorted(big), truth):
            assert _iou(found, true) > 0.5, (found, true)


def test_batch_detect_rejects_short():
    with pytest.raises(ValueError, match="Not enough data"):
        batch_unsupervised_detect(np.arange(2.0), np.zeros((2, 2, 2)))


def test_sweep_grid_center_true_matches_power_spectrogram():
    """center=True configs must reflect-pad exactly like core._prep_frames;
    regression: the grid framed the RAW signal, dropping frames and
    shifting centers vs power_spectrogram for the identical config."""
    fs = 8000.0
    x = jnp.asarray(np.random.RandomState(1).randn(8192).astype(np.float32))
    configs = [
        SpecConfig(nperseg=256, hop=64, window="hann", detrend="none",
                   center=True),
        SpecConfig(nperseg=256, hop=64, window="hamming", detrend="none",
                   center=True),
        SpecConfig(nperseg=256, hop=64, window="hann", detrend="none"),
    ]
    outs = sweep_grid(x, fs, configs)
    for cfg, out in zip(configs, outs):
        ref = np.asarray(power_spectrogram(x, fs, cfg, use_matmul=True))
        assert out.shape == ref.shape, (cfg.center, out.shape, ref.shape)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-5,
                                   atol=ref.max() * 1e-7)


def test_sweep_grid_device_dft_and_mode_guard():
    """Large-nperseg groups must use device-generated DFT matrices (not
    tens of MB of program constants) and still match power_spectrogram;
    non-PSD modes are rejected instead of silently returning PSD values."""
    from spectral_tpu.core.stft import use_device_dft
    fs = 16000.0
    x = jnp.asarray(np.random.RandomState(2).randn(16384).astype(np.float32))
    cfg = SpecConfig(nperseg=4096, hop=1024, window="hann", detrend="none")
    assert use_device_dft(cfg)  # this config exercises the device path
    out = sweep_grid(x, fs, [cfg])[0]
    ref = np.asarray(power_spectrogram(x, fs, cfg, use_matmul=True))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4,
                               atol=ref.max() * 1e-6)
    with pytest.raises(ValueError, match="psd"):
        sweep_grid(x, fs, [SpecConfig(nperseg=256, hop=64,
                                      mode="magnitude", detrend="none")])


def test_sweep_grid_precision_not_shared_across_group():
    """'accurate' and 'fast' configs with identical shapes must not land in
    one matmul group: each must compute at its own tier."""
    fs = 8000.0
    x = jnp.asarray(np.random.RandomState(3).randn(8192).astype(np.float32))
    acc = SpecConfig(nperseg=512, hop=128, window="hann", detrend="none")
    fast = SpecConfig(nperseg=512, hop=128, window="hann", detrend="none",
                      precision="fast")
    outs = sweep_grid(x, fs, [acc, fast])
    ref_acc = np.asarray(power_spectrogram(x, fs, acc, use_matmul=True))
    ref_fast = np.asarray(power_spectrogram(x, fs, fast, use_matmul=True))
    np.testing.assert_array_equal(np.asarray(outs[0]), ref_acc)
    np.testing.assert_array_equal(np.asarray(outs[1]), ref_fast)


def test_sweep_grid_ct_group_window_sweep():
    """Large-transform groups route through the factorized CT engine with
    the window as a broadcast dimension (no per-window DFT matrices); a
    multi-window 2048 group must match per-config power_spectrogram —
    which is itself scipy-golden-tested — for every detrend mode."""
    from spectral_tpu.core.stft import ct_factors
    fs = 16000.0
    x = jnp.asarray(np.random.RandomState(5).randn(16384).astype(np.float32))
    for det in ("none", "constant", "linear"):
        grid = [SpecConfig(nperseg=2048, hop=512, window=w, detrend=det)
                for w in ("hann", "hamming", ("tukey", 0.25))]
        assert ct_factors(grid[0]) == (128, 16)
        outs = sweep_grid(x, fs, grid)
        for cfg, out in zip(grid, outs):
            ref = np.asarray(power_spectrogram(x, fs, cfg, use_matmul=True))
            np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                                       atol=ref.max() * 1e-6,
                                       err_msg=f"detrend={det} w={cfg.window}")


def test_sweep_grid_ct_group_scipy_oracle():
    """One CT-group combo straight against scipy (not just our own engine):
    guards against a shared bug in both CT call sites."""
    import scipy.signal
    fs = 16000.0
    xh = np.random.RandomState(6).randn(16384)
    cfg = SpecConfig(nperseg=2048, hop=512, window="hann", detrend="constant")
    out = np.asarray(sweep_grid(jnp.asarray(xh, jnp.float32), fs, [cfg])[0])
    f_ref, t_ref, ref = scipy.signal.spectrogram(
        xh, fs=fs, nperseg=2048, noverlap=2048 - 512, window="hann",
        scaling="density", mode="psd", detrend="constant")
    np.testing.assert_allclose(out, ref.T, rtol=0, atol=ref.max() * 2e-5)


def test_sweep_grid_zero_padded_nfft():
    """nfft > nperseg sweeps (scipy zero-padding) through both engines:
    dense small groups and CT large groups must match per-config
    power_spectrogram."""
    fs = 8000.0
    x = jnp.asarray(np.random.RandomState(8).randn(16384).astype(np.float32))
    grid = [
        SpecConfig(nperseg=250, nfft=512, hop=64, window="hann",
                   detrend="none"),                       # dense, padded
        SpecConfig(nperseg=250, nfft=512, hop=64, window="hamming",
                   detrend="none"),
        SpecConfig(nperseg=2000, nfft=2048, hop=512, window="hann",
                   detrend="constant"),                   # CT, padded
    ]
    outs = sweep_grid(x, fs, grid)
    for cfg, out in zip(grid, outs):
        ref = np.asarray(power_spectrogram(x, fs, cfg, use_matmul=True))
        np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                                   atol=ref.max() * 1e-6,
                                   err_msg=str(cfg.nperseg))


def test_batch_detect_refuses_nonfinite_features():
    """Parity with the sequential detector's _check_finite_features: NaN
    features flow through KMeans/EM without error and silently decode
    zero events, so the batched entry must refuse too, naming the bad
    clips."""
    import pytest
    from spectral_tpu.models.batch import batch_unsupervised_detect
    rng = np.random.default_rng(0)
    t = np.arange(32, dtype=np.float64) * 0.1
    feats = rng.standard_normal((3, 32, 2)).astype(np.float32)
    feats[1, 5, 0] = np.nan
    with pytest.raises(ValueError, match=r"clips \[1\]"):
        batch_unsupervised_detect(t, feats)


def test_batch_detect_equals_sequential_on_cpu():
    """The vmapped fleet path and N sequential detections produce
    IDENTICAL event lists on this backend (the documented caveat — vmap
    may reassociate f32 reductions and nudge borderline boundaries — is
    about accelerator tiling, not a standing difference; if this ever
    fails here, the batched path regressed, not float noise)."""
    from spectral_tpu.models.detector import BurstDetector
    t, feats, _truths = _batch_features()
    batched = batch_unsupervised_detect(t, feats)
    seq = [BurstDetector(device="cpu").unsupervised_detect(t, f)
           for f in feats]
    assert batched == seq
