#!/usr/bin/env python
"""Benchmark: batched fused spectrogram pipeline throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "audio-hours/min", "vs_baseline": N,
   "card": "<name>, <power limit>", "device_kind": ..., ...}

Workload: BASELINE.json config-1 shape — 10 s @ 16 kHz clips, n_fft=1024,
hop=256, Hann — run as a batch through the fused on-device pipeline
(frame -> matmul-DFT STFT -> PSD -> normalize -> dB -> arithmetic colormap),
with completion forced by a checksum readback. Baseline: the reference's
measured single-core CPU STFT throughput on the same config,
17.9 audio-hours/min (BASELINE.md; scipy code path PlotEngine.py:113 with
Hann/hop=256).

Exits nonzero, printing no result, when JAX finds no GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_AUDIO_H_PER_MIN = 17.9


def main() -> int:
    import numpy as np
    import jax
    import jax.numpy as jnp
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    from spectral_tpu.utils.cache import (compilation_cache_dir,
                                          enable_compilation_cache)
    from spectral_tpu.utils.gpu import card_identity, require_gpu
    try:
        devs = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    card = card_identity()
    enable_compilation_cache()

    clip_seconds = 10.0
    fs = 16000.0
    batch = int(os.environ.get("BENCH_BATCH", "1024"))
    n = int(clip_seconds * fs)

    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    rng = np.random.RandomState(0)
    xb = jnp.asarray(rng.randn(batch, n).astype(np.float32))

    # flip_image folds the PNG row order into the DFT matrix columns —
    # the production pipeline's kernel (no device-side flip pass)
    fn_raw = batched_spectrogram_fn(fs, cfg, use_matmul=True, colormap="jet",
                                    flip_image=True)

    # K sub-batches run inside one dispatch (lax.map; sub-batch i is a
    # rescaled view of the staged batch, so device memory holds one input),
    # each sub-batch's packed image is reduced to a checksum on device, and
    # one scalar readback forces completion of everything.
    reps = int(os.environ.get("BENCH_REPS", "5"))
    K = int(os.environ.get("BENCH_SUBBATCHES", "16"))

    def one(x, i):
        packed = fn_raw(x * (1.0 + 0.05 * i.astype(jnp.float32)))["rgb_packed"]
        return jnp.sum(packed.astype(jnp.float32))

    many_j = jax.jit(
        lambda x: jnp.sum(jax.lax.map(lambda i: one(x, i), jnp.arange(K))))
    t_compile0 = time.time()
    checksum = float(many_j(xb))  # warm: compile + first device->host xfer
    warmup_s = time.time() - t_compile0
    assert checksum == checksum  # not NaN

    rep_s = []
    for _ in range(reps):
        t0 = time.time()
        float(many_j(xb))
        rep_s.append(time.time() - t0)
    rep_s_sorted = sorted(rep_s)
    median_s = rep_s_sorted[len(rep_s) // 2] if reps % 2 else (
        rep_s_sorted[reps // 2 - 1] + rep_s_sorted[reps // 2]) / 2.0
    spread_pct = 100.0 * (rep_s_sorted[-1] - rep_s_sorted[0]) / median_s

    audio_hours_per_rep = K * batch * clip_seconds / 3600.0
    ahpm = audio_hours_per_rep / (median_s / 60.0)
    ahpm_best = audio_hours_per_rep / (rep_s_sorted[0] / 60.0)

    # Accuracy artifacts: max |dB| error vs a float64 scipy oracle on one
    # clip (scipy is a bench/test oracle only, never a package dependency).
    # The display image is min-max rescaled to [0, 1], so the error maps
    # back to dB via the image's dB range. Three points:
    #   * the exact kernel being timed (headline config, 'accurate' tier);
    #   * the scipy-compat nperseg=8192 config — the f32-accumulation worst
    #     case of the 1e-3 dB contract (core/stft.matmul_precision);
    #   * the 'fast' (bf16 3-pass) tier at the headline config.
    from scipy.signal import spectrogram as sp_spec

    def db_image_err(dev_img, x64, **sp_kw):
        _f, _t, sxx = sp_spec(x64, fs=fs, scaling="density", mode="psd",
                              **sp_kw)
        norm = np.clip(sxx / (sxx.max() + 1e-20), 0.0, 1.0)
        db = np.nan_to_num(10.0 * np.log10(norm + 1e-12))
        rng_db = db.max() - db.min()
        oracle_img = (db - db.min()) / rng_db
        return round(float(np.max(np.abs(dev_img - oracle_img)) * rng_db), 6)

    x0 = np.asarray(xb[0], np.float64)
    # fn_raw's image is display-flipped (flip_image) — unflip for the oracle
    dev_img = np.asarray(jax.jit(lambda x: fn_raw(x)["image"])(xb[:1]))[0]
    max_db_err = db_image_err(dev_img[::-1], x0, window="hann", nperseg=1024,
                              noverlap=1024 - 256, nfft=1024, detrend=False)

    cfg8k = SpecConfig.scipy_default(8192, log_scale=True)
    img8k = np.asarray(jax.jit(lambda x: batched_spectrogram_fn(
        fs, cfg8k, use_matmul=True, colormap=None)(x)["image"])(xb[:1]))[0]
    err_8192 = db_image_err(img8k, x0, nperseg=8192)

    cfg_fast = SpecConfig.north_star(1024, 256, log_scale=True,
                                     precision="fast")
    img_fast = np.asarray(jax.jit(lambda x: batched_spectrogram_fn(
        fs, cfg_fast, use_matmul=True, colormap=None)(x)["image"])(xb[:1]))[0]
    err_fast = db_image_err(img_fast, x0, window="hann", nperseg=1024,
                            noverlap=1024 - 256, nfft=1024, detrend=False)

    print(json.dumps({
        "metric": ("spectrogram pipeline throughput "
                   f"(n_fft=1024, hop=256, batch={batch}, 10s@16kHz, "
                   "dense DFT at HIGHEST)"),
        "value": round(ahpm, 1),
        "unit": "audio-hours/min",
        "vs_baseline": round(ahpm / BASELINE_AUDIO_H_PER_MIN, 1),
        "card": card,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "value_best": round(ahpm_best, 1),
        "reps": reps,
        "rep_seconds": [round(s, 4) for s in rep_s],
        "spread_pct": round(spread_pct, 1),
        "warmup_s": round(warmup_s, 1),
        "compile_cache": compilation_cache_dir(),
        "max_db_err_vs_scipy": max_db_err,
        "max_db_err_8192_scipy_compat": err_8192,
        "max_db_err_fast_tier": err_fast,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
