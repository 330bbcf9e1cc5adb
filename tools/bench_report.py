#!/usr/bin/env python
"""Full benchmark suite: per-stage timings across the framework.

Writes a JSON report (default BENCH_REPORT.json) covering every hot path:
fused STFT (both XLA engines), colormap, PNG encoders, HMM fit/decode,
streaming STFT, and the end-to-end export pipeline. `bench.py` stays the
single-line contract; this is the engineering view. Runs on a GPU only; the
report names the card and its power limit.

Usage: python tools/bench_report.py [--out FILE] [--quick] [--no-e2e]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timer_amortized(per_batch_fn, xb, K=8, reps=2):
    """Per-batch time with K sub-batches inside one dispatch, completion
    forced by one scalar readback (see bench.py)."""
    import jax
    import jax.numpy as jnp

    def many(x):
        # checksum the WHOLE output (same rule as bench.py): reducing only
        # a slice lets XLA slice-sink/DCE most of the stage under test —
        # e.g. a [:8] checksum computes the colormap tail for 8 pixels
        # instead of the full batch, under-measuring the pipeline rows
        return jnp.sum(jax.lax.map(
            lambda i: jnp.sum(per_batch_fn(
                x * (1.0 + 0.05 * i.astype(jnp.float32)))),
            jnp.arange(K)))

    p = jax.jit(many)
    float(p(xb))
    t0 = time.time()
    for _ in range(reps):
        float(p(xb))
    return (time.time() - t0) / (reps * K)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="BENCH_REPORT.json")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-e2e", action="store_true",
                    help="skip the end-to-end PNG export stage")
    args = ap.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.core.stft import power_spectrogram, num_frames
    from spectral_tpu.core.scale import normalize
    from spectral_tpu.ops.colormap import apply_colormap_packed, unpack_rgba
    from spectral_tpu.render.png import encode_png
    from spectral_tpu.utils.cache import enable_compilation_cache
    from spectral_tpu.utils.gpu import card_identity, require_gpu
    devs = require_gpu()
    enable_compilation_cache()

    class _FlushingStages(dict):
        """Persist the report after EVERY stage, so a failure in a late
        stage keeps the finished ones. Atomic same-dir replace so a crash
        mid-flush cannot truncate a previously good report."""
        def __setitem__(self, key, value):
            super().__setitem__(key, value)
            tmp = args.out + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(report, fh, indent=2)
            os.replace(tmp, args.out)

    report = {"card": card_identity(), "platform": devs[0].platform,
              "device_kind": devs[0].device_kind, "n_devices": len(devs),
              "timestamp": time.time(), "stages": _FlushingStages()}
    S = report["stages"]

    fs = 16000.0
    B = 32 if args.quick else 256
    n = 160000
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    rng = np.random.RandomState(0)
    xb = jnp.asarray(rng.randn(B, n).astype(np.float32))
    clip_h = B * (n / fs) / 3600.0

    def ahpm(dt):
        return round(clip_h / (dt / 60.0), 1)

    # STFT variants (dispatch-amortized)
    dt = _timer_amortized(
        lambda x: power_spectrogram(x, fs, cfg, use_matmul=True), xb)
    S["stft_xla_matmul"] = {"ms_per_clip": round(dt * 1000 / B, 4),
                            "audio_hours_per_min": ahpm(dt)}
    dt = _timer_amortized(
        lambda x: power_spectrogram(x, fs, cfg, use_matmul=False), xb)
    S["stft_xla_fft"] = {"ms_per_clip": round(dt * 1000 / B, 4),
                         "audio_hours_per_min": ahpm(dt)}

    # The reference's own default path (BASELINE.md rows 1-2: scipy
    # spectrogram at PlotEngine.py:113 — Tukey 0.25, hop = nperseg -
    # nperseg//8 = 896, constant detrend; 11.8 audio-h/min single-core).
    # Both XLA engines run it natively.
    cfg_ref = SpecConfig.scipy_default(1024)
    ref_ahpm_cpu = 11.8
    row = {}
    dt = _timer_amortized(
        lambda x: power_spectrogram(x, fs, cfg_ref, use_matmul=True), xb)
    row["xla_matmul_ms_per_clip"] = round(dt * 1000 / B, 4)
    row["xla_matmul_audio_hours_per_min"] = ahpm(dt)
    dt_fft = _timer_amortized(
        lambda x: power_spectrogram(x, fs, cfg_ref, use_matmul=False), xb)
    row["xla_fft_ms_per_clip"] = round(dt_fft * 1000 / B, 4)
    row["xla_fft_audio_hours_per_min"] = ahpm(dt_fft)
    best = max(v for k, v in row.items() if k.endswith("per_min"))
    row["vs_cpu_reference_11.8"] = round(best / ref_ahpm_cpu, 1)
    row["note"] = ("the reference's exact scipy-default config "
                   "(PlotEngine.py:113); baseline = 11.8 audio-h/min "
                   "single-core scipy (BASELINE.md row 1)")
    S["stft_scipy_default_1024"] = row

    # Worst-case end of the GUI-legal nperseg range (GUI.py:87-90): the
    # matmul engine runs the factorized CT form (core/stft.py::_ct_dft).
    cfg_8k = SpecConfig.scipy_default(8192)
    row = {}
    dt = _timer_amortized(
        lambda x: power_spectrogram(x, fs, cfg_8k, use_matmul=True), xb)
    row["xla_matmul_ct_ms_per_clip"] = round(dt * 1000 / B, 4)
    row["xla_matmul_ct_audio_hours_per_min"] = ahpm(dt)
    dt = _timer_amortized(
        lambda x: power_spectrogram(x, fs, cfg_8k, use_matmul=False), xb)
    row["xla_fft_ms_per_clip"] = round(dt * 1000 / B, 4)
    row["xla_fft_audio_hours_per_min"] = ahpm(dt)
    row["note"] = ("scipy-default at nperseg=8192 — the f32-accumulation "
                   "worst case; matmul engine is the two-stage "
                   "Cooley-Tukey factorization (128 x 64) with COMPENSATED "
                   "f32 prep+twiddle on the accurate tier (the fast tier "
                   "skips compensation)")
    S["stft_scipy_default_8192"] = row

    # full pipeline — the PRODUCTION kernel (freq-major spine, PNG row
    # flip folded into the DFT matrix columns; parallel/sharding.py)
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    cfg_disp = dataclasses.replace(cfg, log_scale=True)
    _prod = batched_spectrogram_fn(fs, cfg_disp, use_matmul=True,
                                   colormap="jet", flip_image=True)
    full = lambda x: _prod(x)["rgb_packed"]                 # noqa: E731
    dt = _timer_amortized(full, xb)
    S["pipeline_full"] = {"ms_per_clip": round(dt * 1000 / B, 4),
                          "audio_hours_per_min": ahpm(dt),
                          "note": "production batched_spectrogram_fn "
                                  "(flip_image fold), RGBA-packed output"}

    # same pipeline on the measured 'fast' precision tier (bf16 3-pass
    # DFT matmuls, ~5e-2 dB display-only error — core/stft.py
    # matmul_precision): the throughput headroom when the scipy contract
    # is not required
    cfg_fast = dataclasses.replace(cfg, precision="fast", log_scale=True)
    _prod_fast = batched_spectrogram_fn(fs, cfg_fast, use_matmul=True,
                                        colormap="jet", flip_image=True)
    full_fast = lambda x: _prod_fast(x)["rgb_packed"]       # noqa: E731
    dt = _timer_amortized(full_fast, xb)
    S["pipeline_full_fast_tier"] = {
        "ms_per_clip": round(dt * 1000 / B, 4),
        "audio_hours_per_min": ahpm(dt),
        "note": "precision='fast' (bf16 3-pass DFT, ~5e-2 dB display-only "
                "error tier) — the rate when scipy-contract accuracy "
                "is not required"}

    # PNG encode (host): a 4-clip program — jitting `full` over the whole
    # 256-clip batch here would be a fresh compile plus 64x the device work
    # just to keep 4 images
    packed = np.asarray(jax.jit(full)(xb[:4]))
    rgba = unpack_rgba(packed)
    for lvl in (1, 4):
        t0 = time.time()
        for i in range(4):
            encode_png(rgba[i], compress_level=lvl)
        S[f"png_encode_l{lvl}"] = {
            "ms_per_image": round((time.time() - t0) / 4 * 1000, 2)}

    # HMM fit + viterbi (host CPU device, as the detector places it)
    from spectral_tpu.models import hmm
    T = 600
    feats = np.asarray(rng.randn(T, 2), np.float32)
    feats[100:200] += 3.0
    with jax.default_device(jax.devices("cpu")[0]):
        p0 = hmm.init_params(feats, 4, seed=42)
        X = jnp.asarray(feats)
        params, ll, it = hmm.fit(p0, X, n_iter=100)   # warm (compile)
        np.asarray(hmm.viterbi(params, X))
        t0 = time.time()
        params, ll, it = hmm.fit(p0, X, n_iter=100)
        ll = float(ll)
        fit_s = time.time() - t0
        t0 = time.time()
        st = np.asarray(hmm.viterbi(params, X))
        vit_s = time.time() - t0
    S["hmm_fit_T600"] = {"seconds": round(fit_s, 3), "iters": int(it)}
    S["hmm_viterbi_T600"] = {"ms": round(vit_s * 1000, 2)}

    # the whole unrefined detection compute (fit + transmat patch + Viterbi)
    # as ONE dispatch on the default backend — the dispatch-latency answer
    # to round 1's 147 ms device Viterbi
    pd = hmm.unsupervised_fit_decode(p0, jnp.asarray(feats), n_iter=100)
    np.asarray(pd[1])   # warm: compile + readback
    t0 = time.time()
    pd = hmm.unsupervised_fit_decode(p0, jnp.asarray(feats), n_iter=100)
    _ = np.asarray(pd[1])
    S["hmm_fused_detect_T600_device"] = {
        "ms": round((time.time() - t0) * 1000, 2),
        "note": "fit+patch+viterbi, one dispatch, default backend"}

    # Interactive detect latency, warm-started: plot -> events with the
    # detection programs precompiled at plot time (BurstDetector.warmup,
    # triggered by AnalysisSession._compute_spectrogram). Compares the
    # forced-device path against the AUTO_CPU placement the detector would
    # otherwise pick for T=600.
    from spectral_tpu.models.detector import BurstDetector
    tax = np.arange(T) * 0.064

    def detect_ms(device):
        det = BurstDetector(device=device)
        det.warmup(T, 2, background=False)      # what plot time does
        det.unsupervised_detect(tax, feats)     # absorb one-time constants
        best, n = float("inf"), 0
        for _ in range(3):                      # best-of-3
            det.reset()
            t0 = time.time()
            ev_out = det.unsupervised_detect(tax, feats)
            best, n = min(best, (time.time() - t0) * 1000), len(ev_out)
        return best, n

    dev_ms, n_ev = detect_ms("default")
    cpu_ms, _ = detect_ms("cpu")
    # round-trip floor: a trivial jitted program + one 600-int32 fetch on
    # the default backend — the irreducible cost any device detection pays
    # regardless of compute
    tiny = jax.jit(lambda v: v + 1)
    xz = jnp.zeros(T, jnp.int32)
    np.asarray(tiny(xz))
    floors = []
    for _ in range(5):
        t0 = time.time()
        np.asarray(tiny(xz))
        floors.append((time.time() - t0) * 1000)
    S["interactive_detect_T600_warm"] = {
        "device_ms": round(dev_ms, 1), "cpu_ms": round(cpu_ms, 1),
        "device_vs_cpu": round(dev_ms / cpu_ms, 2), "events": n_ev,
        "dispatch_floor_ms": round(min(floors), 1),
        "note": "warm fit+patch+viterbi with states+baseline packed into "
                "ONE readback; dispatch_floor_ms = a trivial jitted "
                "program + 600-int32 fetch on the same backend — the "
                "irreducible round-trip cost, which is why detector AUTO "
                "mode picks cpu for small T"}

    # Long-recording HMM: the parallel-prefix engine (models/hmm_pscan.py,
    # chunked two-level scans) vs the sequential lax.scan forms at hour
    # scale — T=524288 frames is ~1 h of 48 kHz audio at the north-star
    # hop (or ~9 h of 1 kHz EEG at scipy-default 1024). The sequential
    # engine pays O(T) tiny steps per pass; the pscan engine is ~flat in
    # T. Viterbi paths are bitwise-equal between engines (pinned in
    # tests/test_hmm_pscan.py); the pscan E-step is also the MORE accurate
    # one (gamma 1.3e-7 vs 1.2e-2 against an f64 oracle at T=601).
    from spectral_tpu.models import hmm_pscan
    T_long = 524288
    rng_l = np.random.RandomState(11)
    X_long = jnp.asarray(rng_l.randn(T_long, 2).astype(np.float32))
    p0_long = hmm.init_params(
        np.asarray(X_long[:4096], np.float64), 4, seed=42)
    row_long = {}
    for name, mod in (("pscan", hmm_pscan), ("scan", hmm)):
        if name == "scan":
            # the sequential engine at T=524288 costs minutes per program;
            # measure it at T=65536 and report per-frame cost
            Tm = 65536
            Xm = X_long[:Tm]
        else:
            Tm, Xm = T_long, X_long
        vit = jax.jit(mod.viterbi)
        st = np.asarray(vit(p0_long, Xm))               # compile + warm
        t0 = time.time()
        st = np.asarray(vit(p0_long, Xm))
        row_long[f"{name}_viterbi_T{Tm}_ms"] = round(
            (time.time() - t0) * 1000, 1)
        fit5 = jax.jit(lambda p, x, m=mod: m.fit(p, x, n_iter=5, tol=-1e30))
        _ = float(fit5(p0_long, Xm)[1])
        t0 = time.time()
        _ = float(fit5(p0_long, Xm)[1])
        row_long[f"{name}_fit5_T{Tm}_ms"] = round((time.time() - t0) * 1000, 1)
    row_long["note"] = (
        "parallel-prefix HMM at T=524288 (~1 h @ 48 kHz, hop 256) vs the "
        "sequential engine at T=65536 (its per-frame cost scales "
        "linearly); BurstDetector engine='auto' switches at "
        f"{BurstDetector.PSCAN_THRESHOLD} frames on EVERY backend — a "
        "correctness threshold: the sequential f32 E-step is wrong from "
        "~2k frames (gamma off by O(1) at 4096, inf by 65536) while the "
        "pscan E-step holds ~1.7e-7 vs an f64 oracle at every measured T")
    S["hmm_long_context"] = row_long

    # Interactive plot latency: the session's fused plot program (one
    # jitted dispatch + one stacked D2H pull of the banded display pair;
    # api/session._plot_program) at the reference GUI's exact interactive
    # config — 60 s @ 1 kHz EEG clip, scipy-default 1024, fmin 0 / fmax 30
    # (62 of 513 rows), log display. The reference pays ~14 ms scipy +
    # ~360 ms pcolormesh for the same click (SURVEY.md §6).
    from spectral_tpu.api.session import AnalysisSession
    from spectral_tpu.io.registry import SweepEntry
    sess = AnalysisSession(warm_detection=False)
    rng_p = np.random.RandomState(7)
    sess.registry.register("bench_sweep0", SweepEntry(
        filepath="<bench>", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=rng_p.randn(60000).astype(np.float32), processed=None))
    cfg_plot = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0,
                                        log_scale=True)
    sess.plot_sweeps(["bench_sweep0"], cfg_plot)        # warm/compile
    t_plot = []
    for _ in range(5):
        t0 = time.time()
        r = sess.plot_sweeps(["bench_sweep0"], cfg_plot)
        assert r.image is not None                      # host array: done
        t_plot.append((time.time() - t0) * 1000)
    S["interactive_plot_60s_eeg_warm"] = {
        "ms": round(min(t_plot), 1),
        "image_shape": list(r.image.shape),
        "note": "warm plot->image wall time through AnalysisSession (one "
                "fused dispatch + one stacked banded D2H); reference GUI "
                "pays ~374 ms in scipy+pcolormesh for this click"}

    # Long-form streaming STFT (BASELINE config 4 / BASELINE.md row 3:
    # 1 h @ 48 kHz on the reference's exact scipy-default path, measured
    # 6.2 audio-h/min on CPU). Device-resident ScanStreamer: ONE dispatch
    # for the whole hour, overlap carry threaded through lax.scan, PSD
    # folded into (global max, total power, frame count) on device so the
    # readback is three scalars. Input staged to device memory once
    # (outside the timed region, like the batch benches above).
    from spectral_tpu.parallel.streaming import ScanStreamer
    cfg_s = SpecConfig.scipy_default(1024)               # hop 896
    stream_minutes = 1 if args.quick else 60
    n_long = 48000 * 60 * stream_minutes
    chunk = 896 * 1024                                   # ~19 s of audio
    cpb = 8                                              # ~2.9 M-sample blocks

    def fold(acc, psd, valid):
        m, s, k = acc
        v = valid[:, None].astype(psd.dtype)
        return ((jnp.maximum(m, jnp.max(psd * v)), s + jnp.sum(psd * v),
                 k + jnp.sum(valid)), jnp.zeros(()))

    streamer = ScanStreamer(48000.0, cfg_s, chunk * cpb, n_long,
                            use_matmul=True, fold=fold,
                            init=(jnp.zeros(()), jnp.zeros(()),
                                  jnp.zeros((), jnp.int32)))
    long_x = jnp.asarray(rng.randn(n_long).astype(np.float32))
    (m0, s0, k0), _ = streamer(long_x)                   # warm: compile
    assert int(k0) == num_frames(n_long, 1024, 896), int(k0)
    reps = 1 if args.quick else 3
    mono_detail = []
    for _ in range(reps):
        t0 = time.time()
        acc, _ys = streamer(long_x)
        float(acc[1])                                    # force completion
        w = time.time() - t0
        mono_detail.append({"wall_s": round(w, 3)})
    walls = sorted(d["wall_s"] for d in mono_detail)
    dt = walls[(len(walls) - 1) // 2]                    # lower median
    S[f"streaming_{stream_minutes}min_48k"] = {
        "seconds": round(dt, 3),
        "reps_detail": mono_detail,
        "audio_hours_per_min": round(
            (stream_minutes / 60.0) / (dt / 60.0), 1),
        "vs_cpu_reference_6.2": round(
            (stream_minutes / 60.0) / (dt / 60.0) / 6.2, 1),
        "note": "device-resident lax.scan over chunk blocks (ScanStreamer), "
                "one dispatch per run; reference scipy path measured 6.2 "
                "audio-h/min on this workload (BASELINE.md row 3)"}

    # Parameter-sweep grid (BASELINE config 3): 16 (n_fft, hop, window)
    # combos over one clip, shape-grouped + window-vmapped into batched
    # matmuls sharing one framed buffer per shape.
    from spectral_tpu.parallel.sweep_grid import default_grid, sweep_grid
    grid = default_grid()
    x1 = jnp.asarray(rng.randn(n).astype(np.float32))

    def grid_checksums(x):
        return jnp.stack([jnp.sum(o) for o in sweep_grid(x, fs, grid)])

    gj = jax.jit(grid_checksums)
    np.asarray(gj(x1))
    t0 = time.time()
    reps_g = 2 if args.quick else 5
    for _ in range(reps_g):
        np.asarray(gj(x1))
    dt = (time.time() - t0) / reps_g
    S["sweep_grid_16combo_10s"] = {
        "ms_per_grid": round(dt * 1000, 2),
        "combos": len(grid),
        "note": "16 (n_fft in 256..4096 x window) PSDs of one 10 s clip, "
                "one dispatch (4096 group uses device-generated DFT "
                "matrices) — see sweep_grid_batched for the amortized "
                "rate"}

    # BATCHED grids (BASELINE config 3 throughput artifact, r4 verdict
    # item 2): 64 clips through the 16-combo grid in ONE dispatch — the
    # production shape for dataset-scale parameter sweeps. The reference
    # runs the grid as a serial per-combo scipy loop (GUI.py:374-453
    # rebuilds the spectrogram per combo); its rate is measured HERE, on
    # this host, on the same configs (guarded scipy import — scipy is the
    # bench oracle per repo convention, never a package dependency).
    B_grid = 8 if args.quick else 64
    xg = jnp.asarray(rng.randn(B_grid, n).astype(np.float32))

    def grid_checksums_b(xs):
        return jnp.stack([jnp.sum(o) for o in sweep_grid(xs, fs, grid)])

    gjb = jax.jit(grid_checksums_b)
    np.asarray(gjb(xg))                                  # warm/compile
    t0 = time.time()
    reps_gb = 2 if args.quick else 3
    for _ in range(reps_gb):
        np.asarray(gjb(xg))
    dt_b = (time.time() - t0) / reps_gb
    row_g = {"clips": B_grid, "combos": len(grid),
             "ms_per_grid": round(dt_b * 1000 / B_grid, 3),
             "grids_per_s": round(B_grid / dt_b, 1)}
    try:
        from scipy import signal as _sig                 # bench oracle only
        x_cpu = np.asarray(xg[0])
        t0 = time.time()
        cpu_reps = 1 if args.quick else 2
        for _ in range(cpu_reps):
            for c in grid:
                w = c.window if isinstance(c.window, str) else c.window
                _sig.spectrogram(x_cpu, fs, window=_sig.get_window(
                    w, c.nperseg), nperseg=c.nperseg,
                    noverlap=c.nperseg - c.hop_, detrend=False,
                    mode="psd")
        cpu_grid_s = (time.time() - t0) / cpu_reps
        row_g["cpu_scipy_ms_per_grid"] = round(cpu_grid_s * 1000, 1)
        row_g["vs_cpu_scipy"] = round(cpu_grid_s / (dt_b / B_grid), 1)
    except ImportError:
        row_g["cpu_scipy_ms_per_grid"] = None
    row_g["note"] = (f"{B_grid} clips x 16 combos amortized in one "
                     "dispatch (shape-grouped window-vmapped matmuls; "
                     ">=2048 groups on the factorized CT engine); "
                     "cpu_scipy = the reference's serial per-combo loop "
                     "(GUI.py:374-453) measured on the host over the "
                     "identical configs")
    S["sweep_grid_batched"] = row_g

    # same batched grid on the fast tier (bf16 3-pass, the display-only
    # precision class): the config-3 rate when the scipy dB contract is
    # not required
    grid_fast = [dataclasses.replace(c, precision="fast") for c in grid]

    def grid_checksums_bf(xs):
        return jnp.stack([jnp.sum(o) for o in sweep_grid(xs, fs, grid_fast)])

    gjf = jax.jit(grid_checksums_bf)
    np.asarray(gjf(xg))                                  # warm/compile
    t0 = time.time()
    for _ in range(reps_gb):
        np.asarray(gjf(xg))
    dt_f = (time.time() - t0) / reps_gb
    row_gf = {"clips": B_grid, "combos": len(grid),
              "ms_per_grid": round(dt_f * 1000 / B_grid, 3),
              "grids_per_s": round(B_grid / dt_f, 1)}
    if row_g.get("cpu_scipy_ms_per_grid"):
        row_gf["vs_cpu_scipy"] = round(
            row_g["cpu_scipy_ms_per_grid"] / (dt_f * 1000 / B_grid), 1)
    row_gf["note"] = ("precision='fast' (bf16 3-pass DFT) batched grid — "
                      "display-parity tier")
    S["sweep_grid_batched_fast_tier"] = row_gf

    # Mel batch export (BASELINE config 2): 64 clips -> 128-bin log-mel
    # spectrograms -> PNG files on disk through the overlapped pipeline.
    if not args.no_e2e:
        import shutil
        import tempfile
        from spectral_tpu.parallel.pipeline import export_spectrograms
        cfg_mel = SpecConfig.north_star(1024, 256, log_scale=True,
                                        n_mels=128)
        pool16 = [(rng.randn(n) * 8000).astype(np.int16) for _ in range(64)]
        mel_dir = tempfile.mkdtemp(prefix="spectpu_mel_")
        try:
            def run_mel():
                return export_spectrograms(
                    ((f"mel{i:03d}", pool16[i]) for i in range(64)),
                    fs, cfg_mel, mel_dir, clip_samples=n, batch=64,
                    compress_level=1)
            run_mel()                                 # warm (compile cache)
            # MEDIAN of several reps, with the per-stage breakdown so a
            # slow rep is attributable (D2H vs producer vs encode)
            reps_m = 2 if args.quick else 3
            runs = []
            for _ in range(reps_m):
                t0 = time.time()
                st = run_mel()
                runs.append((time.time() - t0, st))
            runs.sort(key=lambda r: r[0])
            # LOWER median: with --quick's 2 reps, len//2 would select the
            # SLOWER rep
            dt, st = runs[(len(runs) - 1) // 2]
        finally:
            shutil.rmtree(mel_dir, ignore_errors=True)
        assert st.pngs_written == 64
        mel_ahpm = (st.seconds_audio / 3600.0) / (dt / 60.0)
        S["mel128_batch64_export"] = {
            "seconds": round(dt, 2),
            "seconds_all_reps": [round(r[0], 2) for r in runs],
            "audio_hours_per_min": round(mel_ahpm, 1),
            "vs_reference_export_0.014": round(
                mel_ahpm / ((10.0 / 3600.0) / (11.8 / 60.0)), 1),
            "breakdown": st.breakdown(),
            "note": "64 clips -> 128-bin log-mel -> palette PNGs on disk "
                    "(BASELINE config 2), warmed, median of "
                    f"{reps_m} reps"}

    # Stereo long-form (BASELINE config 4 verbatim: 1 h 48 kHz STEREO):
    # both channels stream as a 2-recording fleet in one scan.
    from spectral_tpu.parallel.streaming import ScanStreamer as _SS

    def fold2(acc, psd, valid):
        v = valid[None, :, None].astype(psd.dtype)
        return (acc[0] + jnp.sum(psd * v, axis=(1, 2)),
                acc[1] + jnp.sum(valid)), jnp.zeros(())

    st2 = _SS(48000.0, cfg_s, chunk * cpb, n_long, use_matmul=True,
              fold=fold2, init=(jnp.zeros(2), jnp.zeros((), jnp.int32)),
              batch=2)
    stereo = jnp.asarray(rng.randn(2, n_long).astype(np.float32))
    (tot2, k2), _ = st2(stereo)                       # warm
    # the frame-slot mask is shared across the fleet: counted once per block
    assert int(k2) == num_frames(n_long, 1024, 896), int(k2)
    stereo_detail = []
    for _ in range(reps):
        t0 = time.time()
        acc2, _ys2 = st2(stereo)
        float(acc2[0][0])
        w = time.time() - t0
        stereo_detail.append({"wall_s": round(w, 3)})
    reps2 = sorted(d["wall_s"] for d in stereo_detail)
    dt = reps2[(len(reps2) - 1) // 2]                    # lower median
    S[f"streaming_{stream_minutes}min_48k_stereo"] = {
        "seconds": round(dt, 3),
        "seconds_all_reps": [round(s, 3) for s in reps2],
        "reps_detail": stereo_detail,
        "audio_hours_per_min": round((stream_minutes / 60.0) / (dt / 60.0), 1),
        "total_audio_hours_per_min": round(
            (2 * stream_minutes / 60.0) / (dt / 60.0), 1),
        "vs_cpu_reference_6.2_total_audio": round(
            (2 * stream_minutes / 60.0) / (dt / 60.0) / 6.2, 1),
        "note": "both channels as a 2-recording fleet in one lax.scan "
                "(small-fleet UNROLLED ScanStreamer: per-recording mono "
                "bodies); audio_hours_per_min counts the recording once, "
                "total_audio_hours_per_min counts both channels"}

    # End-to-end export (BASELINE config 5): decode -> fused STFT -> colormap
    # -> PNG on disk, all three stages overlapped (parallel/pipeline.py).
    # Reference analog: the serial matplotlib savefig loop at ~11.8 s/figure
    # (ExportManager.py:108,184; BASELINE.md) = 0.0141 audio-h/min on 10 s
    # clips. A pool of distinct clips is cycled so staging cost is real
    # without holding 10k x 160k floats in RAM.
    if not args.no_e2e:
        import shutil
        import tempfile
        from spectral_tpu.parallel.pipeline import export_spectrograms
        n_clips = 200 if args.quick else int(
            os.environ.get("E2E_CLIPS", "10000"))
        # int16 pool: what wav_clip_source yields for 16-bit PCM (the
        # pipeline stages raw PCM and normalizes on device)
        pool = [(rng.randn(n) * 8000).astype(np.int16) for _ in range(64)]

        def clip_source():
            for i in range(n_clips):
                yield f"clip{i:05d}", pool[i % len(pool)]

        # encode-worker / executor sweep at a reduced clip count: where does
        # host-side encode saturate?
        ncpu = os.cpu_count() or 1
        sweep = {}
        sweep_clips = 100 if args.quick else 1000

        def sweep_source():
            for i in range(sweep_clips):
                yield f"s{i:05d}", pool[i % len(pool)]

        for workers, executor in ((4, "thread"), (ncpu, "thread"),
                                  (2 * ncpu, "thread"), (ncpu, "process")):
            d = tempfile.mkdtemp(prefix="spectpu_sweep_")
            try:
                t0 = time.time()
                stw = export_spectrograms(
                    sweep_source(), fs, cfg, d, clip_samples=n, batch=128,
                    compress_level=1, encode_workers=workers,
                    encode_executor=executor)
                dtw = time.time() - t0
            finally:
                shutil.rmtree(d, ignore_errors=True)
            sweep[f"{executor}_x{workers}"] = {
                "audio_hours_per_min": round(
                    (stw.seconds_audio / 3600.0) / (dtw / 60.0), 1),
                **stw.breakdown()}
        S["export_encode_sweep"] = {"clips_per_run": sweep_clips,
                                    "cpus": ncpu, **sweep}
        best_key = max(sweep, key=lambda k:
                       sweep[k]["audio_hours_per_min"])
        best_exec, best_workers = best_key.rsplit("_x", 1)

        out_dir = tempfile.mkdtemp(prefix="spectpu_e2e_")
        try:
            t0 = time.time()
            st = export_spectrograms(
                clip_source(), fs, cfg, out_dir, clip_samples=n, batch=128,
                compress_level=1, encode_workers=int(best_workers),
                encode_executor=best_exec)
            dt = time.time() - t0
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        assert st.pngs_written == n_clips, (st.pngs_written, n_clips)
        e2e_ahpm = (st.seconds_audio / 3600.0) / (dt / 60.0)
        ref_export_ahpm = (10.0 / 3600.0) / (11.8 / 60.0)   # 11.8 s/figure
        S["end_to_end_export"] = {
            "clips": st.clips, "pngs_written": st.pngs_written,
            "seconds": round(dt, 1),
            "audio_hours_per_min": round(e2e_ahpm, 1),
            "vs_reference_export_0.014": round(e2e_ahpm / ref_export_ahpm, 1),
            "encode": f"{best_exec} x{best_workers}",
            "breakdown": st.breakdown(),
            "note": "decode->device pipeline->PNG-on-disk, overlapped "
                    "producer/device/encoder stages; raw-int16 staging, "
                    "indexed-color (PLTE) PNGs at level 1; reference = "
                    "ExportManager savefig at 11.8 s/figure"}

    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report["stages"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
