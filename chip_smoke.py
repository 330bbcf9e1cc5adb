#!/usr/bin/env python
"""Drive spectral_tpu's main path once on NVIDIA GPUs and check every result.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded paths only

One card, at BASELINE.json sizes, on data made from ``--seed``:

  render   the CLI's `render` (headline 1024/256 Hann and --scipy-compat) on
           a 10 s, 16 kHz WAV; the PSD of both STFT engines against scipy
           float64 (<= 2e-5 relative) and the display image (<= 1e-3 dB),
           the compensated Cooley-Tukey route at 8192 scipy-compat
           (<= 1e-3 dB, the plain route's error beside it) and the 'fast'
           tier's error
  engines  the batched packed-image pipeline at batch 1024 with the dense
           DFT at HIGHEST and with rFFT, timed
  detect   Gaussian-HMM fit + Viterbi on an EEG-like bursty recording on
           the device against the CPU run (events must be equal), and the
           parallel-prefix engine at T = 524,288 frames against CPU
  stream   1 h of 48 kHz stereo through ScanStreamer against the
           monolithic PSD (rtol 2e-5, atol 1e-9), with device memory
  grid     the 16-combo sweep grid against power_spectrogram per combo
  export   1,024 palette PNGs through export_spectrograms; against a CPU
           run of a subset, never more than one LUT step apart, and the
           card's pixels equal the float64 oracle's at least as often as
           the CPU's (the identical share is printed beside 99.9 %)
  serve    the JSONL serve loop answering detect and render_batch
  entry    __graft_entry__.entry() and dryrun_multichip(1)

Four cards (--four): the sharded export, shard_pipeline(share_max=True),
time-sharded scan_spectrogram and distributed EM, each against its
one-card result, each output on 4 distinct devices.

Every phase prints one JSON line: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them, the device kind, cold (first call, compiles included) and steady
seconds, and each error beside its limit. The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Exits nonzero when any phase fails, and exits nonzero printing no result
when JAX finds no GPU or the repository is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ONE_CARD_PHASES = ("render", "engines", "detect", "stream", "grid", "export",
                   "serve", "entry")
FOUR_CARD_PHASES = ("four_export", "four_share_max", "four_stream",
                    "four_em")

PSD_REL_LIMIT = 2e-5       # PSD vs scipy float64, max-normalized
DB_LIMIT = 1e-3            # display image vs scipy float64, dB
FAST_DB_LIMIT = 5e-2       # the 'fast' tier's display error (README)
STREAM_RTOL, STREAM_ATOL = 2e-5, 1e-9


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes. FULL is BASELINE.json's; tests run TINY on the CPU."""
    clip_seconds: float = 10.0        # config 1: 10 s @ 16 kHz
    clip_fs: float = 16000.0
    engine_batch: int = 1024          # the batched pipeline's batch
    reps: int = 5
    eeg_seconds: float = 60.0         # EEG-like recording @ 1 kHz
    pscan_frames: int = 524288        # ~1 h of 48 kHz at hop 256
    stream_seconds: float = 3600.0    # config 4: 1 h @ 48 kHz stereo
    stream_fs: float = 48000.0
    stream_chunk_seconds: float = 60.0
    stream_chunks_per_block: int = 8
    export_clips: int = 1024          # PNGs written by the export phase
    export_batch: int = 128
    export_cpu_subset: int = 32
    serve_clips: int = 8
    four_clips: int = 1024            # config 5 sharded over 4 cards
    four_batch: int = 256


FULL = Sizes()
TINY = Sizes(clip_seconds=1.0, engine_batch=4, reps=1, eeg_seconds=60.0,
             pscan_frames=8192, stream_seconds=4.0, stream_fs=8000.0,
             stream_chunk_seconds=0.5, stream_chunks_per_block=2,
             export_clips=8, export_batch=4, export_cpu_subset=4,
             serve_clips=2, four_clips=16, four_batch=8)


@dataclasses.dataclass
class Ctx:
    sizes: Sizes
    seed: int
    work: str                 # scratch directory, removed at exit
    devices: list


def phases_for(four: bool):
    """Phase names a run executes: the one-card set, or with --four only
    the multi-card paths and what each is compared with."""
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def last_line(devices) -> dict:
    """The final stdout line: the device as JAX reports it."""
    d = devices[0]
    return {"ok": True, "device": {"platform": d.platform,
                                   "kind": d.device_kind,
                                   "count": len(devices)}}


def check(name, value, limit, gated=True, kind="max"):
    """One error beside its limit; ok when value <= limit (kind='max') or
    value >= limit (kind='min'). Ungated checks report only."""
    v = float(value)
    ok = v <= limit if kind == "max" else v >= limit
    return {"name": name, "value": v, "limit": limit, "kind": kind,
            "gated": gated, "ok": bool(ok)}


def _block(x):
    import jax
    return jax.block_until_ready(x)


def _timed(fn, reps=1):
    """(result, cold seconds, steady seconds): the first call includes its
    compiles; steady is the median of `reps` further calls."""
    t0 = time.perf_counter()
    out = _block(fn())
    cold = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _block(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return out, cold, times[len(times) // 2]


def _scipy_psd(x64, fs, cfg):
    """scipy float64 oracle for a SpecConfig (freq-major)."""
    from scipy.signal import get_window, spectrogram
    win = get_window(cfg.window, cfg.nperseg, fftbins=True)
    _f, _t, sxx = spectrogram(
        x64, fs=fs, window=win, nperseg=cfg.nperseg,
        noverlap=cfg.nperseg - cfg.hop_, nfft=cfg.nfft_,
        detrend=False if cfg.detrend == "none" else cfg.detrend,
        scaling=cfg.scaling, mode="psd")
    return sxx


def _db_image(sxx):
    """The display image's arithmetic (normalize(log_scale=True)) in float64:
    dB of sxx/max, min-max rescaled to [0, 1]; also returns the dB range."""
    import numpy as np
    norm = np.clip(sxx / (sxx.max() + 1e-20), 0.0, 1.0)
    db = np.nan_to_num(10.0 * np.log10(norm + 1e-12))
    rng_db = db.max() - db.min()
    return (db - db.min()) / rng_db, rng_db


def db_error(dev_img, oracle_sxx) -> float:
    """Max display error in dB of a device image against scipy float64."""
    import numpy as np
    oracle_img, rng_db = _db_image(np.asarray(oracle_sxx, np.float64))
    return float(np.max(np.abs(np.asarray(dev_img, np.float64)
                               - oracle_img)) * rng_db)


def psd_rel_error(psd_frame_major, oracle_sxx) -> float:
    import numpy as np
    a = np.asarray(psd_frame_major, np.float64).T
    return float(np.max(np.abs(a - oracle_sxx)) / oracle_sxx.max())


def png_size(path):
    """(height, width) from a PNG's IHDR — no decoder needed."""
    import struct
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def pixel_agreement(dir_a, dir_b, names):
    """(identical share, max LUT step) over palette PNGs of the same names
    in two directories."""
    import numpy as np
    from __graft_entry__ import _png_palette_indices
    same = total = 0
    worst = 0
    for name in names:
        a = _png_palette_indices(os.path.join(dir_a, name + ".png"))
        b = _png_palette_indices(os.path.join(dir_b, name + ".png"))
        if a.shape != b.shape:
            return 0.0, 255
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        same += int((d == 0).sum())
        total += d.size
        worst = max(worst, int(d.max()))
    return same / max(total, 1), worst


def oracle_agreement(dir_a, dir_b, clips, fs, cfg):
    """Share of palette pixels equal to the float64 oracle's index image
    (scipy PSD -> dB image -> LUT index, display-flipped) for the PNGs of
    `clips` in each of two directories."""
    import numpy as np
    from __graft_entry__ import _png_palette_indices
    hits = [0, 0]
    total = 0
    for name, pcm in clips:
        x = np.asarray(pcm, np.float64)
        if pcm.dtype == np.int16:
            x = x / 32768.0
        img, _ = _db_image(_scipy_psd(x, fs, cfg))
        want = np.clip(np.floor(img * 256), 0, 255).astype(np.int32)[::-1]
        for k, d in enumerate((dir_a, dir_b)):
            got = _png_palette_indices(os.path.join(d, name + ".png"))
            hits[k] += int((got.astype(np.int32) == want).sum())
        total += want.size
    return hits[0] / total, hits[1] / total


def bursty(fs, seconds, seed, bursts=((10, 15), (30, 38))):
    """EEG-like recording: low noise floor with 6 Hz bursts."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = 0.02 * rng.randn(n)
    for a, b in bursts:
        m = (t >= a) & (t < b)
        x[m] += 0.6 * np.hanning(m.sum()) * np.sin(2 * np.pi * 6.0 * t[m])
    return x.astype(np.float32)


def _clip(ctx, seed_offset=0):
    import numpy as np
    s = ctx.sizes
    n = int(s.clip_seconds * s.clip_fs)
    rng = np.random.default_rng(ctx.seed + seed_offset)
    t = np.arange(n) / s.clip_fs
    chirp = np.sin(2 * np.pi * (100 + 300 * t) * t)
    return (0.3 * chirp + 0.1 * rng.standard_normal(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------

def phase_render(ctx):
    import jax
    import numpy as np
    from spectral_tpu import cli
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.core import stft
    from spectral_tpu.core.scale import normalize
    from spectral_tpu.io.wav import read_wav, write_wav
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    s = ctx.sizes
    fs = s.clip_fs
    wav = os.path.join(ctx.work, "clip.wav")
    write_wav(wav, _clip(ctx), fs)
    out_h = os.path.join(ctx.work, "render_headline.png")
    out_s = os.path.join(ctx.work, "render_scipy.png")

    def render_both():
        rc = cli.main(["render", wav, "-o", out_h, "--log"])
        rc |= cli.main(["render", wav, "-o", out_s, "--scipy-compat",
                        "--log"])
        return rc

    rc, cold, steady = _timed(render_both)
    checks = [check("cli_render_rc", rc, 0)]
    head = SpecConfig.north_star(1024, 256, log_scale=True)
    compat = SpecConfig.scipy_default(1024, log_scale=True)
    n = read_wav(wav)[0].shape[0]
    for path, cfg in ((out_h, head), (out_s, compat)):
        want = (cfg.n_freqs, stft.num_frames(n, cfg.nperseg, cfg.hop_))
        checks.append(check(f"png_shape_{os.path.basename(path)}",
                            float(png_size(path) != want), 0))

    def image(x, cfg, um):
        fn = jax.jit(lambda v: batched_spectrogram_fn(
            fs, cfg, use_matmul=um, colormap=None)(v[None])["image"][0])
        return fn(x)

    # The display error is set by the deepest floor bin of the clip (its
    # f32 error relative to its tiny power), so it varies from clip to
    # clip. The contract clip is bench.py's (white noise from
    # RandomState(seed)); a second white-noise clip is reported beside it.
    # Gated: the PSD on every clip and engine, and the display error of
    # the accurate tier (dense DFT at 1024, compensated CT at 8192) on the
    # contract clip. Everything else is printed beside its limit.
    clips = {"contract": np.random.RandomState(ctx.seed).randn(n),
             "clip2": np.random.default_rng(ctx.seed + 1).standard_normal(n)}
    info = {}
    for cname, x in clips.items():
        x = x.astype(np.float32)
        x64 = x.astype(np.float64)
        for tag, cfg in (("headline", head), ("scipy_compat", compat)):
            oracle = _scipy_psd(x64, fs, cfg)
            info[f"floor_depth_{cname}_{tag}"] = float(oracle.min()
                                                       / oracle.mean())
            for um, eng in ((True, "dense_dft"), (False, "rfft")):
                p = stft.power_spectrogram(x, fs, cfg, use_matmul=um)
                checks.append(check(f"psd_rel_{cname}_{tag}_{eng}",
                                    psd_rel_error(p, oracle),
                                    PSD_REL_LIMIT))
                gated = cname == "contract" and tag == "headline" and um
                checks.append(check(f"db_{cname}_{tag}_{eng}",
                                    db_error(image(x, cfg, um), oracle),
                                    DB_LIMIT, gated=gated))
        # the nperseg 8192 scipy-compat worst case: the compensated CT
        # route, with the plain CT route's error printed beside it (does
        # the error-free-transformation arithmetic survive this compiler?)
        cfg8 = SpecConfig.scipy_default(8192, log_scale=True)
        oracle8 = _scipy_psd(x64, fs, cfg8)
        checks.append(check(f"db_{cname}_8192_compensated_ct",
                            db_error(image(x, cfg8, True), oracle8),
                            DB_LIMIT, gated=cname == "contract"))
        fac = stft.ct_factors(cfg8)
        xr, xi = jax.jit(lambda v: stft._ct_dft(v, cfg8, fac))(x)
        plain = stft._scale_psd(xr * xr + xi * xi, cfg8, fs)
        checks.append(check(f"db_{cname}_8192_plain_ct",
                            db_error(normalize(plain.T, log_scale=True),
                                     oracle8), DB_LIMIT, gated=False))
        checks.append(check(f"db_{cname}_8192_rfft",
                            db_error(image(x, cfg8, False), oracle8),
                            DB_LIMIT, gated=False))
        if cname == "contract":
            fast = dataclasses.replace(head, precision="fast")
            checks.append(check(
                "db_contract_fast_tier_headline",
                db_error(image(x, fast, True), _scipy_psd(x64, fs, head)),
                FAST_DB_LIMIT, gated=False))
    return {"cold_s": cold, "steady_s": steady, "checks": checks, **info}


def phase_engines(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    from spectral_tpu.render.lut import get_lut
    s = ctx.sizes
    fs = s.clip_fs
    n = int(s.clip_seconds * fs)
    B = s.engine_batch
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    xb = jax.random.normal(jax.random.PRNGKey(ctx.seed), (B, n), jnp.float32)
    info = {"batch": B, "clip_seconds": s.clip_seconds}
    outs = {}
    cold_total = steady_total = 0.0
    for um, eng in ((True, "dense_dft_highest"), (False, "rfft")):
        fn = jax.jit(lambda v, um=um: batched_spectrogram_fn(
            fs, cfg, use_matmul=um, colormap="jet",
            flip_image=True)(v)["rgb_packed"])
        out, cold, steady = _timed(lambda: fn(xb), reps=s.reps)
        outs[eng] = out
        cold_total += cold
        steady_total += steady
        info[f"{eng}_cold_s"] = cold
        info[f"{eng}_s_per_batch"] = steady
        info[f"{eng}_ms_per_clip"] = 1000.0 * steady / B
        info[f"{eng}_audio_h_per_min"] = (B * s.clip_seconds / 3600.0) / (
            steady / 60.0)
    # the engines round differently, so pixels near a LUT bin edge may
    # land one colormap entry apart; never further
    def channel_diff(a, b):
        ch = lambda w: jnp.stack([(w >> (8 * k)) & 0xFF      # noqa: E731
                                  for k in range(3)]).astype(jnp.int32)
        return jnp.max(jnp.abs(ch(a) - ch(b))), jnp.mean(a != b)

    diff, share = jax.jit(channel_diff)(outs["dense_dft_highest"],
                                        outs["rfft"])
    lut = get_lut("jet").astype(np.int32)
    lut_step = int(np.abs(np.diff(lut, axis=0)).max())
    info["pixels_differing_between_engines"] = float(share)
    checks = [check("max_rgb_byte_diff_between_engines", int(diff),
                    lut_step)]
    return {"cold_s": cold_total, "steady_s": steady_total,
            "checks": checks, **info}


def phase_detect(ctx):
    import jax
    import numpy as np
    from spectral_tpu import cli
    from spectral_tpu.api.session import AnalysisSession
    from spectral_tpu.config import SpecConfig, ViewSettings
    from spectral_tpu.io.wav import write_wav
    from spectral_tpu.models import hmm, hmm_pscan
    from spectral_tpu.models.detector import BurstDetector
    s = ctx.sizes
    fs = 1000.0
    wav = os.path.join(ctx.work, "eeg.wav")
    write_wav(wav, bursty(fs, s.eeg_seconds, ctx.seed) * 0.5, fs)
    cfg = SpecConfig.north_star(256, 96, log_scale=True)
    rois = [(10.0, 15.0), (30.0, 38.0)]

    def run(device):
        sess = AnalysisSession(detector=BurstDetector(device=device),
                               warm_detection=False)
        names = sess.load(wav)
        sess.plot_sweeps(names[:1], cfg, ViewSettings())
        unsup = sess.unsupervised_detect()
        learned = sess.learn_and_detect(rois)
        return unsup, learned, cfg.hop_ / fs

    (dev_u, dev_l, dt), cold, steady = _timed(lambda: run("default"))
    cpu_u, cpu_l, _ = run("cpu")
    rc = cli.main(["detect", wav, "--nperseg", "256", "--hop", "96"])

    def frames_apart(a, b):
        if len(a) != len(b):
            return float("inf")
        return max([0.0] + [max(abs(p - q), abs(r - u)) / dt
                            for (p, r), (q, u) in zip(a, b)])

    checks = [check("cli_detect_rc", rc, 0),
              check("unsupervised_events_frames_apart_vs_cpu",
                    frames_apart(dev_u, cpu_u), 0),
              check("learned_events_frames_apart_vs_cpu",
                    frames_apart(dev_l, cpu_l), 0),
              check("unsupervised_event_count", len(dev_u), 1, kind="min")]

    # the parallel-prefix engine at hour scale: the same fit and decode on
    # the device and on the host CPU
    T = s.pscan_frames
    rng = np.random.default_rng(ctx.seed)
    burst = (np.sin(np.arange(T) * 2 * np.pi / 4096.0) > 0.7)
    feats = np.stack([rng.standard_normal(T) + 3.0 * burst,
                      rng.standard_normal(T)], axis=1).astype(np.float32)
    p0 = hmm.init_params(feats[:4096].astype(np.float64), 4, seed=42)
    fit5 = jax.jit(lambda p, v: hmm_pscan.fit(p, v, n_iter=5, tol=-1e30))
    vit = jax.jit(hmm_pscan.viterbi)
    t0 = time.perf_counter()
    p_dev, ll_dev, _ = _block(fit5(p0, feats))
    pscan_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    _block(fit5(p0, feats))
    pscan_fit_s = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        p_cpu, ll_cpu, _ = _block(fit5(p0, feats))
        st_cpu = np.asarray(vit(p_cpu, feats))
    st_dev = np.asarray(vit(jax.device_put(p_cpu, ctx.devices[0]), feats))
    mismatch = int((st_dev != st_cpu).sum())
    ll_dev, ll_cpu = float(ll_dev), float(ll_cpu)
    checks += [check("pscan_fit_loglik_rel_vs_cpu",
                     abs(ll_dev - ll_cpu) / abs(ll_cpu), 1e-4),
               check("pscan_viterbi_frames_differing_vs_cpu", mismatch,
                     1e-3 * T)]
    return {"cold_s": cold, "steady_s": steady, "checks": checks,
            "events_device": dev_u, "events_cpu": cpu_u,
            "pscan_frames": T, "pscan_cold_s": pscan_cold,
            "pscan_fit5_s": pscan_fit_s}


def phase_stream(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.core.stft import num_frames, power_spectrogram
    from spectral_tpu.parallel.streaming import ScanStreamer, scan_spectrogram
    s = ctx.sizes
    fs = s.stream_fs
    n = int(s.stream_seconds * fs)
    rng = np.random.default_rng(ctx.seed)
    x = rng.standard_normal((2, n), dtype=np.float32)
    x *= np.float32(0.1)
    t = np.arange(n, dtype=np.float32) / np.float32(fs)
    x[0] += np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    del t
    cfg = SpecConfig.north_star(1024, 256)
    hop = cfg.hop_
    chunk = max(-(-cfg.nperseg // hop) * hop,
                int(s.stream_chunk_seconds * fs) // hop * hop)
    block = chunk * s.stream_chunks_per_block
    streamer = ScanStreamer(fs, cfg, block, n, None,
                            lambda acc, psd, valid: (acc, psd),
                            jnp.zeros(()), batch=2)
    total = num_frames(n, cfg.nperseg, hop)

    def run():
        _, ys = streamer(x)                    # (nb, 2, fpb, F)
        flat = jnp.moveaxis(ys, 1, 0).reshape(2, -1, ys.shape[-1])
        return flat[:, streamer.skip:streamer.skip + total]

    psd, cold, steady = _timed(run, reps=min(s.reps, 3))
    dev = ctx.devices[0]
    stats = dev.memory_stats() or {}
    peak_after_stream = stats.get("peak_bytes_in_use")
    xp = jax.ShapeDtypeStruct((2, streamer.n_blocks, block), jnp.float32)
    mem = streamer._run.lower(xp, jnp.zeros(())).compile().memory_analysis()
    mono = jax.jit(lambda v: power_spectrogram(v, fs, cfg))(x)

    @jax.jit
    def agree(a, b):
        d = jnp.abs(a - b)
        return (jnp.all(d <= STREAM_ATOL + STREAM_RTOL * jnp.abs(b)),
                jnp.max(d / (jnp.abs(b) + 1e-30)))

    ok, rel = agree(psd, mono)
    rel = float(rel)
    del psd
    # the single-recording driver on one channel, against the same result
    mono0 = scan_spectrogram(x[0], fs, cfg, chunk,
                             chunks_per_block=s.stream_chunks_per_block)
    ok0, _ = agree(mono0, mono[0])
    checks = [check("stream_vs_monolithic_outside_tolerance",
                    float(not bool(ok)), 0),
              check("scan_spectrogram_vs_monolithic_outside_tolerance",
                    float(not bool(ok0)), 0)]
    return {"cold_s": cold, "steady_s": steady, "checks": checks,
            "frames": total, "channels": 2, "max_rel_diff": rel,
            "audio_h_per_min": (s.stream_seconds / 3600.0) / (steady / 60.0),
            "scan_program_temp_bytes": getattr(mem, "temp_size_in_bytes",
                                               None),
            "scan_program_output_bytes": getattr(mem, "output_size_in_bytes",
                                                 None),
            "peak_bytes_in_use_after_stream": peak_after_stream}


def phase_grid(ctx):
    import jax
    import numpy as np
    from spectral_tpu import cli
    from spectral_tpu.core.stft import power_spectrogram
    from spectral_tpu.io.wav import write_wav
    from spectral_tpu.parallel.sweep_grid import default_grid, sweep_grid
    s = ctx.sizes
    fs = s.clip_fs
    x = _clip(ctx, 1)
    cfgs = default_grid()
    grid = jax.jit(lambda v: sweep_grid(v, fs, cfgs))
    outs, cold, steady = _timed(lambda: grid(x), reps=s.reps)
    worst = 0.0
    for cfg, out in zip(cfgs, outs):
        ref = np.asarray(power_spectrogram(x, fs, cfg), np.float64)
        worst = max(worst, float(np.max(np.abs(np.asarray(out) - ref))
                                 / ref.max()))
    wav = os.path.join(ctx.work, "grid.wav")
    write_wav(wav, x, fs)
    rc = cli.main(["grid", wav, "-o", os.path.join(ctx.work, "grid.npz")])
    checks = [check("grid_max_rel_vs_power_spectrogram", worst,
                    PSD_REL_LIMIT),
              check("cli_grid_rc", rc, 0)]
    return {"cold_s": cold, "steady_s": steady, "checks": checks,
            "combos": len(cfgs)}


def _export_clips(ctx, count):
    import numpy as np
    s = ctx.sizes
    n = int(s.clip_seconds * s.clip_fs)
    rng = np.random.default_rng(ctx.seed + 7)
    pcm = (rng.standard_normal((count, n), dtype=np.float32)
           * 3000.0).astype(np.int16)          # raw 16-bit PCM, as decoded
    return [(f"clip{i:05d}", pcm[i]) for i in range(count)]


def phase_export(ctx):
    import jax
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.native import png_native
    from spectral_tpu.parallel.pipeline import export_spectrograms
    s = ctx.sizes
    fs = s.clip_fs
    n = int(s.clip_seconds * fs)
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    clips = _export_clips(ctx, s.export_clips)
    dirs = [os.path.join(ctx.work, f"export{i}") for i in range(2)]
    runs = iter(dirs)

    def run():
        return export_spectrograms(iter(clips), fs, cfg, next(runs),
                                   clip_samples=n, batch=s.export_batch,
                                   compress_level=1)

    st, cold, steady = _timed(run)
    shutil.rmtree(dirs[1], ignore_errors=True)
    sub = clips[:s.export_cpu_subset]
    cpu_dir = os.path.join(ctx.work, "export_cpu")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    try:
        export_spectrograms(iter(sub), fs, cfg, cpu_dir, clip_samples=n,
                            batch=min(s.export_batch, len(sub)),
                            compress_level=1)
    finally:
        jax.config.update("jax_default_device", None)
    names = [c[0] for c in sub]
    same, step = pixel_agreement(dirs[0], cpu_dir, names)
    # each platform's f32 rounding moves pixels that sit on a LUT bin edge;
    # the float64 oracle says whether the card's pixels are as right as the
    # CPU's
    dev_ok, cpu_ok = oracle_agreement(dirs[0], cpu_dir, sub, fs, cfg)
    encoder = ("native C++ (zlib)" if png_native.available()
               else "fallback (PIL or stdlib zlib)")
    checks = [check("pngs_written", st.pngs_written, s.export_clips,
                    kind="min"),
              check("max_lut_step_vs_cpu", step, 1),
              check("pixels_identical_share_vs_cpu", same, 0.999,
                    kind="min", gated=False),
              check("card_minus_cpu_share_matching_f64_oracle",
                    dev_ok - cpu_ok, -1e-3, kind="min")]
    return {"cold_s": cold, "steady_s": steady, "checks": checks,
            "png_encoder": encoder, "clips": st.clips,
            "card_share_matching_f64_oracle": dev_ok,
            "cpu_share_matching_f64_oracle": cpu_ok,
            "audio_h_per_min": (st.seconds_audio / 3600.0) / (steady / 60.0),
            "breakdown": st.breakdown()}


def phase_serve(ctx):
    from spectral_tpu import cli
    from spectral_tpu.io.wav import write_wav
    s = ctx.sizes
    fs = s.clip_fs
    eeg = os.path.join(ctx.work, "serve_eeg.wav")
    write_wav(eeg, bursty(1000.0, s.eeg_seconds, ctx.seed) * 0.5, 1000.0)
    clips = []
    for i in range(s.serve_clips):
        p = os.path.join(ctx.work, f"serve_clip{i}.wav")
        write_wav(p, _clip(ctx, 10 + i), fs)
        clips.append(p)
    reqs = [{"cmd": "detect", "files": [eeg],
             "config": {"nperseg": 256, "hop": 96, "window": "hann",
                        "detrend": "none"}},
            {"cmd": "render_batch", "files": clips,
             "out_dir": os.path.join(ctx.work, "serve_out"),
             "clip_seconds": s.clip_seconds},
            {"cmd": "shutdown"}]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()

    def run():
        stdin.seek(0)
        stdout.seek(0)
        stdout.truncate()
        return cli._serve(stdin, stdout)

    rc, cold, steady = _timed(run)
    resp = [json.loads(ln) for ln in stdout.getvalue().splitlines()]
    ok = [bool(r.get("ok")) for r in resp]
    written = resp[1].get("written", 0) if len(resp) > 1 else 0
    checks = [check("serve_rc", rc, 0),
              check("responses_not_ok", ok.count(False) + 3 - len(ok), 0),
              check("render_batch_written", written, s.serve_clips,
                    kind="min")]
    return {"cold_s": cold, "steady_s": steady, "checks": checks,
            "detect_events": resp[0].get("events") if resp else None}


def phase_entry(ctx):
    import jax
    import numpy as np
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out, cold, steady = _timed(lambda: jax.jit(fn)(*args))
    finite = all(np.isfinite(np.asarray(v)).all() for k, v in out.items()
                 if k in ("psd", "image"))
    t0 = time.perf_counter()
    ge.dryrun_multichip(1)
    dry_s = time.perf_counter() - t0
    return {"cold_s": cold, "steady_s": steady,
            "checks": [check("entry_outputs_not_finite", float(not finite),
                             0)],
            "dryrun_multichip_1_s": dry_s}


# ---------------------------------------------------------------------------
# Four-card phases: each against its one-card result
# ---------------------------------------------------------------------------

def _mesh(ctx):
    import numpy as np
    from jax.sharding import Mesh
    if len(ctx.devices) < 4:
        raise RuntimeError(f"--four needs 4 devices, have "
                           f"{len(ctx.devices)}")
    return Mesh(np.array(ctx.devices[:4]), ("data",))


def _on_devices(arr) -> int:
    return len({sh.device for sh in arr.addressable_shards})


def phase_four_export(ctx):
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.parallel.pipeline import export_spectrograms
    s = ctx.sizes
    fs = s.clip_fs
    n = int(s.clip_seconds * fs)
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    clips = _export_clips(ctx, s.four_clips)
    mesh = _mesh(ctx)
    sh_dir = os.path.join(ctx.work, "four_sharded")
    st, cold, _ = _timed(lambda: export_spectrograms(
        iter(clips), fs, cfg, sh_dir, clip_samples=n, batch=s.four_batch,
        mesh=mesh, compress_level=1))
    # one card at each shard's per-program shape (batch/4 clips)
    one_dir = os.path.join(ctx.work, "four_one_card")
    t0 = time.perf_counter()
    st1 = export_spectrograms(iter(clips), fs, cfg, one_dir,
                              clip_samples=n, batch=s.four_batch // 4,
                              compress_level=1)
    one_s = time.perf_counter() - t0
    same, step = pixel_agreement(sh_dir, one_dir, [c[0] for c in clips])
    checks = [check("pngs_written", st.pngs_written, s.four_clips,
                    kind="min"),
              check("output_devices", st.devices, 4, kind="min"),
              check("pixels_identical_share_vs_one_card", same, 0.999,
                    kind="min"),
              check("max_lut_step_vs_one_card", step, 1)]
    return {"cold_s": cold, "steady_s": None, "checks": checks,
            "sharded_audio_h_per_min": (st.seconds_audio / 3600.0)
            / (cold / 60.0),
            "one_card_audio_h_per_min": (st1.seconds_audio / 3600.0)
            / (one_s / 60.0),
            "breakdown": st.breakdown()}


def phase_four_share_max(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.parallel.sharding import (batched_spectrogram_fn,
                                                shard_pipeline)
    s = ctx.sizes
    fs = s.clip_fs
    n = int(s.clip_seconds * fs)
    B = s.four_batch
    cfg = SpecConfig.north_star(1024, 256, log_scale=True)
    xb = np.asarray(jax.random.normal(jax.random.PRNGKey(ctx.seed), (B, n),
                                      jnp.float32))
    pipe = shard_pipeline(_mesh(ctx), fs, cfg, share_max=True)
    out, cold, steady = _timed(lambda: pipe(xb)["image"], reps=s.reps)
    one = jax.jit(lambda v: batched_spectrogram_fn(
        fs, cfg, share_max=True)(v)["image"])(
            jax.device_put(xb, ctx.devices[0]))
    diff = float(np.max(np.abs(np.asarray(out) - np.asarray(one))))
    return {"cold_s": cold, "steady_s": steady,
            "checks": [check("image_max_abs_diff_vs_one_card", diff, 1e-5),
                       check("output_devices", _on_devices(out), 4,
                             kind="min")]}


def phase_four_stream(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spectral_tpu.config import SpecConfig
    from spectral_tpu.core.stft import power_spectrogram
    from spectral_tpu.parallel.streaming import scan_spectrogram
    s = ctx.sizes
    fs = s.stream_fs
    n = int(s.stream_seconds * fs)
    rng = np.random.default_rng(ctx.seed)
    x = rng.standard_normal(n, dtype=np.float32) * np.float32(0.1)
    cfg = SpecConfig.north_star(1024, 256)
    hop = cfg.hop_
    chunk = max(-(-cfg.nperseg // hop) * hop,
                int(s.stream_chunk_seconds * fs) // hop * hop)
    mesh = _mesh(ctx)
    psd, cold, steady = _timed(lambda: scan_spectrogram(
        x, fs, cfg, chunk, mesh=mesh), reps=min(s.reps, 3))
    devices = _on_devices(psd)
    mono = power_spectrogram(jax.device_put(x, ctx.devices[0]), fs, cfg,
                             use_matmul=True)
    a = np.asarray(psd)
    b = np.asarray(mono)
    bad = int(np.sum(np.abs(a - b) > STREAM_ATOL + STREAM_RTOL * np.abs(b)))
    return {"cold_s": cold, "steady_s": steady,
            "checks": [check("elements_outside_tolerance_vs_one_card", bad,
                             0),
                       check("output_devices", devices, 4, kind="min")],
            "frames": int(b.shape[0])}


def phase_four_em(ctx):
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from spectral_tpu.models import hmm
    from spectral_tpu.parallel import distributed_em
    s = ctx.sizes
    rng = np.random.default_rng(ctx.seed)
    B, T = 64, 4096
    burst = (np.sin(np.arange(T) * 2 * np.pi / 512.0) > 0.7)
    feats = np.stack([rng.standard_normal((B, T)) + 3.0 * burst,
                      rng.standard_normal((B, T))], axis=-1).astype(
                          np.float32)
    p0 = hmm.init_params(feats.reshape(-1, 2)[:8192].astype(np.float64), 4,
                         seed=42)

    def steps(mesh, k=3):
        step = distributed_em.make_sharded_em_step(mesh, "data")
        p = jax.device_put(p0, NamedSharding(mesh, P()))
        xs = jax.device_put(feats, NamedSharding(mesh, P("data")))
        lls = []
        for _ in range(k):
            p, ll = step(p, xs)
            lls.append(float(ll))
        return lls, xs

    t0 = time.perf_counter()
    ll4, xs = steps(_mesh(ctx))
    cold = time.perf_counter() - t0
    ll1, _ = steps(Mesh(np.array(ctx.devices[:1]), ("data",)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(ll4, ll1))
    return {"cold_s": cold, "steady_s": None,
            "checks": [check("step_loglik_rel_vs_one_device", rel, 1e-5),
                       check("input_devices", _on_devices(xs), 4,
                             kind="min")],
            "loglik_four": ll4, "loglik_one": ll1}


PHASES = {name: globals()[f"phase_{name}"]
          for name in ONE_CARD_PHASES + FOUR_CARD_PHASES}


def run_phase(name, ctx, card):
    """Run one phase; returns its JSON-able line (never raises)."""
    kind = ctx.devices[0].device_kind
    line = {"phase": name, "card": card, "device_kind": kind}
    try:
        # library and CLI chatter goes to stderr: stdout holds only the
        # phase lines and the result line
        with contextlib.redirect_stdout(sys.stderr):
            res = PHASES[name](ctx)
        checks = res.pop("checks")
        line.update(res)
        line["checks"] = checks
        line["ok"] = all(c["ok"] for c in checks if c["gated"])
    except Exception as e:      # a failed phase is reported, not hidden
        traceback.print_exc(file=sys.stderr)
        line.update(ok=False, error=f"{type(e).__name__}: {e}")
    if name.startswith("four_"):
        line["devices_peak_bytes"] = [
            (d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in ctx.devices[:4]]
    return line


class _CompileCounter:
    """Persistent-cache hits/writes and backend compile seconds, from
    JAX's monitoring events."""

    def __init__(self):
        import jax
        self.hits = self.writes = 0
        self.compile_s = 0.0
        jax.monitoring.register_event_listener(self._event)
        jax.monitoring.register_event_duration_secs_listener(self._duration)

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.writes += 1

    def _duration(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration


def _json_default(o):
    import numpy as np
    return o.item() if isinstance(o, np.generic) else str(o)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "spectral_tpu")):
        print("chip_smoke: the spectral_tpu repository is not beside this "
              "script", file=sys.stderr)
        return 2
    from spectral_tpu.utils.cache import (compilation_cache_dir,
                                          enable_compilation_cache)
    from spectral_tpu.utils.gpu import card_identity, require_gpu
    try:
        devices = require_gpu()
        card = card_identity()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    counter = _CompileCounter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    ctx = Ctx(FULL, args.seed, work, devices)
    ok = True
    t_start = time.perf_counter()
    try:
        for name in phases_for(args.four):
            line = run_phase(name, ctx, card)
            ok &= line["ok"]
            print(json.dumps(line, default=_json_default), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"summary": "chip_smoke", "card": card,
                      "device_kind": devices[0].device_kind,
                      "ok": bool(ok),
                      "wall_s": time.perf_counter() - t_start,
                      "backend_compile_s": counter.compile_s,
                      "cache_dir": compilation_cache_dir(),
                      "cache_hits": counter.hits,
                      "cache_writes": counter.writes}), flush=True)
    if not ok:
        return 1
    print(json.dumps(last_line(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
