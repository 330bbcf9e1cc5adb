"""Long-session soak: randomized GUI-shaped workload in ONE process.

Drives the headless session the way a long interactive sitting would —
plot (varying nperseg/band/log), detect, learn from ROIs, band powers,
CSV/PNG export, clear, reset — for N iterations, sampling RSS along the
way. Guards the lifecycle properties unit tests cannot: bounded jit/PSD
caches (api/session._plot_program lru 64, psd cache 64 MB cap), no
figure/artifact accumulation, no handle leaks.

Usage: python tools/soak.py [iters] [--fixed] [--cap MB]
Runs on JAX's default device.
--fixed pins one config/signal (no new jit shapes after warmup), which
separates a genuine object leak from JAX's by-design per-shape
executable caching (every new (config, length) pair compiles and caches
a new program for the life of the process). Measured on the CPU backend:
random mode grows 445 -> 915 MB over 400 iters (cache growth), --fixed
stays at +0.0%.
--cap MB sets SPECTRAL_TPU_MAX_RSS_MB (the utils/memory.py backstop the
session plot path honors) and asserts RSS stays under ~cap+headroom.
Exit 1 = --fixed grew >25% after warmup (real leak), or --cap exceeded.
"""

from __future__ import annotations

import os
import random
import sys
import tempfile


def main() -> int:
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    cap = 0.0
    if "--cap" in sys.argv:
        cap = float(sys.argv[sys.argv.index("--cap") + 1])
        os.environ["SPECTRAL_TPU_MAX_RSS_MB"] = str(cap)
    import numpy as np

    from spectral_tpu.utils.memory import rss_mb

    from spectral_tpu.api.session import AnalysisSession
    from spectral_tpu.config import SpecConfig, ViewSettings
    from spectral_tpu.io.registry import SweepEntry

    fixed = "--fixed" in sys.argv
    rng = random.Random(0)
    nprng = np.random.RandomState(0)
    fs = 1000.0

    s = AnalysisSession(warm_detection=False)
    for i in range(3):
        n = int(fs * (60 if fixed else rng.choice([20, 45, 60])))
        t = np.arange(n) / fs
        x = 0.02 * nprng.randn(n)
        for a, b in [(5, 9), (12, 17)]:
            m = (t >= a) & (t < b)
            x[m] += 0.6 * np.hanning(m.sum()) * np.sin(2 * np.pi * 6 * t[m])
        s.registry.register(f"soak_sweep{i}", SweepEntry(
            "soak", i, fs, fs, x.astype(np.float32), None))

    tmp = tempfile.mkdtemp(prefix="soak_")
    npersegs = [256, 512, 1024, 2048]
    samples = []
    plotted = False
    for it in range(iters):
        act = rng.choice(["plot", "plot", "plot", "detect", "learn",
                          "bands", "csv", "png", "clear", "reset"])
        try:
            if act == "plot":
                cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0,
                                               log_scale=True) if fixed \
                    else SpecConfig.scipy_default(
                        rng.choice(npersegs),
                        fmin=rng.choice([None, 0.0]),
                        fmax=rng.choice([None, 30.0, 80.0]),
                        log_scale=rng.random() < 0.5)
                names = [f"soak_sweep{rng.randrange(3)}"]
                s.plot_sweeps(names, cfg, ViewSettings())
                plotted = True
            elif act == "detect" and plotted:
                s.unsupervised_detect()
            elif act == "learn" and plotted:
                s.learn_and_detect([(4.5, 9.5), (11.5, 17.5)])
            elif act == "bands" and plotted:
                s.calculate_band_powers()
            elif act == "csv" and plotted and s.last_detected_events:
                s.export_csv(os.path.join(tmp, "e.csv"))
            elif act == "png" and plotted:
                s.export_png(os.path.join(tmp, "s.png"))
            elif act == "clear":
                s.clear()
                plotted = False
            elif act == "reset":
                s.reset_model()
        except ValueError:
            pass  # domain refusals (empty band etc.) are fine
        if it % 10 == 0:
            samples.append(rss_mb())
            print(f"iter {it:4d} act={act:6s} rss={samples[-1]:8.1f} MB",
                  flush=True)

    # warmup = first quarter (compiles); growth measured after it
    q = max(1, len(samples) // 4)
    warm, tail = samples[q], samples[-1]
    growth = (tail - warm) / warm
    print(f"RSS after warmup {warm:.1f} MB -> final {tail:.1f} MB "
          f"({100 * growth:+.1f}%)")
    if cap:
        if tail > cap * 1.3:   # headroom: trims fire between samples
            print(f"FAIL: cap {cap:.0f} MB not honored")
            return 1
        print(f"soak OK (capped at {cap:.0f} MB)")
        return 0
    if "--fixed" in sys.argv:
        if growth > 0.25:
            print("FAIL: memory grew with NO new jit shapes — object leak")
            return 1
        print("soak OK (fixed shapes, flat memory)")
        return 0
    print("soak done (random mode is informational: growth here is JAX's "
          "per-shape executable caching; bound it with --cap / "
          "SPECTRAL_TPU_MAX_RSS_MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
