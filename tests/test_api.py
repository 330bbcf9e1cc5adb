"""API-layer tests: session flows, exporters, persistence, CLI."""

import csv
import os

import numpy as np
import pytest
import jax.numpy as jnp

from spectral_tpu.api.session import AnalysisSession
from spectral_tpu.config import SpecConfig, ViewSettings
from spectral_tpu.io.registry import SweepRegistry, SweepEntry
from spectral_tpu.io.wav import write_wav
from spectral_tpu.render.png import decode_png


def _bursty(fs=1000.0, dur=60.0, bursts=((10, 15), (30, 38)), seed=0):
    rng = np.random.RandomState(seed)
    n = int(fs * dur)
    t = np.arange(n) / fs
    x = 0.02 * rng.randn(n)
    for a, b in bursts:
        m = (t >= a) & (t < b)
        x[m] += 0.6 * np.hanning(m.sum()) * np.sin(2 * np.pi * 6.0 * t[m])
    return x.astype(np.float32)


def _session_with_sweeps(n_sweeps=2, fs=1000.0, dur=30.0):
    s = AnalysisSession()
    for i in range(n_sweeps):
        x = _bursty(fs=fs, dur=dur, bursts=((5, 9),), seed=i)
        s.registry.register(f"rec_sweep{i}", SweepEntry(
            filepath="rec.h5", sweep_idx=i, fs=fs, fs_raw=fs,
            raw=x, processed=x * 0.5))
    return s


def test_plot_single_sweep_and_analytics():
    s = _session_with_sweeps()
    res = s.plot_sweeps(["rec_sweep0"], SpecConfig.scipy_default(
        512, fmin=0.0, fmax=30.0), ViewSettings())
    assert res is not None
    assert res.f.max() <= 30.0
    assert s.last_sxx is not None and s.last_image is not None
    assert res.image.min() >= 0 and res.image.max() <= 1
    assert s.calculate_absolute_power() == pytest.approx(res.total_power)
    bp = s.calculate_band_powers()
    assert abs(sum(bp.values()) - 1.0) < 0.05  # masked to 0-30 Hz


def test_combine_builds_segment_map_and_prefers_processed():
    s = _session_with_sweeps(3, dur=10.0)
    s.plot_sweeps([f"rec_sweep{i}" for i in range(3)],
                  SpecConfig.scipy_default(512),
                  ViewSettings(combine=True, mode_proc="Spectrogram"))
    assert len(s.segment_map) == 3
    assert s.segment_map[1].start_time_combined == pytest.approx(10.0)
    assert s.segment_map[2].end_time_combined == pytest.approx(30.0)
    # combined source is the processed (scaled 0.5) signal
    assert np.abs(s.spec_data_source).max() < 0.5


def test_mixed_fs_rejected():
    s = _session_with_sweeps(1, fs=1000.0)
    x = np.zeros(100, np.float32)
    s.registry.register("other_sweep0", SweepEntry(
        filepath="o", sweep_idx=0, fs=2000.0, fs_raw=2000.0, raw=x,
        processed=None))
    with pytest.raises(ValueError, match="Mixed sampling rates"):
        s.plot_sweeps(["rec_sweep0", "other_sweep0"],
                      SpecConfig.scipy_default(256), ViewSettings(combine=True))


def test_detect_and_csv_export(tmp_path):
    s = _session_with_sweeps(1, dur=60.0)
    x = _bursty(dur=60.0)
    s.registry.data["rec_sweep0"].raw = x
    s.registry.data["rec_sweep0"].processed = None
    s.plot_sweeps(["rec_sweep0"], SpecConfig.scipy_default(
        1024, fmin=0.0, fmax=30.0), ViewSettings())
    events = s.unsupervised_detect()
    assert len(events) == 2

    p = str(tmp_path / "bursts.csv")
    msg = s.export_csv(p)
    assert "Successfully exported 2 events" in msg
    with open(p) as fh:
        rows = list(csv.reader(fh))
    assert rows[0] == ["Burst ID", "Source File", "Sweep",
                       "Start Time (s)", "End Time (s)",
                       "Inter Burst Interval (s)"]
    assert rows[1][1] == "rec" and rows[1][2] == "0"
    assert rows[1][5] == "nan"  # first IBI is NaN
    ibi = float(rows[2][5])
    assert ibi == pytest.approx(float(rows[2][3]) - float(rows[1][4]))


def test_csv_combined_attribution(tmp_path):
    s = _session_with_sweeps(2, dur=30.0)
    s.plot_sweeps(["rec_sweep0", "rec_sweep1"],
                  SpecConfig.scipy_default(512),
                  ViewSettings(combine=True))
    # events: one in sweep0's window, one in sweep1's (offset 30 s)
    s.last_detected_events = [(5.0, 9.0), (35.0, 39.0)]
    p = str(tmp_path / "c.csv")
    s.export_csv(p)
    with open(p) as fh:
        rows = list(csv.reader(fh))[1:]
    assert rows[0][2] == "0" and rows[1][2] == "1"


def test_csv_no_events(tmp_path):
    s = _session_with_sweeps(1)
    s.plot_sweeps(["rec_sweep0"], SpecConfig.scipy_default(512), ViewSettings())
    msg = s.export_csv(str(tmp_path / "x.csv"))
    assert msg.startswith("Error: No burst data")


def test_png_export_roundtrip(tmp_path):
    s = _session_with_sweeps(1)
    s.plot_sweeps(["rec_sweep0"],
                  SpecConfig.scipy_default(512, fmin=0.0, fmax=100.0,
                                           log_scale=True),
                  ViewSettings())
    p = str(tmp_path / "spec.png")
    msg = s.export_png(p)
    assert "Successfully" in msg
    img = decode_png(p)
    F, T = s.last_image.shape
    assert img.shape == (F, T, 4)


def test_roi_ops_and_learn(tmp_path):
    s = _session_with_sweeps(1, dur=60.0)
    x = _bursty(dur=60.0)
    s.registry.data["rec_sweep0"].raw = x
    s.registry.data["rec_sweep0"].processed = None
    s.plot_sweeps(["rec_sweep0"], SpecConfig.scipy_default(
        1024, fmin=0.0, fmax=30.0), ViewSettings())
    s.add_roi(17.0, 8.0)   # endpoints get sorted
    s.add_roi(28.0, 40.0)
    assert s.rois == [(8.0, 17.0), (28.0, 40.0)]
    s.add_roi(50.0, 50.0)  # below min width -> dropped
    assert len(s.rois) == 2
    events = s.learn_and_detect()
    assert s.detector.is_model_refined and len(events) >= 2
    s.delete_roi((8.0, 17.0))
    assert s.rois == [(28.0, 40.0)]


def test_state_persistence_roundtrip(tmp_path):
    s = _session_with_sweeps(1, dur=60.0)
    x = _bursty(dur=60.0)
    s.registry.data["rec_sweep0"].raw = x
    s.registry.data["rec_sweep0"].processed = None
    cfg = SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0)
    s.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())
    s.unsupervised_detect()
    p = str(tmp_path / "state.npz")
    s.save_state(p)

    s2 = AnalysisSession()
    s2.load_state(p)
    assert s2.config == cfg
    assert s2.last_detected_events == s.last_detected_events
    assert s2.detector.params is not None
    np.testing.assert_array_equal(np.asarray(s2.detector.params.means),
                                  np.asarray(s.detector.params.means))


def test_state_roundtrip_keeps_csv_attribution(tmp_path):
    """save_state carries the provenance context (segment map + plotted
    items), so a CSV export after load_state in a FRESH session keeps the
    combined-plot source attribution (ExportManager.py:55-64) instead of
    degrading to 'Unknown'."""
    from spectral_tpu.api.export import export_events_csv
    s = _session_with_sweeps(2, dur=60.0)
    x = _bursty(dur=60.0)
    for name in ("rec_sweep0", "rec_sweep1"):
        s.registry.data[name].raw = x
        s.registry.data[name].processed = None
    s.plot_sweeps(["rec_sweep0", "rec_sweep1"],
                  SpecConfig.scipy_default(1024, fmin=0.0, fmax=30.0),
                  ViewSettings(combine=True))
    s.unsupervised_detect()
    assert s.last_detected_events
    p = str(tmp_path / "state.npz")
    s.save_state(p)

    s2 = AnalysisSession()
    s2.load_state(p)
    assert [r.source_name for r in s2.segment_map] == \
        [r.source_name for r in s.segment_map]
    c1, c2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert "Successfully" in export_events_csv(c1, s)
    assert "Successfully" in export_events_csv(c2, s2)
    assert open(c1).read() == open(c2).read()
    assert "Unknown" not in open(c2).read()


def test_empty_selection_raises():
    s = _session_with_sweeps(1)
    with pytest.raises(ValueError, match="no sweeps selected"):
        s.plot_sweeps([], SpecConfig.scipy_default(256), ViewSettings())


# ---- CLI -------------------------------------------------------------------

def test_cli_render_and_detect(tmp_path):
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "sig.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=60.0) * 0.5, fs)

    out_png = str(tmp_path / "o.png")
    assert main(["render", wav_path, "-o", out_png, "--nperseg", "512",
                 "--log"]) == 0
    assert os.path.exists(out_png)

    csv_path = str(tmp_path / "o.csv")
    assert main(["detect", wav_path, "--scipy-compat", "--nperseg", "1024",
                 "--fmin", "0", "--fmax", "30", "--csv", csv_path]) == 0
    assert os.path.exists(csv_path)


def test_cli_info_and_batch(tmp_path, capsys):
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "sig.wav")
    write_wav(wav_path, np.sin(np.linspace(0, 60, 6000)).astype(np.float32), fs)
    assert main(["info", wav_path]) == 0
    out = capsys.readouterr().out
    assert "sig_sweep0" in out and "fs=1000" in out

    # out dir is created on demand (no pre-existing-dir requirement)
    out_dir = str(tmp_path / "batch" / "nested")
    assert main(["export-batch", wav_path, "-o", out_dir]) == 0
    assert os.path.exists(os.path.join(out_dir, "sig_sweep0.png"))

    # the reference's fixed 0-300 s x-window is the DEFAULT
    # (ExportManager.py:178): a 6 s signal occupies the left 2% of the
    # width, the rest stays background
    from spectral_tpu.render.png import decode_png
    img = np.asarray(decode_png(os.path.join(out_dir, "sig_sweep0.png")))
    ink = (img[..., :3].min(axis=-1) < 250).any(axis=0)
    assert ink[: img.shape[1] // 50].any()          # signal at the left edge
    assert not ink[int(img.shape[1] * 0.05):].any()  # empty past 6/300

    # opt-out: --window-seconds 0 sizes the axis to the signal
    out_dir2 = str(tmp_path / "batch_fit")
    assert main(["export-batch", wav_path, "-o", out_dir2,
                 "--window-seconds", "0"]) == 0
    img2 = np.asarray(decode_png(os.path.join(out_dir2, "sig_sweep0.png")))
    ink2 = (img2[..., :3].min(axis=-1) < 250).any(axis=0)
    # fills most of the width (envelope rasterizer maps whole samples per
    # column, so 6000 samples / 3600 cols -> 2/col -> 3000 used columns)
    assert ink2[int(img2.shape[1] * 0.75):].any()


def test_cli_info_zero_sweep_file_says_so(tmp_path, capsys):
    """A parseable file yielding no loadable sweeps (here: an HDF5 NIX
    layout with no groups level and no fs attrs) must print an explicit
    '0 sweeps' line, not silence."""
    h5py = pytest.importorskip("h5py")
    from spectral_tpu.cli import main
    p = str(tmp_path / "empty.h5")
    with h5py.File(p, "w") as f:
        f.create_group("data/blk/data_arrays")
    assert main(["info", p]) == 0
    out = capsys.readouterr().out
    assert f"{p}: 0 sweeps" in out


def test_gui_graceful_without_qt(capsys):
    from spectral_tpu.cli import main
    # PyQt5 absent in this image: the gui subcommand must fail helpfully
    try:
        import PyQt5  # noqa: F401
        pytest.skip("PyQt5 present; GUI would actually launch")
    except ImportError:
        pass
    assert main(["gui"]) == 2


def test_spectrogram_source_selection_precedence():
    """PROC wins over RAW for the spectrogram source (PlotEngine.py:95-99)."""
    s = _session_with_sweeps(1)
    # both request spectrogram: processed (0.5x amplitude) must win
    s.plot_sweeps(["rec_sweep0"], SpecConfig.scipy_default(512),
                  ViewSettings(mode_raw="Spectrogram", mode_proc="Spectrogram"))
    assert np.abs(s.spec_data_source).max() < 0.5
    # only raw requests a spectrogram -> raw drives it
    s.plot_sweeps(["rec_sweep0"], SpecConfig.scipy_default(512),
                  ViewSettings(mode_raw="Both", mode_proc="Signal"))
    assert np.abs(s.spec_data_source).max() > 0.3


def test_export_batch_shared_symmetric_ylim(tmp_path):
    """Two-pass global max-amplitude scaling (ExportManager.py:126-144,:179):
    under the shared y-limit, a half-amplitude signal's waveform spans half
    the rows of the full-amplitude one."""
    from spectral_tpu.api.export import export_batch_signals_png
    r = SweepRegistry()
    loud = np.sin(np.linspace(0, 40 * np.pi, 4000)).astype(np.float32)
    r.register("a_sweep0", SweepEntry("f", 0, 100.0, 100.0, loud, None))
    r.register("b_sweep0", SweepEntry("f", 1, 100.0, 100.0,
                                      loud * 0.5, None))
    msg = export_batch_signals_png(str(tmp_path), r,
                                   ["a_sweep0", "b_sweep0"],
                                   height=200, width=400)
    assert "Exported 2" in msg
    a = decode_png(str(tmp_path / "a_sweep0.png"))
    b = decode_png(str(tmp_path / "b_sweep0.png"))
    rows_a = np.where((a[..., 3] == 255).any(axis=1))[0]
    rows_b = np.where((b[..., 3] == 255).any(axis=1))[0]
    extent_a = rows_a.max() - rows_a.min()
    extent_b = rows_b.max() - rows_b.min()
    assert 0.4 < extent_b / extent_a < 0.6  # half the vertical span


def test_export_batch_raw_without_fs_raw_is_skipped(tmp_path):
    """The reference reads entry["fs_raw"] directly in the batch exporter
    (ExportManager.py:164) and skips the item when it is None (:168-169)
    — it does NOT fall back to the processed fs like get_signal does. A
    NIX sweep whose raw stream has no extractable rate must be skipped,
    not exported at the wrong rate."""
    from spectral_tpu.api.export import export_batch_signals_png
    r = SweepRegistry()
    x = np.sin(np.linspace(0, 40 * np.pi, 4000)).astype(np.float32)
    r.register("ok_sweep0", SweepEntry("f", 0, 100.0, 100.0, x, None))
    r.register("norate_sweep0", SweepEntry("f", 1, 100.0, None, x, None))
    msg = export_batch_signals_png(str(tmp_path), r,
                                   ["ok_sweep0", "norate_sweep0"],
                                   height=64, width=128)
    assert "Exported 1" in msg
    assert (tmp_path / "ok_sweep0.png").exists()
    assert not (tmp_path / "norate_sweep0.png").exists()


def test_cli_stream_npz_and_png(tmp_path):
    from spectral_tpu.cli import main
    from spectral_tpu.core.stft import power_spectrogram
    fs = 1000.0
    wav_path = str(tmp_path / "long.wav")
    x = _bursty(fs=fs, dur=30.0)
    write_wav(wav_path, x * 0.5, fs)

    npz_path = str(tmp_path / "psd.npz")
    assert main(["stream", wav_path, "-o", npz_path, "--nperseg", "512",
                 "--hop", "128", "--chunk-seconds", "5"]) == 0
    z = np.load(npz_path)
    assert z["fs"] == fs and z["psd"].shape[1] == 257
    # streamed equals monolithic over the decoded (quantized) samples
    sig, _ = __import__("spectral_tpu.io.wav", fromlist=["read_wav"]
                        ).read_wav(wav_path)
    ref = np.asarray(power_spectrogram(
        jnp.asarray(sig), fs, SpecConfig.north_star(512, 128)))
    np.testing.assert_allclose(z["psd"], ref, rtol=1e-4, atol=1e-9)

    png_path = str(tmp_path / "psd.png")
    assert main(["stream", wav_path, "-o", png_path, "--nperseg", "512",
                 "--hop", "128", "--chunk-seconds", "5"]) == 0
    img = decode_png(png_path)
    assert img.shape == (257, z["psd"].shape[0], 4)

    # --scan: device-resident single-dispatch path, identical output
    scan_npz = str(tmp_path / "psd_scan.npz")
    assert main(["stream", wav_path, "-o", scan_npz, "--nperseg", "512",
                 "--hop", "128", "--chunk-seconds", "5", "--scan"]) == 0
    np.testing.assert_allclose(np.load(scan_npz)["psd"], z["psd"],
                               rtol=1e-5, atol=1e-10)

    # --scan --mesh: sample axis sharded over every (virtual) device with
    # the ppermute halo exchange; values match the plain scan
    mesh_npz = str(tmp_path / "psd_mesh.npz")
    assert main(["stream", wav_path, "-o", mesh_npz, "--nperseg", "512",
                 "--hop", "128", "--chunk-seconds", "5", "--scan",
                 "--mesh"]) == 0
    np.testing.assert_allclose(np.load(mesh_npz)["psd"], z["psd"],
                               rtol=1e-4, atol=1e-9)


def test_cli_export_specs(tmp_path, capsys):
    from spectral_tpu.cli import main
    fs = 8000.0
    paths = []
    for i in range(3):
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, np.sin(np.linspace(0, 60 * (i + 1), 8000))
                  .astype(np.float32) * 0.4, fs)
        paths.append(p)
    out = str(tmp_path / "specs")
    assert main(["export-specs", *paths, "-o", out, "--clip-seconds", "1",
                 "--nperseg", "256", "--hop", "64", "--log",
                 "--batch", "2"]) == 0
    assert sorted(os.listdir(out)) == ["c0.png", "c1.png", "c2.png"]
    assert "Exported 3" in capsys.readouterr().out
    # --stats-json: the ops artifact with the per-stage breakdown
    import json as _json
    sj = str(tmp_path / "stats.json")
    assert main(["export-specs", *paths, "-o", str(tmp_path / "s2"),
                 "--clip-seconds", "1", "--nperseg", "256", "--hop", "64",
                 "--stats-json", sj]) == 0
    rep = _json.load(open(sj))
    assert rep["pngs_written"] == 3 and rep["clips"] == 3
    assert "d2h_mb" in rep["breakdown"] and "wall_s" in rep["breakdown"]
    img = decode_png(os.path.join(out, "c0.png"))
    assert img.shape == (129, 122, 3)      # palette default decodes to RGB


def test_cli_export_specs_registry_formats(tmp_path, capsys):
    """export-specs over the reference's own formats (NIX-HDF5 here):
    one clip per sweep through registry_clip_source, processed-over-raw
    source rule, mixed-rate sweeps skipped under --on-error skip, and
    --resume skips finished sweep PNGs. PNG pixels must equal the same
    signals exported via WAV (the source layer must not touch values)."""
    pytest.importorskip("h5py")
    from spectral_tpu.cli import main
    from spectral_tpu.io.nix import write_nix_fixture
    fs = 8000.0
    rng = np.random.default_rng(5)
    sig0 = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    sig1 = (rng.standard_normal(8000) * 0.3).astype(np.float32)
    h5 = str(tmp_path / "rec.h5")
    write_nix_fixture(h5, [{"proc_a": sig0}, {"proc_b": sig1}], fs=fs)
    out = str(tmp_path / "specs")
    args = ["-o", out, "--clip-seconds", "1", "--nperseg", "256",
            "--hop", "64", "--log", "--batch", "2"]
    assert main(["export-specs", h5, *args]) == 0
    assert sorted(os.listdir(out)) == ["rec_sweep0.png", "rec_sweep1.png"]

    # value parity with the WAV source layer: an IEEE-float WAV carries
    # the identical f32 samples, so the PNGs must be byte-identical
    # (the source layer must not touch values)
    wav0 = tmp_path / "w0.wav"
    _write_float_wav(wav0, sig0, fs)
    out_w = str(tmp_path / "specs_w")
    assert main(["export-specs", str(wav0), "-o", out_w,
                 "--clip-seconds", "1", "--nperseg", "256", "--hop", "64",
                 "--log", "--batch", "2"]) == 0
    a = np.asarray(decode_png(os.path.join(out, "rec_sweep0.png")))
    b = np.asarray(decode_png(os.path.join(out_w, "w0.png")))
    np.testing.assert_array_equal(a, b)

    # mixed-rate file: the 4 kHz sweep skips under --on-error skip
    h5m = str(tmp_path / "mixed.h5")
    write_nix_fixture(h5m, [{"proc_a": sig0}], fs=fs)
    write_nix_fixture(str(tmp_path / "slow.h5"), [{"proc_s": sig1}],
                      fs=4000.0)
    out2 = str(tmp_path / "specs2")
    assert main(["export-specs", h5m, str(tmp_path / "slow.h5"),
                 "-o", out2, *args[2:], "--on-error", "skip"]) == 0
    assert os.listdir(out2) == ["mixed_sweep0.png"]
    # on_error=raise (the default): the rate mismatch aborts with a
    # clean domain-error exit (main wraps ValueError), not a traceback
    with pytest.raises(SystemExit) as ei:
        main(["export-specs", h5m, str(tmp_path / "slow.h5"),
              "-o", str(tmp_path / "specs3"), *args[2:]])
    assert "single-rate" in str(ei.value)

    # resume: everything already exported -> 0 new PNGs
    capsys.readouterr()
    assert main(["export-specs", h5, *args, "--resume"]) == 0
    out_txt = capsys.readouterr().out
    assert "Exported 0" in out_txt and "2 already existed" in out_txt

    # name collision across dataset files (rec.h5 + rec.abf would both
    # yield rec_sweep0): last write wins, but a warning SAYS so
    import logging
    from spectral_tpu.parallel.pipeline import registry_clip_source
    h5b = str(tmp_path / "sub")
    os.makedirs(h5b, exist_ok=True)
    h5b = os.path.join(h5b, "rec.h5")
    write_nix_fixture(h5b, [{"proc_a": sig1}], fs=fs)
    logger = logging.getLogger("spectral_tpu")
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    try:
        clips = list(registry_clip_source([h5, h5b], fs))
    finally:
        logger.removeHandler(handler)
    assert [n for n, _ in clips].count("rec_sweep0") == 2
    assert any("duplicate sweep name" in m for m in records)


def test_export_specs_survives_sigkill_and_resumes(tmp_path):
    """The restartable-export contract END TO END with a real SIGKILL:
    a dataset export killed mid-run leaves only VALID complete PNGs
    under final names (every .png decodes; at most in-flight .tmp
    residue, which atomicity cannot prevent under SIGKILL), and
    --resume sweeps the residue and finishes exactly the remainder."""
    import signal
    import subprocess
    import sys as _sys
    import time
    from spectral_tpu.render.png import decode_png
    fs = 4000.0
    rng = np.random.default_rng(0)
    paths = []
    for i in range(120):
        p = str(tmp_path / f"k{i:03d}.wav")
        write_wav(p, (rng.standard_normal(int(fs)) * 0.3)
                  .astype(np.float32), fs)
        paths.append(p)
    out = str(tmp_path / "specs")
    cmd = [_sys.executable, "-m", "spectral_tpu.cli", "--cpu",
           "export-specs", *paths, "-o", out, "--clip-seconds", "1",
           "--nperseg", "256", "--hop", "64", "--batch", "8",
           "--compress-level", "9"]
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    t0 = time.time()
    while time.time() - t0 < 120:
        done = [f for f in os.listdir(out)] if os.path.exists(out) else []
        if len([f for f in done if f.endswith(".png")]) >= 5:
            break
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    killed = proc.poll() is None
    if killed:
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    survivors = sorted(os.listdir(out))
    pngs = [f for f in survivors if f.endswith(".png")]
    if killed:      # the interesting case: mid-run interruption
        assert 0 < len(pngs) < 120
    # SIGKILL may strand ONE in-flight .tmp per encode worker (atomicity
    # only guarantees no truncated file under a FINAL name); any residue
    # must be .tmp-suffixed, and resume sweeps it (clean_stale_tmp)
    assert set(survivors) - set(pngs) <= {
        f for f in survivors if ".tmp." in f}
    for f in pngs:                                      # all decode
        img = np.asarray(decode_png(os.path.join(out, f)))
        assert img.shape[0] > 0
    # resume completes exactly the remainder and sweeps dead-pid residue
    n_before = len(pngs)
    r = subprocess.run(cmd + ["--resume"], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-500:]
    after = os.listdir(out)
    assert len([f for f in after if f.endswith(".png")]) == 120
    assert not [f for f in after if ".tmp." in f]       # residue swept
    assert f"resume: {n_before} already existed" in r.stdout \
        or n_before == 0


def test_cli_stream_bands(tmp_path, capsys):
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "long.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=30.0) * 0.5, fs)
    assert main(["stream", wav_path, "--bands", "--nperseg", "512",
                 "--hop", "128", "--chunk-seconds", "5"]) == 0
    out = capsys.readouterr().out
    assert "Theta" in out and "Total absolute power" in out
    import json as _json
    bp = _json.loads(out[:out.rindex("}") + 1])
    # the bursty fixture is 6 Hz bursts -> theta dominates
    assert bp["Theta (θ)"] > 0.5


def test_cli_stream_detect_matches_detect(tmp_path, capsys):
    """`stream --detect` (bounded-memory features + auto-engine HMM) must
    report the same events and CSV rows as the plot-based `detect`."""
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "long.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=60.0) * 0.5, fs)

    csv_a = str(tmp_path / "a.csv")
    assert main(["detect", wav_path, "--scipy-compat", "--fmin", "0",
                 "--fmax", "30", "--csv", csv_a]) == 0
    out_detect = [l for l in capsys.readouterr().out.splitlines()
                  if "\t" in l]

    csv_b = str(tmp_path / "b.csv")
    assert main(["stream", wav_path, "--detect", "--scipy-compat",
                 "--fmin", "0", "--fmax", "30", "--chunk-seconds", "5",
                 "--csv", csv_b]) == 0
    out_stream = [l for l in capsys.readouterr().out.splitlines()
                  if "\t" in l]
    assert out_stream == out_detect and len(out_detect) >= 1
    rows_a = open(csv_a).read().splitlines()
    rows_b = open(csv_b).read().splitlines()
    # same header and same (start, end, IBI) columns; source-file
    # attribution differs only by design (session display name vs file)
    assert rows_a[0] == rows_b[0]
    assert [r.split(",")[3:] for r in rows_a[1:]] == \
           [r.split(",")[3:] for r in rows_b[1:]]


def test_cli_stream_detect_requires_no_out(tmp_path, capsys):
    """--detect alone is a complete command (no -o needed), like --bands."""
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "s.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=30.0) * 0.5, fs)
    assert main(["stream", wav_path, "--detect", "--nperseg", "512",
                 "--hop", "128", "--chunk-seconds", "5", "--fmin", "0",
                 "--fmax", "30"]) == 0
    assert "\t" in capsys.readouterr().out


def test_cli_stream_channel_select(tmp_path, capsys):
    """--channel picks a sweep of a multi-channel file; out-of-range is a
    clear error (default 0 = the reference's channel heuristic)."""
    from spectral_tpu.cli import main
    fs = 1000.0
    rng = np.random.RandomState(0)
    quiet = (0.05 * rng.randn(int(fs * 20))).astype(np.float32)
    loud = _bursty(fs=fs, dur=20.0).astype(np.float32) * 0.5
    wav_path = str(tmp_path / "stereo.wav")
    write_wav(wav_path, np.stack([quiet, loud], axis=1), fs)

    assert main(["stream", wav_path, "--bands", "--nperseg", "512",
                 "--channel", "1", "--chunk-seconds", "5"]) == 0
    out = capsys.readouterr().out
    import json as _json
    bp = _json.loads(out[:out.rindex("}") + 1])
    assert bp["Theta (θ)"] > 0.5        # the bursty channel, not the quiet one

    with pytest.raises(SystemExit):
        main(["stream", wav_path, "--bands", "--channel", "2"])


def test_stream_band_powers_matches_monolithic():
    from spectral_tpu.parallel.streaming import stream_band_powers
    from spectral_tpu.core.stft import power_spectrogram, freq_axis
    from spectral_tpu.core import events as ev
    fs = 1000.0
    x = _bursty(fs=fs, dur=20.0).astype(np.float32)
    cfg = SpecConfig.scipy_default(512, fmin=0.0, fmax=120.0)
    got, total = stream_band_powers(x, fs, cfg, chunk_size=448 * 4,
                                    chunks_per_block=3)
    # monolithic reference: masked rows then band_powers (session flow)
    from spectral_tpu.core.stft import spectrogram as spec
    f, t, sxx = spec(jnp.asarray(x), fs, cfg)
    want = ev.band_powers(f, np.asarray(sxx))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    assert total == pytest.approx(float(np.asarray(sxx).sum()), rel=1e-4)


def test_cli_decorated_and_mel_render(tmp_path):
    pytest.importorskip("matplotlib")
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "sig.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=30.0) * 0.5, fs)

    deco = str(tmp_path / "deco.png")
    assert main(["render", wav_path, "-o", deco, "--decorated", "--log",
                 "--nperseg", "512", "--dpi", "72"]) == 0
    assert os.path.getsize(deco) > 5000

    mel = str(tmp_path / "mel.png")
    assert main(["render", wav_path, "-o", mel, "--mels", "24",
                 "--nperseg", "512", "--hop", "128", "--log"]) == 0
    assert decode_png(mel).shape[0] == 24

    # the reference's transparent export mode (ExportManager.py:92-111)
    trans = str(tmp_path / "trans.png")
    assert main(["render", wav_path, "-o", trans, "--decorated",
                 "--transparent", "--nperseg", "512", "--dpi", "72"]) == 0
    rgba = decode_png(trans)
    assert rgba.shape[-1] == 4 and (rgba[..., 3] == 0).any()  # alpha used
    # without --decorated the flag refuses (raw pixels have no background)
    with pytest.raises(SystemExit):
        main(["render", wav_path, "-o", trans, "--transparent",
              "--nperseg", "512"])


def test_cli_doctor(capsys):
    from spectral_tpu.cli import main
    assert main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "backend:" in out and "sanity:" in out and "all good" in out
    # --json: ONE machine-readable object, no human lines
    import json
    assert main(["doctor", "--json"]) == 0
    out = capsys.readouterr().out
    rep = json.loads(out)
    assert out.count("\n") == 1
    assert rep["ok"] and rep["sanity"] and rep["backend"]
    assert rep["backend"] == "cpu" and rep["n_devices"] >= 1


def test_cli_export_specs_on_error_skip(tmp_path, capsys):
    from spectral_tpu.cli import main
    fs = 8000.0
    good = str(tmp_path / "good.wav")
    write_wav(good, np.sin(np.linspace(0, 60, 8000)).astype(np.float32) * 0.4,
              fs)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as fh:
        fh.write(b"not a wav")
    out = str(tmp_path / "specs")
    assert main(["export-specs", good, bad, "-o", out, "--clip-seconds", "1",
                 "--nperseg", "256", "--hop", "64", "--on-error", "skip"]) == 0
    assert sorted(os.listdir(out)) == ["good.png"]
    assert "Exported 1" in capsys.readouterr().out


def test_cli_detect_each(tmp_path, capsys):
    from spectral_tpu.cli import main
    fs = 1000.0
    # one NPZ with two sweeps of different lengths + different burst spots
    import numpy as np
    a = _bursty(fs=fs, dur=60.0, bursts=((10, 15),), seed=1)
    b = _bursty(fs=fs, dur=40.0, bursts=((20, 26),), seed=2)
    w1 = str(tmp_path / "a.wav")
    w2 = str(tmp_path / "b.wav")
    write_wav(w1, a * 0.5, fs)
    write_wav(w2, b * 0.5, fs)
    csv_path = str(tmp_path / "each.csv")
    assert main(["detect", w1, w2, "--each", "--scipy-compat",
                 "--nperseg", "1024", "--fmin", "0", "--fmax", "30",
                 "--csv", csv_path]) == 0
    out = capsys.readouterr().out
    assert "a_sweep0\t" in out and "b_sweep0\t" in out
    with open(csv_path) as fh:
        rows = list(csv.reader(fh))
    assert rows[0][0] == "Burst ID"
    sources = {r[1] for r in rows[1:]}
    assert sources == {"a", "b"}
    # per-sweep IBI restarts: first event of each sweep has IBI nan
    firsts = [r for r in rows[1:] if r[1] == "b"][0]
    assert firsts[5] == "nan"


def test_cli_detect_each_batched_matches_sequential(tmp_path, capsys):
    """--each --batched: same-length sweeps run as one vmapped dispatch
    (models/batch.py); events must agree with the sequential per-sweep
    flow (same algorithm per clip — float-level EM reassociation under
    vmap is the only permitted difference, so compare by interval IoU).
    A different-length sweep in the same run lands in its own group."""
    from spectral_tpu.cli import main
    fs = 1000.0
    a = _bursty(fs=fs, dur=60.0, bursts=((10, 15),), seed=1)
    b = _bursty(fs=fs, dur=60.0, bursts=((20, 26), (40, 45)), seed=2)
    c = _bursty(fs=fs, dur=40.0, bursts=((5, 9),), seed=3)   # own group
    paths = []
    for nm, x in [("a", a), ("b", b), ("c", c)]:
        p = str(tmp_path / f"{nm}.wav")
        write_wav(p, x * 0.5, fs)
        paths.append(p)
    args = ["detect", *paths, "--each", "--scipy-compat",
            "--nperseg", "1024", "--fmin", "0", "--fmax", "30"]
    assert main(args) == 0
    seq = capsys.readouterr().out
    assert main(args + ["--batched"]) == 0
    bat = capsys.readouterr().out

    def parse(out):
        evs = {}
        for line in out.splitlines():
            name, s0, s1 = line.split("\t")
            evs.setdefault(name, []).append((float(s0), float(s1)))
        return evs

    es, eb = parse(seq), parse(bat)
    assert set(es) == set(eb) == {"a_sweep0", "b_sweep0", "c_sweep0"}
    for name in es:
        assert len(es[name]) == len(eb[name]), name
        for (a0, a1), (b0, b1) in zip(es[name], eb[name]):
            inter = max(0.0, min(a1, b1) - max(a0, b0))
            union = max(a1, b1) - min(a0, b0)
            assert inter / union > 0.95, (name, (a0, a1), (b0, b1))


def test_cli_detect_batched_requires_each(tmp_path):
    from spectral_tpu.cli import main
    p = str(tmp_path / "x.wav")
    write_wav(p, _bursty(dur=20.0) * 0.5, 1000.0)
    with pytest.raises(SystemExit):
        main(["detect", p, "--batched"])


def test_cli_serve_jsonl(tmp_path):
    import io
    import json
    from spectral_tpu.cli import _serve
    fs = 1000.0
    wav_path = str(tmp_path / "sig.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=60.0) * 0.5, fs)
    png_path = str(tmp_path / "served.png")
    reqs = [
        {"cmd": "ping"},
        {"cmd": "bands", "files": [wav_path],
         "config": {"nperseg": 512, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "detect", "files": [wav_path],
         "config": {"nperseg": 1024, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "render", "files": [wav_path], "out": png_path,
         "config": {"nperseg": 512, "log_scale": True}},
        {"cmd": "learn", "files": [wav_path], "rois": [[8, 17], [28, 40]],
         "config": {"nperseg": 1024, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "nonsense"},
        {"cmd": "detect", "files": ["/does/not/exist.wav"]},
        {"cmd": "shutdown"},
    ]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert out[0] == {"ok": True, "pong": True}
    assert out[1]["ok"] and out[1]["bands"]["Theta (θ)"] > 0.5
    assert out[2]["ok"] and len(out[2]["events"]) == 2
    assert out[3]["ok"] and os.path.exists(png_path)
    assert out[4]["ok"] and len(out[4]["events"]) >= 2
    assert not out[5]["ok"] and "unknown cmd" in out[5]["error"]
    assert not out[6]["ok"]                      # error did not kill worker
    assert out[7] == {"ok": True, "bye": True}


def test_cli_serve_lru_eviction_and_guards(tmp_path, monkeypatch):
    """Hardened worker: LRU-bounded session cache (memory flat across many
    distinct file-sets), oversized-request rejection, per-request timeout
    with recovery, and the batched render request (one device dispatch for
    N clips)."""
    import io
    import json
    from spectral_tpu.cli import _serve

    fs = 1000.0
    paths = []
    for i in range(6):
        p = str(tmp_path / f"s{i}.wav")
        write_wav(p, _bursty(fs=fs, dur=20.0) * 0.5, fs)
        paths.append(p)

    # LRU of 2: 6 distinct file-sets + a revisit of the first -> the first
    # was evicted, so it must reload (a fresh session); the cache never
    # holds more than 2 sessions. Proven by counting loads.
    import spectral_tpu.api.session as sess_mod
    loads = []
    orig_session = sess_mod.AnalysisSession

    class CountingSession(orig_session):
        def load(self, path):
            loads.append(path)
            return super().load(path)

    monkeypatch.setattr(sess_mod, "AnalysisSession", CountingSession)
    reqs = [{"cmd": "bands", "files": [p],
             "config": {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}}
            for p in paths]
    reqs.append(reqs[0])            # revisit the evicted first file-set
    reqs.append(reqs[-2])           # revisit the still-cached last one
    reqs.append({"cmd": "shutdown"})
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout, max_sessions=2) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert all(o["ok"] for o in out)
    # 6 distinct loads + 1 reload of the evicted set; the cached revisit
    # loads nothing
    assert loads == paths + [paths[0]]
    monkeypatch.setattr(sess_mod, "AnalysisSession", orig_session)

    # oversized request rejected before parsing, worker stays up
    big = json.dumps({"cmd": "bands", "files": [paths[0]],
                      "pad": "x" * 4096})
    stdin = io.StringIO(big + "\n" + json.dumps({"cmd": "ping"}) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout, max_request_bytes=1024) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert not out[0]["ok"] and "max_request_bytes" in out[0]["error"]
    assert out[1] == {"ok": True, "pong": True}

    # per-request timeout: a stuck handler answers with a timeout error and
    # the NEXT request is still served
    slow_marker = {"cmd": "bands", "files": [str(tmp_path / "slow.wav")]}
    import time as _time
    from spectral_tpu.api import session as sess_mod

    class SlowSession(sess_mod.AnalysisSession):
        def load(self, path):
            if "slow" in str(path):
                _time.sleep(1.0)
            return super().load(path)

    monkeypatch.setattr(sess_mod, "AnalysisSession", SlowSession)
    write_wav(str(tmp_path / "slow.wav"), _bursty(fs=fs, dur=5.0) * 0.5, fs)
    stdin = io.StringIO(json.dumps(slow_marker) + "\n"
                        + json.dumps({"cmd": "ping"}) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout, request_timeout=0.2) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert not out[0]["ok"] and "Timeout" in out[0]["error"]
    assert out[1] == {"ok": True, "pong": True}   # recovered

    # timeout 0 (and None) means NO timeout — the documented disabled
    # value; regression: the daemon-thread rewrite briefly treated 0 as a
    # zero-second deadline, timing out every request
    stdin = io.StringIO(json.dumps(slow_marker) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout, request_timeout=0) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert out[0]["ok"], out[0]    # the 1 s-slow request completed


def test_cli_serve_render_batch(tmp_path):
    """render_batch: N clips through ONE batched dispatch (the export
    pipeline) instead of N per-file sessions."""
    import io
    import json
    from spectral_tpu.cli import _serve
    fs = 1000.0
    paths = []
    for i in range(4):
        p = str(tmp_path / f"clip{i}.wav")
        write_wav(p, _bursty(fs=fs, dur=10.0) * 0.5, fs)
        paths.append(p)
    out_dir = str(tmp_path / "batchpngs")
    req = {"cmd": "render_batch", "files": paths, "out_dir": out_dir,
           "clip_seconds": 10.0,
           "config": {"nperseg": 256, "hop": 64, "window": "hann",
                      "detrend": "none", "log_scale": True}}
    stdin = io.StringIO(json.dumps(req) + "\n"
                        + json.dumps({"cmd": "shutdown"}) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert out[0]["ok"] and out[0]["written"] == 4
    assert sorted(os.listdir(out_dir)) == [f"clip{i}.png" for i in range(4)]

    # registry formats too: an .h5 request renders one PNG per sweep
    h5py = pytest.importorskip("h5py")
    from spectral_tpu.io.nix import write_nix_fixture
    h5 = str(tmp_path / "r.h5")
    write_nix_fixture(
        h5, [{"proc_a": _bursty(fs=fs, dur=10.0).astype(np.float32)}],
        fs=fs)
    out_dir2 = str(tmp_path / "h5pngs")
    req2 = dict(req, files=[h5], out_dir=out_dir2)
    stdin = io.StringIO(json.dumps(req2) + "\n"
                        + json.dumps({"cmd": "shutdown"}) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert out[0]["ok"] and out[0]["written"] == 1
    assert os.listdir(out_dir2) == ["r_sweep0.png"]


def test_cli_error_paths_exit_nonzero(tmp_path, capsys):
    """Failures must not exit 0: swallowed exporter 'Error ...' statuses
    return 1, and domain errors exit via a clean message (no traceback)."""
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "sig.wav")
    write_wav(wav_path, np.sin(np.linspace(0, 60, 6000)).astype(np.float32), fs)

    # export failure -> printed status + exit code 1
    bad_out = str(tmp_path / "no" / "such" / "dir" / "x.png")
    assert main(["render", wav_path, "-o", bad_out]) == 1
    assert "Error exporting PNG" in capsys.readouterr().out

    # mixed sampling rates -> clean SystemExit, not a ValueError traceback
    wav2 = str(tmp_path / "other.wav")
    write_wav(wav2, np.zeros(4000, np.float32), 2000.0)
    with pytest.raises(SystemExit) as ei:
        main(["render", wav_path, wav2, "--combine",
              "-o", str(tmp_path / "o.png")])
    assert "Mixed sampling rates" in str(ei.value)

    # unsupported file type in stream -> clean SystemExit
    txt = tmp_path / "x.txt"
    txt.write_text("nope")
    with pytest.raises(SystemExit) as ei:
        main(["stream", str(txt), "--bands"])
    assert "Unsupported file type" in str(ei.value)


def test_cli_stream_scipy_compat_small_chunk(tmp_path, capsys):
    """The chunk floor must be hop-aligned: in scipy-compat mode nperseg
    itself is never a multiple of hop, so the old max(nperseg, ...)
    fallback crashed every stream whose requested chunk rounded to 0."""
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "s.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=10.0) * 0.5, fs)
    assert main(["stream", wav_path, "--bands", "--scipy-compat",
                 "--nperseg", "512", "--chunk-seconds", "0.1"]) == 0
    assert "Total absolute power" in capsys.readouterr().out


def test_detection_reuses_plot_psd(monkeypatch):
    """_features must reuse the plot-time device PSD instead of recomputing
    the full STFT per detect call (a redundant dispatch; the reference
    recomputes, PlotEngine.py:232)."""
    import spectral_tpu.api.session as sess_mod
    s = _session_with_sweeps()
    cfg = SpecConfig.scipy_default(512, fmin=0.0, fmax=30.0)

    calls = {"n": 0}
    real = sess_mod.power_spectrogram

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(sess_mod, "power_spectrogram", counting)
    # the plot path runs through the cached fused program (_plot_program):
    # power_spectrogram fires at TRACE time, so drop any program compiled
    # by earlier tests to observe the one trace this plot triggers
    sess_mod._plot_program.cache_clear()
    s.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())
    assert calls["n"] == 1
    ev1 = s.unsupervised_detect()
    assert calls["n"] == 1  # cache hit: no second STFT dispatch

    # and the cached-path events equal a recompute-path detection
    s2 = _session_with_sweeps()
    s2.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())
    s2._psd_cache = None  # force the recompute branch
    ev2 = s2.unsupervised_detect()
    assert ev1 == ev2

    # a config change after the plot invalidates the cache (recompute)
    base = calls["n"]
    s.config = SpecConfig.scipy_default(256, fmin=0.0, fmax=30.0)
    s.unsupervised_detect()
    assert calls["n"] == base + 1


def test_cli_oneshot_sessions_skip_detection_warmup(tmp_path, monkeypatch):
    """One-shot CLI commands must not spawn the background detection-warmup
    thread: it never helps (the process detects immediately or never) and
    exiting mid-compile crashes runtime teardown on remote backends."""
    import spectral_tpu.api.session as sess_mod
    from spectral_tpu.cli import main
    seen = []
    real = sess_mod.AnalysisSession

    class Recording(real):
        def __init__(self, *a, **kw):
            seen.append(kw.get("warm_detection", True))
            super().__init__(*a, **kw)

    monkeypatch.setattr(sess_mod, "AnalysisSession", Recording)
    wav_path = str(tmp_path / "w.wav")
    write_wav(wav_path, _bursty(fs=1000.0, dur=10.0) * 0.5, 1000.0)
    assert main(["--cpu", "bands", wav_path]) == 0
    assert main(["--cpu", "detect", wav_path, "--each"]) == 0
    assert seen and all(w is False for w in seen)


def test_cli_stream_processed_only_npz(tmp_path, capsys):
    """A processed-only npz used to crash stream with a KeyError traceback;
    it must stream the processed signal like every plotting command."""
    from spectral_tpu.cli import main
    p = str(tmp_path / "proc.npz")
    np.savez(p, processed=_bursty(fs=1000.0, dur=10.0), fs=1000.0)
    assert main(["--cpu", "stream", p, "--bands"]) == 0
    assert "Total absolute power" in capsys.readouterr().out


def test_cli_stream_honors_band_mask(tmp_path, capsys):
    """--fmin/--fmax must shape the npz/image outputs like they do render."""
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "s.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=10.0) * 0.5, fs)
    out = str(tmp_path / "psd.npz")
    assert main(["--cpu", "stream", wav_path, "-o", out,
                 "--nperseg", "256", "--fmin", "0", "--fmax", "30"]) == 0
    z = np.load(out)
    assert z["f"].max() <= 30.0
    assert z["psd"].shape[1] == z["f"].shape[0]


def test_cli_scipy_compat_rejects_window(tmp_path, capsys):
    from spectral_tpu.cli import main
    wav_path = str(tmp_path / "s.wav")
    write_wav(wav_path, _bursty(fs=1000.0, dur=5.0) * 0.5, 1000.0)
    with pytest.raises(SystemExit) as ei:
        main(["--cpu", "render", wav_path, "-o", str(tmp_path / "o.png"),
              "--scipy-compat", "--window", "hann"])
    assert "tukey" in str(ei.value)


def test_cli_nfft_flag(tmp_path, capsys):
    """--nfft must reach the config (zero-padded transform, scipy's nfft)
    on both the north-star and --scipy-compat paths, and reject
    nfft < nperseg with a clean error (reference scipy raises the same)."""
    from spectral_tpu.cli import main, _make_config
    import argparse
    wav_path = str(tmp_path / "s.wav")
    write_wav(wav_path, _bursty(fs=1000.0, dur=5.0) * 0.5, 1000.0)

    out_png = str(tmp_path / "o.png")
    assert main(["--cpu", "render", wav_path, "-o", out_png,
                 "--nperseg", "256", "--nfft", "512"]) == 0
    assert os.path.exists(out_png)

    # config plumbing: both branches of _make_config apply nfft
    def _args(**kw):
        ns = argparse.Namespace(
            scipy_compat=False, nperseg=256, hop=None, window=None,
            fmin=0.0, fmax=None, log=False, fast=False, mels=0, nfft=None)
        for k, v in kw.items():
            setattr(ns, k, v)
        return ns
    assert _make_config(_args(nfft=512)).nfft_ == 512
    assert _make_config(_args(scipy_compat=True, nfft=1024)).nfft_ == 1024
    assert _make_config(_args()).nfft_ == 256  # default: no padding

    with pytest.raises(SystemExit) as ei:
        main(["--cpu", "render", wav_path, "-o", out_png,
              "--nperseg", "512", "--nfft", "256"])
    assert "nfft" in str(ei.value)


def test_cli_multifile_notice_without_combine(tmp_path, capsys):
    from spectral_tpu.cli import main
    fs = 1000.0
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, _bursty(fs=fs, dur=5.0) * 0.5, fs)
    write_wav(b, _bursty(fs=fs, dur=5.0) * 0.5, fs)
    assert main(["--cpu", "bands", a, b]) == 0
    assert "analyzing only" in capsys.readouterr().err


def test_wav_info_header_only(tmp_path):
    from spectral_tpu.io.wav import wav_info
    p = str(tmp_path / "w.wav")
    write_wav(p, np.zeros(1000, np.float32), 44100.0)
    fmt, ch, fs, bits = wav_info(p)
    assert (fmt, ch, fs, bits) == (1, 1, 44100.0, 16)


def test_serve_ok_false_on_export_error(tmp_path):
    """serve must not report ok:true when the exporter returned an
    'Error ...' status string."""
    import io as _io
    from spectral_tpu.cli import _serve
    fs = 1000.0
    wav_path = str(tmp_path / "s.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=10.0) * 0.5, fs)
    req = {"cmd": "render", "files": [wav_path],
           "out": str(tmp_path / "no_dir" / "deep" / "x.png"),
           "config": {"nperseg": 256}}
    import json as _json
    stdin = _io.StringIO(_json.dumps(req) + "\n")
    stdout = _io.StringIO()
    _serve(stdin, stdout)
    resp = _json.loads(stdout.getvalue().splitlines()[0])
    assert resp["ok"] is False and "Error" in resp["message"]


def test_batch_export_name_collision_dedupes(tmp_path):
    """Two names that sanitize identically must not silently overwrite."""
    import os as _os
    from spectral_tpu.api.export import export_batch_signals_png
    s = _session_with_sweeps(1)
    x = np.ones(1000, np.float32)
    s.registry.register("rec:1_sweep0", SweepEntry(
        filepath="a", sweep_idx=0, fs=1000.0, fs_raw=1000.0, raw=x,
        processed=None))
    s.registry.register("rec_1_sweep0", SweepEntry(
        filepath="b", sweep_idx=0, fs=1000.0, fs_raw=1000.0, raw=x * 0.5,
        processed=None))
    msg = export_batch_signals_png(str(tmp_path), s.registry,
                                   ["rec:1_sweep0", "rec_1_sweep0"])
    assert "Exported 2" in msg
    pngs = [f for f in _os.listdir(str(tmp_path)) if f.endswith(".png")]
    assert len(pngs) == 2


def test_plot_empty_band_early_return():
    """A band with no frequency rows reproduces the reference's early
    return (PlotEngine.py:122-124): empty last_t, no image — through the
    session's legacy path (the fused plot program refuses empty bands)."""
    s = _session_with_sweeps()
    res = s.plot_sweeps(
        ["rec_sweep0"],
        SpecConfig.scipy_default(512, fmin=600.0, fmax=700.0),  # > Nyquist
        ViewSettings())
    assert res.t.size == 0 and s.last_t.size == 0
    assert s.last_image is None
    assert s.last_sxx.shape[0] == 0


def test_plot_twosided_band_uses_gather_path():
    """A two-sided spectrum's fmin/fmax mask is non-contiguous (fftfreq
    ordering) — the session must fall back to the host gather mask and
    produce rows matching the masked axis exactly."""
    s = _session_with_sweeps()
    cfg = SpecConfig(nperseg=256, onesided=False, fmin=-50.0, fmax=50.0,
                     detrend="constant")
    res = s.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())
    full_f = np.fft.fftfreq(256, 1 / 1000.0)
    n_rows = int(((full_f >= -50) & (full_f <= 50)).sum())
    assert res.sxx.shape[0] == n_rows == res.f.shape[0]
    assert res.image.shape == res.sxx.shape
    assert float(res.image.max()) <= 1.0


def test_plot_fast_path_matches_legacy_host_path(monkeypatch):
    """The fused plot program (device-side mask+normalize, one transfer)
    must produce the same sxx/image/f as the legacy host-mask flow —
    forced here by making band_row_slice refuse."""
    import spectral_tpu.core.stft as stft_mod
    cfg = SpecConfig.scipy_default(512, fmin=2.0, fmax=40.0, log_scale=True)

    s1 = _session_with_sweeps()
    r1 = s1.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())

    def refuse(*a, **kw):
        raise ValueError("forced legacy path")

    monkeypatch.setattr(stft_mod, "band_row_slice", refuse)
    s2 = _session_with_sweeps()
    r2 = s2.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())

    np.testing.assert_array_equal(r1.f, r2.f)
    np.testing.assert_array_equal(r1.t, r2.t)
    np.testing.assert_allclose(r1.sxx, r2.sxx, rtol=1e-6,
                               atol=1e-9 * float(r2.sxx.max()))
    np.testing.assert_allclose(r1.image, r2.image, rtol=1e-5, atol=1e-6)


def test_plot_legacy_host_path_mel_matches_fast(monkeypatch):
    """The legacy host-mask flow's mel stage (api/session.py legacy
    branch) must match the fused program's mel output — it only runs for
    zero-frame/empty-band/two-sided plots, so force it."""
    import dataclasses

    import spectral_tpu.core.stft as stft_mod
    cfg = dataclasses.replace(
        SpecConfig.north_star(256, 64, log_scale=True), n_mels=32)

    s1 = _session_with_sweeps()
    r1 = s1.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())

    def refuse(*a, **kw):
        raise ValueError("forced legacy path")

    monkeypatch.setattr(stft_mod, "band_row_slice", refuse)
    s2 = _session_with_sweeps()
    r2 = s2.plot_sweeps(["rec_sweep0"], cfg, ViewSettings())
    np.testing.assert_array_equal(r1.f, r2.f)
    assert r1.sxx.shape[0] == 32
    np.testing.assert_allclose(r1.sxx, r2.sxx, rtol=1e-6,
                               atol=1e-9 * float(r2.sxx.max()))
    np.testing.assert_allclose(r1.image, r2.image, rtol=1e-5, atol=1e-6)


def test_plot_sweeps_dataless_entries():
    """Entries with neither raw nor processed data: skipped inside a
    combine (segment_map only lists real contributors), and a selection
    of ONLY dataless sweeps returns None (reference: nothing to plot)."""
    s = AnalysisSession(warm_detection=False)
    s.registry.register("empty_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=None, processed=None))
    assert s.plot_sweeps(["empty_sweep0"], SpecConfig(nperseg=256),
                         ViewSettings()) is None
    assert s.plot_sweeps(["empty_sweep0"], SpecConfig(nperseg=256),
                         ViewSettings(combine=True)) is None

    x = np.sin(0.3 * np.arange(4096)).astype(np.float32)
    s.registry.register("real_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=x, processed=None))
    r = s.plot_sweeps(["empty_sweep0", "real_sweep0"],
                      SpecConfig(nperseg=256),
                      ViewSettings(combine=True))
    assert r is not None
    assert [seg.source_name for seg in s.segment_map] == ["real_sweep0"]


def test_cli_grid(tmp_path):
    """`grid` computes the sweep grid in batched dispatches and writes one
    npz; each combo's PSD must equal the single-config computation."""
    from spectral_tpu.cli import main
    from spectral_tpu.core.stft import power_spectrogram
    fs = 1000.0
    wav_path = str(tmp_path / "g.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=10.0) * 0.5, fs)
    out = str(tmp_path / "grid.npz")
    assert main(["grid", wav_path, "-o", out,
                 "--n-ffts", "256,512", "--windows", "hann,hamming"]) == 0
    z = np.load(out)
    keys = sorted(k for k in z.files if k.startswith("psd_"))
    assert keys == ["psd_256_hamming", "psd_256_hann",
                    "psd_512_hamming", "psd_512_hann"]
    from spectral_tpu.io.wav import read_wav
    x, _ = read_wav(wav_path)
    ref = np.asarray(power_spectrogram(
        jnp.asarray(x, jnp.float32), fs,
        SpecConfig(nperseg=512, hop=128, window="hamming",
                   detrend="none"))).T
    np.testing.assert_allclose(z["psd_512_hamming"], ref, rtol=2e-5,
                               atol=1e-9 * ref.max())
    assert z["f_512"].shape[0] == ref.shape[0]
    # oversize n_fft refuses cleanly
    with pytest.raises(SystemExit):
        main(["grid", wav_path, "-o", out, "--n-ffts", "65536"])
    # an empty grid refuses instead of writing a payload-free npz
    with pytest.raises(SystemExit):
        main(["grid", wav_path, "-o", out, "--n-ffts", ","])
    with pytest.raises(SystemExit):
        main(["grid", wav_path, "-o", out, "--windows", ","])


def test_cli_serve_protocol_fuzz(tmp_path):
    """Protocol fuzz: every input line — malformed JSON, wrong types,
    hostile field values, binary junk — gets exactly one JSON response
    and never kills the worker. Strict parsers must be able to read every
    response (no NaN/Inf literals)."""
    import io
    import json
    from spectral_tpu.cli import _serve
    fs = 1000.0
    wav_path = str(tmp_path / "f.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=20.0) * 0.5, fs)
    rng = np.random.RandomState(7)
    lines = [
        "{not json",
        "[1, 2, 3]",                                  # JSON but not an object
        '"just a string"',
        "null",
        '{"cmd": 42}',
        '{"cmd": "render"}',                          # missing files/out
        '{"cmd": "render", "files": 17, "out": "x.png"}',
        f'{{"cmd": "render", "files": ["{wav_path}"]}}',   # missing out
        f'{{"cmd": "detect", "files": ["{wav_path}"], '
        '"config": {"nperseg": -4}}',
        f'{{"cmd": "detect", "files": ["{wav_path}"], '
        '"config": {"bogus_field": 1}}',
        f'{{"cmd": "learn", "files": ["{wav_path}"], "rois": "zzz"}}',
        f'{{"cmd": "learn", "files": ["{wav_path}"], "rois": [[1]]}}',
        f'{{"cmd": "render_batch", "files": [], "out_dir": '
        f'"{tmp_path}/d"}}',
        '{"cmd": "bands", "files": []}',
        # block-9 request types, hostile variants
        '{"cmd": "detect_batch"}',                    # missing files
        '{"cmd": "detect_batch", "files": "x"}',
        '{"cmd": "stream_bands", "files": []}',       # channel out of range
        f'{{"cmd": "stream_bands", "files": ["{wav_path}"], '
        '"channel": 99}',
        f'{{"cmd": "stream_bands", "files": ["{wav_path}"], '
        '"chunk_seconds": "soon"}',
        f'{{"cmd": "stream_bands", "files": ["{wav_path}"], '
        '"config": {"center": true}}',                # streaming refuses
    ]
    # random printable junk lines (deterministic)
    for _ in range(20):
        n = int(rng.randint(1, 60))
        lines.append("".join(chr(rng.randint(0x20, 0x7F)) for _ in range(n)))
    lines.append('{"cmd": "shutdown"}')
    stdin = io.StringIO("\n".join(lines) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout) == 0
    out_lines = stdout.getvalue().splitlines()
    # exactly one response per non-empty input line
    assert len(out_lines) == len(lines)
    for ln in out_lines:
        resp = json.loads(ln, parse_constant=lambda s: (_ for _ in ()).throw(
            ValueError(f"non-strict JSON literal {s!r} in response")))
        assert isinstance(resp, dict) and "ok" in resp
    assert json.loads(out_lines[-1]) == {"ok": True, "bye": True}
    # everything before shutdown was an error response, not a crash
    assert all(not json.loads(l)["ok"] for l in out_lines[:-1])


def test_session_misuse_and_default_branches(tmp_path):
    """Coverage-lens gaps (tools/covlite.py): the out-of-order / empty
    session paths a confused API user hits first — errors must be the
    reference's friendly messages, queries must degrade to None/defaults,
    never tracebacks from inside jax."""
    from spectral_tpu.api.session import AnalysisSession

    s = AnalysisSession(warm_detection=False)
    with pytest.raises(ValueError, match="plot a spectrogram"):
        s.unsupervised_detect()
    with pytest.raises(ValueError, match="No manual regions"):
        s.learn_and_detect()
    assert s.calculate_band_powers() is None      # GUI guards; API -> None
    assert s.min_roi_width() == 0.01              # no fs yet -> fallback
    assert s.export_csv(str(tmp_path / "x.csv")).startswith("Error")
    assert s.export_png(str(tmp_path / "x.png")).startswith("Error")
    assert s.merge_rois((0.0, 1.0)) == []
    with pytest.raises(ValueError, match="no sweeps selected"):
        s.plot_sweeps([], None, None)

    # config=None / view=None defaults: scipy_default + default view
    reg = SweepRegistry()
    reg.register("rec_sweep0", SweepEntry(
        "f", 0, 1000.0, 1000.0,
        np.random.default_rng(0).standard_normal(4000).astype(np.float32),
        None))
    s2 = AnalysisSession(registry=reg, warm_detection=False)
    res = s2.plot_sweeps(s2.registry.names(), None, None)
    assert s2.config == SpecConfig.scipy_default()
    assert res.sxx.shape[0] == 513                # nperseg 1024 default
    assert s2.min_roi_width() == 1.0 / 1000.0


def test_cli_error_arms_exit_cleanly(tmp_path, capsys):
    """Coverage-lens gaps: the CLI's error arms — missing files, empty
    registries, zero-event CSV in --each mode, and --mels composed onto
    --scipy-compat — exit with clean messages, never tracebacks."""
    from spectral_tpu.cli import main

    # missing file: every loading subcommand exits via the friendly arm
    for argv in (["detect", str(tmp_path / "nope.wav")],
                 ["detect", str(tmp_path / "nope.wav"), "--each"],
                 ["bands", str(tmp_path / "nope.h5")]):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert "file not found" in str(ei.value)

    # --each --csv with zero events -> the reference's exporter error, rc 1
    fs = 1000.0
    quiet = str(tmp_path / "quiet.wav")
    write_wav(quiet, (np.ones(8000, np.float32) * 0.01), fs)
    csv_path = str(tmp_path / "e.csv")
    rc = main(["detect", quiet, "--each", "--csv", csv_path,
               "--nperseg", "512"])
    outerr = capsys.readouterr()
    if rc == 1:                       # constant signal -> 0 events
        assert "No burst data to export" in outerr.out
        assert not os.path.exists(csv_path)

    # --mels composes with --scipy-compat (the dataclasses.replace arm)
    out_png = str(tmp_path / "mel.png")
    assert main(["render", quiet, "-o", out_png, "--scipy-compat",
                 "--mels", "32", "--log"]) == 0
    from spectral_tpu.render.png import decode_png
    assert decode_png(out_png).shape[0] == 32    # mel-height image

    # corrupt (non-loadable) file: the loaders' ValueError surfaces via
    # the friendly arm in BOTH the session path and the --each path
    bad = str(tmp_path / "bad.abf")
    with open(bad, "wb") as fh:
        fh.write(b"NOPE" + b"\x00" * 600)
    for argv in (["detect", bad], ["detect", bad, "--each"]):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert "error:" in str(ei.value) and "Traceback" not in str(ei.value)

    # a file that loads but registers ZERO sweeps ((0, n) raw) -> the
    # empty-registry arm, not a confusing downstream IndexError
    empty = str(tmp_path / "empty.npz")
    np.savez(empty, fs=1000.0, raw=np.zeros((0, 100), np.float32))
    for argv in (["detect", empty], ["detect", empty, "--each"]):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert "no sweeps loaded" in str(ei.value)


def test_cli_learn_and_grid_error_arms(tmp_path, capsys):
    """learn's ROI parse/flow and grid's spec validation exit via the
    friendly arms (coverage-lens: cli.py learn/grid blocks)."""
    from spectral_tpu.cli import main
    fs = 1000.0
    wav_path = str(tmp_path / "eeg.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=60.0) * 0.5, fs)

    # bad ROI spec refuses BEFORE any device work
    with pytest.raises(SystemExit) as ei:
        main(["learn", wav_path, "--roi", "8-17"])
    assert "start:end" in str(ei.value)

    # happy path: learn two ROIs, write the CSV through the exporter
    csv_path = str(tmp_path / "l.csv")
    rc = main(["learn", wav_path, "--roi", "10:16", "--roi", "35:42",
               "--csv", csv_path, "--scipy-compat"])
    assert rc == 0
    out = capsys.readouterr().out
    assert os.path.exists(csv_path) and "\t" in out

    # grid validation arms
    with pytest.raises(SystemExit) as ei:
        main(["grid", wav_path, "-o", str(tmp_path / "g.npz"),
              "--channel", "7"])
    assert "out of range" in str(ei.value)
    with pytest.raises(SystemExit) as ei:
        main(["grid", wav_path, "-o", str(tmp_path / "g.npz"),
              "--n-ffts", "abc"])
    assert "bad grid spec" in str(ei.value)
    with pytest.raises(SystemExit) as ei:
        main(["grid", wav_path, "-o", str(tmp_path / "g.npz"),
              "--n-ffts", ""])
    assert "empty grid" in str(ei.value)
    with pytest.raises(SystemExit) as ei:
        main(["grid", wav_path, "-o", str(tmp_path / "g.npz"),
              "--n-ffts", "1048576"])
    assert "larger than the signal" in str(ei.value)


def test_cli_serve_csv_arm_and_doctor_unreachable(tmp_path, capsys,
                                                  monkeypatch):
    """Coverage-lens gaps: the serve CSV attachment (ok must flip False
    when the export reports an error), doctor refusing the removed
    link-probe flags, and `gui` without PyQt5."""
    import io
    import json
    from spectral_tpu import cli as cli_mod
    fs = 1000.0
    wav_path = str(tmp_path / "sig.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=60.0) * 0.5, fs)
    good_csv = str(tmp_path / "ok.csv")
    reqs = [
        # detect with events + csv -> ok, csv written
        {"cmd": "detect", "files": [wav_path], "csv": good_csv,
         "config": {"nperseg": 1024, "fmin": 0.0, "fmax": 30.0}},
        # bands never produces events; csv export errors -> ok False
        {"cmd": "bands", "files": [wav_path], "csv": str(tmp_path / "no.csv"),
         "config": {"nperseg": 512}},
        {"cmd": "shutdown"},
    ]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    assert cli_mod._serve(stdin, stdout) == 0
    out = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert out[0]["ok"] and "Successfully" in out[0]["csv"]
    assert os.path.exists(good_csv)
    assert out[1]["ok"] is False and out[1]["csv"].startswith("Error")

    # doctor runs in this process only: no subprocess init probe (a
    # second process would contend for the card's memory) and no link
    # probe — its one option is --json
    ap = cli_mod.build_parser()
    sub = next(a for a in ap._actions if a.dest == "cmd")
    doctor_opts = {o for a in sub.choices["doctor"]._actions
                   for o in a.option_strings}
    assert doctor_opts == {"-h", "--help", "--json"}

    # gui without PyQt5: friendly pointer to the CLI, exit code 2
    try:
        import PyQt5  # noqa: F401
        pytest.skip("PyQt5 unexpectedly present")
    except ImportError:
        pass
    rc = cli_mod.main(["gui"])
    assert rc == 2
    assert "requires PyQt5" in capsys.readouterr().err


def _c_locale_env():
    """Environment that forces Python's platform default encoding to ASCII
    (PEP 538 coercion and PEP 540 UTF-8 mode both disabled) — the headless
    cron/server locale that turns missing encoding= into crashes."""
    env = dict(os.environ)
    env.update(LC_ALL="C", LANG="C",
               PYTHONCOERCECLOCALE="0", PYTHONUTF8="0")
    return env


def test_csv_export_utf8_regardless_of_locale(tmp_path):
    """A recording with a non-ASCII filename exports to CSV under a C/POSIX
    locale (the Source File column is written as utf-8 explicitly; the
    platform-default encoding used to raise UnicodeEncodeError)."""
    import subprocess
    import sys as _sys
    fs = 1000.0
    wav_path = str(tmp_path / "münchen_α.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=20.0) * 0.5, fs)
    out_csv = str(tmp_path / "out.csv")
    r = subprocess.run(
        [_sys.executable, "-m", "spectral_tpu.cli", "--cpu", "detect",
         wav_path, "--csv", out_csv],
        env=_c_locale_env(), capture_output=True, text=False, timeout=600)
    assert r.returncode == 0, r.stderr.decode("utf-8", "replace")
    with open(out_csv, encoding="utf-8") as fh:
        body = fh.read()
    assert "münchen_α" in body
    assert "Error" not in body


def test_cli_serve_utf8_stdin_under_c_locale(tmp_path):
    """A serve request containing non-ASCII bytes must produce a JSON
    response, not kill the worker with UnicodeDecodeError from the locale
    codec on stdin (the read loop itself used to raise before the
    per-request error handling could run)."""
    import json
    import subprocess
    import sys as _sys
    fs = 1000.0
    wav_path = str(tmp_path / "plain.wav")
    write_wav(wav_path, _bursty(fs=fs, dur=20.0) * 0.5, fs)
    reqs = [
        {"cmd": "ping"},
        # non-ASCII path: the request is VALID utf-8 but the C locale's
        # ascii codec cannot decode it
        {"cmd": "render", "files": [str(tmp_path / "nicht_da_ü.wav")],
         "out": str(tmp_path / "x.png")},
        {"cmd": "ping"},
        {"cmd": "shutdown"},
    ]
    payload = "".join(json.dumps(r, ensure_ascii=False) + "\n"
                      for r in reqs).encode("utf-8")
    r = subprocess.run(
        [_sys.executable, "-m", "spectral_tpu.cli", "--cpu", "serve"],
        input=payload, env=_c_locale_env(), capture_output=True,
        timeout=600)
    assert r.returncode == 0, r.stderr.decode("utf-8", "replace")
    lines = [ln for ln in r.stdout.decode("utf-8").splitlines() if ln]
    resps = [json.loads(ln) for ln in lines]
    assert len(resps) == 4, resps
    assert resps[0].get("pong") and resps[2].get("pong")
    assert resps[1]["ok"] is False        # missing file -> error response
    assert resps[3].get("bye")


def test_cli_directory_as_input_exits_cleanly(tmp_path, capsys):
    """A directory named like a recording is an environment error, not a
    traceback (OSError joins the CLI's clean domain-error exits)."""
    from spectral_tpu import cli as cli_mod
    d = tmp_path / "dir.wav"
    d.mkdir()
    with pytest.raises(SystemExit) as ei:
        cli_mod.main(["--cpu", "info", str(d)])
    assert "Is a directory" in str(ei.value)


def test_plot_sweeps_unknown_name_clean_error():
    """A bad sweep name raises a ValueError naming the loaded sweeps, not
    a bare KeyError from the registry dict (headless-API surface)."""
    s = AnalysisSession()
    s.registry.register("sweep0", SweepEntry(
        filepath="x.wav", sweep_idx=0, fs=100.0, fs_raw=100.0,
        raw=np.zeros(100, np.float32), processed=None))
    with pytest.raises(ValueError, match="unknown sweep 'nope'.*sweep0"):
        s.plot_sweeps(["nope"], SpecConfig(nperseg=32, hop=16),
                      ViewSettings())


def test_f32_power_overflow_refused_with_rescale_hint():
    """A finite waveform whose spectral power overflows float32 must raise
    an actionable error (the reference's f64 math never overflows; silent
    NaN pixels are our artifact) — while non-finite SAMPLES keep the
    reference's pixel-for-pixel NaN propagation (no raise)."""
    s = AnalysisSession(warm_detection=False)
    big = (1e19 * np.random.default_rng(0).standard_normal(4096)
           ).astype(np.float32)
    s.registry.register("ok_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=np.sin(0.3 * np.arange(4096)).astype(np.float32),
        processed=None))
    s.registry.register("big_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=big, processed=None))
    s.plot_sweeps(["ok_sweep0"], SpecConfig(nperseg=256), ViewSettings())
    with pytest.raises(ValueError, match="power of two"):
        s.plot_sweeps(["big_sweep0"], SpecConfig(nperseg=256),
                      ViewSettings())
    # post-raise display state is CLEARED (plot_sweeps clears at entry,
    # reference PlotEngine.clear :68-76), never the NaN-pixel garbage:
    # an export after the error refuses cleanly instead of writing it
    assert s.last_image is None
    assert s.export_png("/nonexistent-dir/x.png").startswith("Error")

    s2 = AnalysisSession(warm_detection=False)
    bad = np.zeros(4096, np.float32)
    bad[1000] = np.nan
    s2.registry.register("nan_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=bad, processed=None))
    res = s2.plot_sweeps(["nan_sweep0"], SpecConfig(nperseg=256),
                         ViewSettings())
    assert np.isnan(res.image).any()  # reference propagation, untouched


def test_f32_power_underflow_refused_with_rescale_hint():
    """The symmetric silent failure: a tiny-but-real waveform (amplitude
    ~1e-25) whose f32 power underflows to EXACT zero would render an
    all-zero image with all-zero band ratios where the reference's f64
    succeeds (scipy f64 PSD ~2.6e-52). Total underflow must refuse with
    the rescale-UP hint; signals whose zero PSD is reference-faithful
    (true digital silence, pure DC under constant detrend) must keep
    rendering the degenerate zeros image."""
    rng = np.random.default_rng(0)
    tiny = (1e-25 * rng.standard_normal(4096)).astype(np.float32)
    s = AnalysisSession(warm_detection=False)
    s.registry.register("tiny_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=tiny, processed=None))
    for kwargs in ({"log_scale": True}, {}):
        with pytest.raises(ValueError, match="underflows.*power of two"):
            s.plot_sweeps(["tiny_sweep0"], SpecConfig(nperseg=256, **kwargs),
                          ViewSettings())
    # the hinted fix renders (and the normalized image is then the same
    # as the well-scaled signal's: power-of-two scaling is lossless)
    s.registry.register("fixed_sweep0", SweepEntry(
        filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
        raw=tiny * 2.0 ** 80, processed=None))
    res = s.plot_sweeps(["fixed_sweep0"], SpecConfig(nperseg=256),
                        ViewSettings())
    assert res.image.max() == 1.0

    for name, x in (("silence", np.zeros(4096, np.float32)),
                    ("dc", np.full(4096, 0.25, np.float32))):
        s2 = AnalysisSession(warm_detection=False)
        s2.registry.register(f"{name}_sweep0", SweepEntry(
            filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
            raw=x, processed=None))
        res = s2.plot_sweeps([f"{name}_sweep0"], SpecConfig(nperseg=256),
                             ViewSettings())
        assert not res.image.any()          # reference-faithful zeros


def test_overflow_guard_covers_log_scale_and_global_max():
    """The guard checks the PSD, not the image: the dB map's nan_to_num
    and the global-max clip both launder inf into finite pixels, so an
    image-level check silently passes garbage on the GUI's log-scale
    checkbox path and on shared-scale batch renders."""
    big = (1e19 * np.random.default_rng(0).standard_normal(4096)
           ).astype(np.float32)
    for kwargs in ({"log_scale": True}, {}):
        s = AnalysisSession(warm_detection=False)
        s.registry.register("big_sweep0", SweepEntry(
            filepath="f", sweep_idx=0, fs=1000.0, fs_raw=1000.0,
            raw=big, processed=None))
        gm = 1.0 if not kwargs else None
        with pytest.raises(ValueError, match="power of two"):
            s.plot_sweeps(["big_sweep0"], SpecConfig(nperseg=256, **kwargs),
                          ViewSettings(), global_max=gm)


def _write_float_wav(path, x, fs):
    """Minimal IEEE-float32 WAV (format tag 3) — write_wav clips to 16-bit
    PCM, which cannot carry overflow-scale amplitudes."""
    import struct
    payload = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, int(fs), int(fs) * 4, 4, 32)
    path.write_bytes(
        struct.pack("<4sI4s", b"RIFF", 20 + len(fmt) + len(payload), b"WAVE")
        + struct.pack("<4sI", b"fmt ", len(fmt)) + fmt
        + struct.pack("<4sI", b"data", len(payload)) + payload)


@pytest.mark.parametrize("batched", [False, True])
def test_detect_each_skips_overflowing_sweep(tmp_path, capsys, batched):
    """One overflowing sweep in a fleet skips with a per-sweep stderr line
    (like any other per-sweep failure) instead of aborting the whole
    --each run; the healthy sweeps still report their events."""
    from spectral_tpu import cli as cli_mod
    fs = 1000.0
    good = tmp_path / "good.wav"
    write_wav(str(good), _bursty(fs=fs, dur=15.0, bursts=((4, 8),)) * 0.5, fs)
    big = tmp_path / "big.wav"
    _write_float_wav(big, 1e19 * np.random.default_rng(0)
                     .standard_normal(int(15 * fs)), fs)
    argv = ["--cpu", "detect", "--each", str(big), str(good),
            "--nperseg", "256", "--scipy-compat"]
    if batched:
        argv.append("--batched")
    rc = cli_mod.main(argv)
    out, err = capsys.readouterr()
    assert rc == 0
    assert "big_sweep0\tskipped:" in err
    assert "rescale" in err or "power of two" in err
    assert any(line.startswith("good_sweep0\t") for line in out.splitlines())


def test_stream_refuses_overflow_but_propagates_nan_samples(tmp_path,
                                                            capsys):
    """The stream CLI honors the same overflow contract as the session
    plot path: finite input + overflowed f32 power exits with the rescale
    hint (both --bands and npz/PNG outputs), while non-finite SAMPLES
    keep reference propagation (npz written, inf/NaN inside)."""
    from spectral_tpu import cli as cli_mod
    fs = 1000.0
    big = tmp_path / "big.wav"
    _write_float_wav(big, 1e19 * np.random.default_rng(0)
                     .standard_normal(8000), fs)
    for extra in (["--bands"], ["-o", str(tmp_path / "o.npz")]):
        with pytest.raises(SystemExit) as ei:
            cli_mod.main(["--cpu", "stream", str(big), "--nperseg", "256",
                          "--chunk-seconds", "2"] + extra)
        assert "rescale" in str(ei.value)

    nanwav = tmp_path / "nan.wav"
    x = np.zeros(8000, np.float32)
    x[4000] = np.nan
    _write_float_wav(nanwav, x, fs)
    out = tmp_path / "nan.npz"
    rc = cli_mod.main(["--cpu", "stream", str(nanwav), "--nperseg", "256",
                       "--chunk-seconds", "2", "-o", str(out)])
    assert rc == 0
    assert np.isnan(np.load(out)["psd"]).any()


def test_stream_refuses_underflow_but_keeps_true_silence(tmp_path):
    """Symmetric underflow contract on the stream CLI: a tiny-but-real
    recording whose f32 power underflows to total zero exits with the
    rescale-UP hint (both --bands and npz outputs); true digital silence
    keeps its reference-faithful all-zero analytics."""
    from spectral_tpu import cli as cli_mod
    fs = 1000.0
    tiny = tmp_path / "tiny.wav"
    _write_float_wav(tiny, (1e-25 * np.random.default_rng(0)
                            .standard_normal(8000)).astype(np.float32), fs)
    for extra in (["--bands"], ["-o", str(tmp_path / "o.npz")]):
        with pytest.raises(SystemExit) as ei:
            cli_mod.main(["--cpu", "stream", str(tiny), "--nperseg", "256",
                          "--chunk-seconds", "2"] + extra)
        assert "underflows" in str(ei.value) and "2**80" in str(ei.value)

    silent = tmp_path / "zero.wav"
    _write_float_wav(silent, np.zeros(8000, np.float32), fs)
    out = tmp_path / "z.npz"
    rc = cli_mod.main(["--cpu", "stream", str(silent), "--nperseg", "256",
                       "--chunk-seconds", "2", "-o", str(out)])
    assert rc == 0
    assert not np.load(out)["psd"].any()


def test_cli_serve_tcp(tmp_path):
    """serve --tcp: the same JSONL protocol over a socket. Warm state
    (the session cache) persists across connections — a client can
    disconnect and a later one still gets served — and shutdown stops
    the server; a malformed request answers ok:false without killing it."""
    import json
    import socket
    import threading
    from spectral_tpu.cli import _serve_tcp
    fs = 1000.0
    wav = str(tmp_path / "t.wav")
    write_wav(wav, _bursty(fs=fs, dur=15.0, bursts=((4, 8),)) * 0.5, fs)

    port_box = {}
    ready = threading.Event()

    def set_port(p):
        port_box["port"] = p
        ready.set()

    rc_box = {}

    def server():
        rc_box["rc"] = _serve_tcp("127.0.0.1", 0, ready=set_port)

    th = threading.Thread(target=server, daemon=True)
    th.start()
    assert ready.wait(30.0)

    def talk(reqs):
        out = []
        with socket.create_connection(("127.0.0.1", port_box["port"]),
                                      timeout=60.0) as c:
            f = c.makefile("rw", encoding="utf-8")
            for r in reqs:
                f.write(json.dumps(r) + "\n")
                f.flush()
                out.append(json.loads(f.readline()))
        return out

    # connection 1: ping + detect + a malformed request + stats
    r = talk([{"cmd": "ping"},
              {"cmd": "detect", "files": [wav],
               "config": {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}},
              {"cmd": "nonsense"},
              {"cmd": "stats"}])
    assert r[0] == {"ok": True, "pong": True}
    assert r[1]["ok"] and r[1]["events"]
    assert not r[2]["ok"]
    stats = r[3]
    assert stats["ok"] and stats["requests"] == 4
    assert stats["errors"] == 1 and stats["sessions_cached"] == 1
    assert stats["rss_mb"] > 0
    # connection 2 (after the first disconnected): still served, then stop
    r = talk([{"cmd": "ping"}, {"cmd": "shutdown"}])
    assert r[0]["ok"] and r[1] == {"ok": True, "bye": True}
    th.join(30.0)
    assert not th.is_alive() and rc_box["rc"] == 0


def test_cli_serve_tcp_idle_timeout(tmp_path):
    """A client that connects and stalls must not hold the sequential
    server: with --idle-timeout its connection is dropped and the NEXT
    client is served by the same warm worker."""
    import json
    import socket
    import threading
    import time
    from spectral_tpu.cli import _serve_tcp

    port_box, ready = {}, threading.Event()
    th = threading.Thread(
        target=lambda: _serve_tcp("127.0.0.1", 0, idle_timeout=0.5,
                                  ready=lambda p: (
                                      port_box.update(port=p), ready.set())),
        daemon=True)
    th.start()
    assert ready.wait(30.0)

    staller = socket.create_connection(("127.0.0.1", port_box["port"]),
                                       timeout=30.0)
    staller.sendall(b'{"cmd": "pi')          # partial line, then silence
    time.sleep(1.2)                          # > idle_timeout

    with socket.create_connection(("127.0.0.1", port_box["port"]),
                                  timeout=30.0) as c:
        f = c.makefile("rw", encoding="utf-8")
        f.write(json.dumps({"cmd": "ping"}) + "\n")
        f.flush()
        assert json.loads(f.readline())["pong"]
        f.write(json.dumps({"cmd": "shutdown"}) + "\n")
        f.flush()
        assert json.loads(f.readline())["bye"]
    staller.close()
    th.join(30.0)
    assert not th.is_alive()


def test_serve_client_tcp(tmp_path):
    """ServeClient speaks the protocol end-to-end against a live TCP
    worker: typed results, ServeError on ok=false, shutdown on close."""
    import threading
    from spectral_tpu.cli import _serve_tcp
    from spectral_tpu.client import ServeClient, ServeError
    fs = 1000.0
    wav = str(tmp_path / "c.wav")
    write_wav(wav, _bursty(fs=fs, dur=15.0, bursts=((4, 8),)) * 0.5, fs)

    port_box, ready = {}, threading.Event()
    th = threading.Thread(
        target=lambda: _serve_tcp("127.0.0.1", 0, ready=lambda p: (
            port_box.update(port=p), ready.set())),
        daemon=True)
    th.start()
    assert ready.wait(30.0)

    cfg = {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}
    with ServeClient.tcp(port_box["port"]) as c:
        assert c.ping()
        events = c.detect([wav], config=cfg)
        assert events and all(isinstance(e, tuple) for e in events)
        bands, total = c.bands([wav], config=cfg)
        assert set(bands) and total > 0
        out = str(tmp_path / "c.png")
        assert "Successfully" in c.render([wav], out, config=cfg)
        assert os.path.exists(out)
        res = c.detect_batch([wav], config=cfg)
        assert res["c_sweep0"]["events"]
        learned = c.learn([wav], rois=[(3.0, 9.0)], config=cfg)
        assert learned and learned[0][0] >= 2.0
        sb, stot = c.stream_bands([wav], chunk_seconds=5.0,
                                  config={"nperseg": 256})
        assert set(sb) and stot > 0
        # the fold matches the session's monolithic band powers
        mb, mtot = c.bands([wav], config={"nperseg": 256})
        assert abs(stot - mtot) / mtot < 1e-4
        for k in mb:
            assert abs(sb[k] - mb[k]) < 1e-5
        bdir = str(tmp_path / "cb")
        rb = c.render_batch([wav], bdir, clip_seconds=15.0,
                            config={"nperseg": 256, "hop": 64,
                                    "log_scale": True})
        assert rb["written"] == 1 and os.listdir(bdir) == ["c.png"]
        with pytest.raises(ServeError, match="unknown cmd"):
            c.request({"cmd": "nonsense"})
        assert c.stats()["requests"] >= 7
    # context exit didn't shut the server down (TCP default) — do so now
    with ServeClient.tcp(port_box["port"]) as c2:
        c2.close(shutdown=True)
    th.join(30.0)
    assert not th.is_alive()


def test_serve_client_spawn():
    """ServeClient.spawn owns a worker subprocess over pipes and tears
    it down on close (the stdio transport end-to-end)."""
    from spectral_tpu.client import ServeClient
    with ServeClient.spawn(["--cpu"]) as c:
        assert c.ping()
        assert c.stats()["sessions_cached"] == 0
    assert c._proc.returncode == 0        # clean shutdown, not a kill


def test_cli_serve_detect_batch(tmp_path):
    """serve's detect_batch: every sweep of the request's files detected
    through the vmapped fleet path, per-sweep errors isolated as entries
    (not request failures)."""
    import io
    import json
    from spectral_tpu.cli import _serve
    fs = 1000.0
    good = str(tmp_path / "g.wav")
    write_wav(good, _bursty(fs=fs, dur=15.0, bursts=((4, 8),)) * 0.5, fs)
    bad = tmp_path / "b.wav"
    _write_float_wav(bad, 1e19 * np.random.default_rng(0)
                     .standard_normal(15000), fs)
    reqs = [
        {"cmd": "detect_batch", "files": [good, str(bad)],
         "config": {"nperseg": 256, "fmin": 0.0, "fmax": 30.0}},
        {"cmd": "shutdown"},
    ]
    stdin = io.StringIO("\n".join(json.dumps(r) for r in reqs) + "\n")
    stdout = io.StringIO()
    assert _serve(stdin, stdout) == 0
    out = [json.loads(l) for l in stdout.getvalue().splitlines()]
    assert out[0]["ok"]
    res = out[0]["results"]
    assert res["g_sweep0"]["events"]          # bursty file finds events
    assert "rescale" in res["b_sweep0"]["error"]
