"""Differential tests executing the REFERENCE'S OWN CODE against spectral_tpu.

Unlike every other parity test (scipy oracles, the numpy hmmlearn oracle,
hand-computed goldens — all authored alongside the code under test), these
import the reference modules from the read-only checkout and run them
headlessly (tests/reference_exec.py): real matplotlib Agg figures, real
scipy, real numpy, with only the non-installable Qt/hmmlearn/loader deps
stubbed at the import boundary. What is compared is therefore the
reference's executing behavior, not our reading of it.

Skipped entirely when the reference checkout is absent — the repo stays
standalone.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import reference_exec

# soak knobs: SPECTRAL_TPU_FUZZ_TRIALS scales the parametrized display-math
# fuzz (default 24 in CI; hundreds in a tools-driven soak) and
# SPECTRAL_TPU_FUZZ_SEED offsets every fuzz RNG so repeated soaks explore
# fresh cases while staying reproducible from the logged seed.
FUZZ_TRIALS = int(os.environ.get("SPECTRAL_TPU_FUZZ_TRIALS", "24"))
FUZZ_SEED = int(os.environ.get("SPECTRAL_TPU_FUZZ_SEED", "0"))

if not reference_exec.available():  # pragma: no cover
    pytest.skip("reference checkout not available", allow_module_level=True)

from spectral_tpu.api.session import AnalysisSession
from spectral_tpu.config import SpecConfig, ViewSettings
from spectral_tpu.core import events as ev
from spectral_tpu.io.registry import SweepEntry, SweepRegistry


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

FS = 1000.0


def burst_signal(rng, n=30_000, spans=((8.0, 11.0), (18.0, 22.0)),
                 base_amp=0.05, burst_amp=1.2, f0=15.0):
    """Noise floor with strong oscillatory bursts — the well-separated
    regime where detection is backend-stable."""
    t = np.arange(n) / FS
    x = base_amp * rng.randn(n)
    for a, b in spans:
        m = (t >= a) & (t < b)
        x[m] += burst_amp * np.sin(2 * np.pi * f0 * t[m])
    return x.astype(np.float64)


def ref_settings(nperseg=1024, fmin=0.0, fmax=30.0, log_scale=True,
                 **view):
    s = {"nperseg": nperseg, "fmin": fmin, "fmax": fmax,
         "log_scale": log_scale,
         "draw_raw": True, "draw_proc": False,
         "mode_raw": "Spectrogram", "mode_proc": "Signal",
         "combine": False}
    s.update(view)
    return s


def our_config(nperseg=1024, fmin=0.0, fmax=30.0, log_scale=True):
    return SpecConfig.scipy_default(nperseg, fmin=fmin, fmax=fmax,
                                    log_scale=log_scale)


def session_with(sig_raw, sig_proc=None, fs=FS, name="rec_sweep0"):
    reg = SweepRegistry()
    reg.register(name, SweepEntry(filepath=f"/tmp/{name.split('_')[0]}.h5",
                                  sweep_idx=0, fs=fs, fs_raw=fs,
                                  raw=np.asarray(sig_raw, np.float32),
                                  processed=None if sig_proc is None
                                  else np.asarray(sig_proc, np.float32)))
    return AnalysisSession(registry=reg, warm_detection=False)


def quadmesh_array(engine):
    """The normalized image the reference handed to pcolormesh."""
    meshes = [c for c in engine.ax_spec.collections
              if type(c).__name__ == "QuadMesh"]
    assert meshes, "reference drew no spectrogram mesh"
    arr = np.asarray(meshes[0].get_array())
    assert arr.ndim == 2, arr.shape  # matplotlib >= 3.8 keeps the 2-D shape
    return arr


# ---------------------------------------------------------------------------
# display math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_scale", [True, False])
def test_display_image_matches_reference_pcolormesh(log_scale):
    """PlotEngine._plot_spectrogram (:110-145) executing on the Agg canvas
    vs our _compute_spectrogram: same normalized image, frequency rows and
    frame times."""
    rng = np.random.RandomState(0)
    sig = burst_signal(rng)
    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings(log_scale=log_scale))
    ref_img = quadmesh_array(engine)

    s = session_with(sig)
    res = s.plot_sweeps(["rec_sweep0"], our_config(log_scale=log_scale),
                        ViewSettings(draw_raw=True, draw_proc=False,
                                     mode_raw="Spectrogram"))
    assert res.image.shape == ref_img.shape
    np.testing.assert_allclose(res.image, ref_img, atol=5e-4)
    np.testing.assert_allclose(res.f, engine.last_f, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.t, engine.last_t, rtol=0, atol=1e-9)
    # linear PSD parity on the masked band
    np.testing.assert_allclose(res.sxx, engine.last_Sxx,
                               rtol=2e-4, atol=1e-18)


def test_axis_limit_policy_matches_reference():
    """Non-combined plots clip x to the spectrogram's t[-1]; the y range is
    (fmin, f[-1]) (PlotEngine.py:139-144 with last_raw_t unset)."""
    rng = np.random.RandomState(1)
    sig = burst_signal(rng, n=20_000)
    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings())
    assert engine.ax_spec.get_xlim() == (0.0, engine.last_t[-1])
    assert engine.ax_spec.get_ylim() == (0.0, engine.last_f[-1])

    s = session_with(sig)
    s.plot_sweeps(["rec_sweep0"], our_config(),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    # our documented policy state: non-combined => no signal-duration stretch
    assert s.last_signal_t_end is None
    np.testing.assert_allclose(s.last_t[-1], engine.last_t[-1], atol=1e-12)


def test_combined_axis_stretch_matches_reference():
    """Combined plots stretch x to max(t[-1], last_raw_t[-1])
    (PlotEngine.py:200, :139-143)."""
    rng = np.random.RandomState(2)
    a = burst_signal(rng, n=12_000, spans=((3.0, 5.0),))
    b = burst_signal(rng, n=9_000, spans=((2.0, 4.0),))
    engine = reference_exec.make_engine()
    sweeps_info = [
        {"item": object(), "signal_raw": a, "signal_proc": None, "fs": FS},
        {"item": object(), "signal_raw": b, "signal_proc": None, "fs": FS},
    ]
    engine.plot_sweeps(sweeps_info, ref_settings(combine=True,
                                                 draw_proc=True))
    ref_xmax = engine.ax_spec.get_xlim()[1]

    reg = SweepRegistry()
    for i, sig in enumerate((a, b)):
        reg.register(f"rec_sweep{i}", SweepEntry("/tmp/rec.h5", i, FS, FS,
                                                 np.asarray(sig, np.float32),
                                                 None))
    s = AnalysisSession(registry=reg, warm_detection=False)
    s.plot_sweeps(["rec_sweep0", "rec_sweep1"], our_config(),
                  ViewSettings(combine=True, draw_raw=True, draw_proc=True,
                               mode_raw="Spectrogram"))
    assert s.last_signal_t_end is not None
    ours_xmax = max(s.last_t[-1], s.last_signal_t_end)
    np.testing.assert_allclose(ours_xmax, ref_xmax, atol=1e-9)


def test_combine_segment_map_matches_reference():
    """plot_sweeps combine concatenation + segment-map provenance
    (PlotEngine.py:147-213)."""
    rng = np.random.RandomState(3)
    sigs = [burst_signal(rng, n=n, spans=()) for n in (7_000, 5_000, 6_500)]
    items = [object() for _ in sigs]
    engine = reference_exec.make_engine()
    sweeps_info = [{"item": it, "signal_raw": sg, "signal_proc": None,
                    "fs": FS} for it, sg in zip(items, sigs)]
    engine.plot_sweeps(sweeps_info, ref_settings(combine=True,
                                                 draw_proc=True))

    reg = SweepRegistry()
    names = []
    for i, sg in enumerate(sigs):
        nm = f"rec_sweep{i}"
        reg.register(nm, SweepEntry("/tmp/rec.h5", i, FS, FS,
                                    np.asarray(sg, np.float32), None))
        names.append(nm)
    s = AnalysisSession(registry=reg, warm_detection=False)
    s.plot_sweeps(names, our_config(),
                  ViewSettings(combine=True, draw_raw=True, draw_proc=True,
                               mode_raw="Spectrogram"))

    assert len(s.segment_map) == len(engine.segment_map)
    for ours, ref in zip(s.segment_map, engine.segment_map):
        np.testing.assert_allclose(ours.start_time_combined,
                                   ref["start_time_combined"], atol=1e-12)
        np.testing.assert_allclose(ours.end_time_combined,
                                   ref["end_time_combined"], atol=1e-12)
    # same concatenated source drives the spectrogram
    np.testing.assert_allclose(np.asarray(s.spec_data_source, np.float64),
                               engine.spec_data_source, atol=1e-7)


# ---------------------------------------------------------------------------
# features / supervised fit / detection flows
# ---------------------------------------------------------------------------

def test_detection_features_match_reference():
    """_calculate_features (PlotEngine.py:229-242)."""
    rng = np.random.RandomState(4)
    sig = burst_signal(rng)
    engine = reference_exec.make_engine()
    t_ref, feat_ref = engine._calculate_features(sig, FS, ref_settings())

    s = session_with(sig)
    s.plot_sweeps(["rec_sweep0"], our_config(),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    t_ours, feat_ours = s._features()
    np.testing.assert_allclose(t_ours, t_ref, atol=1e-9)
    assert feat_ours.shape == feat_ref.shape
    np.testing.assert_allclose(feat_ours, feat_ref, atol=2e-4)


def test_supervised_fit_matches_reference_train():
    """_train_supervised's closed-form M-step (PlotEngine.py:328-387)
    executing on a duck model vs models/hmm.supervised_fit."""
    import types as _types
    from spectral_tpu.models.hmm import supervised_fit

    rng = np.random.RandomState(5)
    feat = rng.randn(400, 2) * [1.0, 0.3] + [-5.0, 0.0]
    labels = np.zeros(400, dtype=int)
    labels[100] = 1
    labels[101:140] = 2
    labels[140] = 3
    labels[260] = 1
    labels[261:290] = 2
    labels[290] = 3

    engine = reference_exec.make_engine()
    duck = _types.SimpleNamespace(n_components=4)
    engine.model = duck
    engine._train_supervised(feat, labels)

    params = supervised_fit(feat, labels, n_states=4)
    np.testing.assert_allclose(np.asarray(params.means), duck.means_,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(params.covars), duck.covars_,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(params.transmat), duck.transmat_,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(params.startprob), duck.startprob_,
                               rtol=0, atol=0)


def test_unsupervised_detect_events_match_reference_execution():
    """The reference's unsupervised_detect (PlotEngine.py:411-473) — scipy
    spectrogram + EM through the float64 oracle + its boundary-timed scan —
    vs our full JAX path, event for event."""
    rng = np.random.RandomState(6)
    sig = burst_signal(rng)
    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings())
    ref_events = engine.unsupervised_detect()

    s = session_with(sig)
    s.plot_sweeps(["rec_sweep0"], our_config(),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    our_events = s.unsupervised_detect()

    assert len(our_events) == len(ref_events)
    np.testing.assert_allclose(np.asarray(our_events),
                               np.asarray(ref_events), atol=1e-5)


def test_learn_and_detect_events_match_reference_execution():
    """learn_and_detect (PlotEngine.py:244-326): per-ROI 2-state fits, the
    4-state label track, supervised fit, decode, merge — executing end to
    end on the reference."""
    rng = np.random.RandomState(7)
    spans = ((8.0, 11.0), (18.0, 22.0))
    sig = burst_signal(rng, spans=spans)
    rois = [(7.0, 12.0), (17.0, 23.0)]

    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings())
    engine.plot_detection_lines(rois)
    engine.last_detected_events = []  # patches alone drive learning
    ref_events = engine.learn_and_detect()

    s = session_with(sig)
    s.plot_sweeps(["rec_sweep0"], our_config(),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    our_events = s.learn_and_detect(rois)

    assert len(our_events) == len(ref_events)
    np.testing.assert_allclose(np.asarray(our_events),
                               np.asarray(ref_events), atol=1e-5)


def test_event_scan_matches_reference_on_injected_states():
    """Isolate the boundary-timed scan + merge (PlotEngine.py:447-473) from
    EM: inject a refined model whose predict() replays a fixed state
    sequence and compare against core/events.baseline_scan."""
    import types as _types
    rng = np.random.RandomState(8)
    T = 500
    t = np.arange(T) * 0.9216  # scipy frame centers shape
    states = np.zeros(T, dtype=np.int64)
    states[50:80] = 2
    states[80] = 1          # event continues through a non-baseline change
    states[81:90] = 3
    states[200:201] = 1     # single-frame event
    states[498:] = 2        # event open at the end

    engine = reference_exec.make_engine()
    engine.spec_data_source = rng.randn(4096)
    engine.last_fs = FS
    engine.last_settings = ref_settings(nperseg=512)
    engine.is_model_refined = True
    engine.model = _types.SimpleNamespace(
        n_components=4,
        predict=lambda X: states,
        means_=np.array([[0.0, 0], [1, 0], [2, 0], [3, 0]]),
    )
    # make the reference compute features/t of length T: monkeypatch via
    # _calculate_features is intrusive; instead give it a signal whose
    # spectrogram has exactly T frames
    f_t = engine._calculate_features(engine.spec_data_source, FS,
                                     engine.last_settings)
    t_ref = f_t[0]
    states2 = np.resize(states, len(t_ref))
    engine.model.predict = lambda X: states2
    ref_events = engine.unsupervised_detect()

    ours = ev.merge_overlapping_events(
        ev.baseline_scan(states2, t_ref, baseline_state=0))
    assert ours == pytest.approx(ref_events)


def test_merge_overlapping_events_fuzz_matches_reference():
    """_merge_overlapping_events (PlotEngine.py:669-684) over random event
    soups incl. touching-within-tolerance pairs."""
    engine = reference_exec.make_engine()
    rng = np.random.RandomState(9 + FUZZ_SEED)
    for _ in range(200):
        n = rng.randint(0, 12)
        events = []
        for _ in range(n):
            a = float(rng.uniform(0, 50))
            b = a + float(rng.uniform(0, 5))
            if rng.rand() < 0.3 and events:
                a = events[-1][1] + rng.choice([0.0, 5e-7, 2e-6])
                b = a + float(rng.uniform(0, 2))
            events.append((a, b))
        ref = engine._merge_overlapping_events(list(events))
        ours = ev.merge_overlapping_events(list(events))
        assert ours == pytest.approx(ref), events


# ---------------------------------------------------------------------------
# analytics
# ---------------------------------------------------------------------------

def test_band_powers_match_reference_execution():
    """calculate_band_powers / calculate_absolute_power
    (PlotEngine.py:686-719) after identical plots."""
    rng = np.random.RandomState(10)
    sig = burst_signal(rng)
    engine = reference_exec.make_engine()
    # wide band so several EEG bands are populated
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings(fmax=300.0, log_scale=False))
    ref_bands = engine.calculate_band_powers()
    ref_total = engine.calculate_absolute_power()

    s = session_with(sig)
    s.plot_sweeps(["rec_sweep0"], our_config(fmax=300.0, log_scale=False),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    our_bands = s.calculate_band_powers()
    our_total = s.calculate_absolute_power()

    assert list(our_bands) == list(ref_bands)
    for k in ref_bands:
        np.testing.assert_allclose(our_bands[k], ref_bands[k], rtol=2e-4,
                                   atol=1e-12)
    np.testing.assert_allclose(our_total, ref_total, rtol=2e-4)


# ---------------------------------------------------------------------------
# CSV export
# ---------------------------------------------------------------------------

class _Item:
    """Duck QTreeWidgetItem: the reference only calls .data(0, UserRole)
    (ExportManager.py:59, :67)."""

    def __init__(self, full_name):
        self._name = full_name

    def data(self, col, role):
        return self._name


def test_csv_export_bytes_match_reference(tmp_path):
    """ExportManager.export_to_csv executing end to end (attribution through
    the segment map, IBI NaN-first, float formatting) vs export_events_csv —
    identical file bytes from identical session state."""
    rng = np.random.RandomState(11)
    sigs = [burst_signal(rng, n=n, spans=()) for n in (9_000, 7_000)]
    names = ["recA_sweep0", "recB_sweep3"]
    items = [_Item(f"/data/{n}") for n in names]
    events = [(2.5, 3.75), (8.125, 9.0), (11.5, 13.25)]

    engine = reference_exec.make_engine()
    sweeps_info = [{"item": it, "signal_raw": sg, "signal_proc": None,
                    "fs": FS} for it, sg in zip(items, sigs)]
    engine.plot_sweeps(sweeps_info, ref_settings(combine=True,
                                                 draw_proc=True))
    engine.plot_detection_lines(events)
    engine.last_detected_events = list(events)
    ref_path = tmp_path / "ref.csv"
    msg_ref = reference_exec.load().ExportManager().export_to_csv(
        str(ref_path), engine)
    assert msg_ref.startswith("Successfully exported 3")

    reg = SweepRegistry()
    for nm, sg in zip(names, sigs):
        reg.register(nm, SweepEntry(f"/data/{nm.split('_')[0]}.h5", 0, FS, FS,
                                    np.asarray(sg, np.float32), None))
    s = AnalysisSession(registry=reg, warm_detection=False)
    s.plot_sweeps(names, our_config(),
                  ViewSettings(combine=True, draw_raw=True, draw_proc=True,
                               mode_raw="Spectrogram"))
    s.last_detected_events = list(events)
    our_path = tmp_path / "ours.csv"
    msg_ours = s.export_csv(str(our_path))
    assert msg_ours.startswith("Successfully exported 3")

    assert our_path.read_bytes() == ref_path.read_bytes()


def test_csv_export_noncombined_attribution_matches(tmp_path):
    """Non-combined plots attribute every row to the first plotted item
    (ExportManager.py:65-71)."""
    rng = np.random.RandomState(12)
    sig = burst_signal(rng, n=9_000, spans=())
    name = "solo_sweep7"
    engine = reference_exec.make_engine()
    engine.plot_sweeps([{"item": _Item(f"/x/{name}"), "signal_raw": sig,
                         "signal_proc": None, "fs": FS}],
                       ref_settings())
    events = [(1.0, 2.0), (4.5, 5.0)]
    engine.plot_detection_lines(events)
    engine.last_detected_events = list(events)
    ref_path = tmp_path / "ref.csv"
    reference_exec.load().ExportManager().export_to_csv(str(ref_path), engine)

    s = session_with(sig, name=name)
    s.plot_sweeps([name], our_config(),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    s.last_detected_events = list(events)
    our_path = tmp_path / "ours.csv"
    s.export_csv(str(our_path))
    assert our_path.read_bytes() == ref_path.read_bytes()


# ---------------------------------------------------------------------------
# SweepManager.get_signal semantics
# ---------------------------------------------------------------------------

def test_get_signal_semantics_fuzz_matches_reference():
    """Every loader-reachable registry entry shape (the reference's loaders
    always set both 'fs' and 'fs_raw' keys — fs_raw may be None when the raw
    NIX rate is unextractable, SweepManager.py:118-125) through
    SweepManager.get_signal (:151-185) vs SweepRegistry.get_signal."""
    ref = reference_exec.load()
    arr_raw = np.arange(5.0)
    arr_proc = np.arange(3.0)

    for raw in (None, arr_raw):
        for proc in (None, arr_proc):
            for fs_raw in (None, 2000.0):
                for processed in (False, True):
                    mgr = ref.SweepManager()
                    mgr.data["x"] = {"filepath": "/f", "sweep_idx": 0,
                                     "fs": 1000.0, "fs_raw": fs_raw,
                                     "raw": raw, "processed": proc}
                    reg = SweepRegistry()
                    reg.register("x", SweepEntry("/f", 0, 1000.0, fs_raw,
                                                 raw, proc))

                    ref_exc = ref_out = None
                    try:
                        ref_out = mgr.get_signal("x", processed=processed)
                    except KeyError as e:
                        ref_exc = str(e)
                    our_exc = our_out = None
                    try:
                        our_out = reg.get_signal("x", processed=processed)
                    except KeyError as e:
                        our_exc = str(e)

                    case = (raw is not None, proc is not None, fs_raw,
                            processed)
                    assert (ref_exc is None) == (our_exc is None), \
                        (case, ref_exc, our_exc)
                    if ref_out is not None:
                        sig_r, fs_r = ref_out
                        sig_o, fs_o = our_out
                        assert fs_o == fs_r, case
                        np.testing.assert_array_equal(sig_o, sig_r)


# ---------------------------------------------------------------------------
# ROI editor: the reference's mouse state machine driven by REAL matplotlib
# MouseEvents on the Agg canvas vs RoiEditorController fed the same
# coordinates
# ---------------------------------------------------------------------------

from matplotlib.backend_bases import MouseEvent


def _mouse(engine, name, ax, x_data, button=None):
    """A real MouseEvent at data-x (mid-y) of the given axes; the engine's
    handlers read inaxes/xdata/button exactly as under Qt."""
    engine.fig.canvas.draw()
    y0, y1 = ax.get_ylim()
    xp, yp = ax.transData.transform((x_data, 0.5 * (y0 + y1)))
    return MouseEvent(name, engine.fig.canvas, float(xp), float(yp),
                      button=button)


def _mouse_outside(engine, name, button=None):
    """An event outside every axes (inaxes None, xdata None)."""
    return MouseEvent(name, engine.fig.canvas, 1.0, 1.0, button=button)


def _interaction_pair():
    """Reference engine + our controller over the same 30 s plot."""
    rng = np.random.RandomState(20)
    sig = burst_signal(rng, spans=())
    engine = reference_exec.make_engine()
    engine.fig.set_size_inches(4, 3)
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings(nperseg=512))
    engine.set_editing_enabled(True)

    s = session_with(sig)
    s.plot_sweeps(["rec_sweep0"], our_config(nperseg=512),
                  ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    from spectral_tpu.gui.controller import RoiEditorController
    ctl = RoiEditorController(s)
    ctl.set_editing_enabled(True)
    return engine, s, ctl


def _ref_patches(engine):
    return sorted(tuple(p[0].event_data) for p in engine.burst_patches)


def _dispatch(engine, name, event):
    """Route through the canvas callback registry, exactly as connected by
    set_editing_enabled (PlotEngine.py:491-495)."""
    engine.fig.canvas.callbacks.process(name, event)


def _add(engine, ctl, ax, a, b, n_moves=2):
    """Synchronized drag-add: ours consumes the xdata the reference's events
    actually carried (bit-identical coordinates)."""
    ev_p = _mouse(engine, "button_press_event", ax, a, button=1)
    _dispatch(engine, "button_press_event", ev_p)
    ctl.on_press(ev_p.xdata, button=1)
    for frac in np.linspace(0.3, 0.9, n_moves):
        xm = a + (b - a) * frac
        ev_m = _mouse(engine, "motion_notify_event", ax, xm)
        _dispatch(engine, "motion_notify_event", ev_m)
        ctl.on_motion(ev_m.xdata)
        assert (engine.adding_patch is not None) == (ctl.drag_span is not None)
    ev_r = _mouse(engine, "button_release_event", ax, b)
    _dispatch(engine, "button_release_event", ev_r)
    ctl.on_release(ev_r.xdata)


def _hover(engine, ctl, ax, x):
    ev_m = _mouse(engine, "motion_notify_event", ax, x)
    _dispatch(engine, "motion_notify_event", ev_m)
    ctl.on_motion(ev_m.xdata)


def _hover_state(engine, ctl):
    ref = (tuple(engine.hovered_patch[0].event_data)
           if engine.hovered_patch else None)
    ours = (tuple(ctl.patches()[ctl.hover]) if ctl.hover is not None
            else None)
    return ref, ours


def test_roi_add_hover_merge_differential_fuzz():
    """A seeded random script of drag-adds (both axes), hover probes,
    out-of-axes drag cancels and right-click merges, driven through the
    reference's connected handlers (PlotEngine.py:497-645) and mirrored
    into RoiEditorController — patch lists bit-identical after every
    action, hover states identical at every probe."""
    engine, s, ctl = _interaction_pair()
    ref = reference_exec.load()
    rng = np.random.RandomState(21 + FUZZ_SEED)
    axes = [engine.ax_signal, engine.ax_spec]

    def free_x():
        """A probe point well clear of every patch edge (pixel-space
        contains() and data-space hit tests must agree there)."""
        for _ in range(50):
            x = float(rng.uniform(0.5, 29.5))
            if all(not (a - 0.75 < x < b + 0.75)
                   for a, b in _ref_patches(engine)):
                return x
        return None

    def patch_center():
        ps = _ref_patches(engine)
        if not ps:
            return None
        a, b = ps[rng.randint(len(ps))]
        return 0.5 * (a + b)

    for step in range(max(40, 10 * FUZZ_TRIALS // 6)):
        ax = axes[rng.randint(2)]
        op = rng.choice(["add", "add_contained", "hover_patch",
                         "hover_free", "cancel", "merge", "menu_dismiss",
                         "tiny_add"])
        if op == "add":
            a = float(rng.uniform(0.5, 25.0))
            b = a + float(rng.uniform(2.0, 4.0))
            _add(engine, ctl, ax, a, b)
        elif op == "add_contained":
            ps = _ref_patches(engine)
            wide = [p for p in ps if p[1] - p[0] > 2.5]
            if not wide:
                continue
            a0, b0 = wide[rng.randint(len(wide))]
            a = a0 + 0.3 * (b0 - a0)
            b = a0 + 0.7 * (b0 - a0)
            _add(engine, ctl, ax, a, b)
        elif op == "hover_patch":
            x = patch_center()
            if x is None:
                continue
            _hover(engine, ctl, ax, x)
            r, o = _hover_state(engine, ctl)
            assert r is not None and r == o, (step, r, o)
        elif op == "hover_free":
            x = free_x()
            if x is None:
                continue
            _hover(engine, ctl, ax, x)
            r, o = _hover_state(engine, ctl)
            assert r == o, (step, r, o)
        elif op == "cancel":
            a = float(rng.uniform(0.5, 29.0))
            ev_p = _mouse(engine, "button_press_event", ax, a, button=1)
            _dispatch(engine, "button_press_event", ev_p)
            ctl.on_press(ev_p.xdata, button=1)
            ev_r = _mouse_outside(engine, "button_release_event")
            _dispatch(engine, "button_release_event", ev_r)
            ctl.on_release(ev_r.xdata)  # None: discarded on both sides
        elif op == "tiny_add":
            a = float(rng.uniform(0.5, 29.0))
            _add(engine, ctl, ax, a, a + 4e-4, n_moves=1)  # < one sample
        elif op in ("merge", "menu_dismiss"):
            x = patch_center()
            if x is None:
                continue
            _hover(engine, ctl, ax, x)
            choice = "Merge" if op == "merge" else None
            ref.qt_stub.QMenu.next_choice = choice
            try:
                ev_p = _mouse(engine, "button_press_event", ax, x, button=3)
                _dispatch(engine, "button_press_event", ev_p)
                act = ctl.on_press(ev_p.xdata, button=3)
                if act == "menu" and choice == "Merge":
                    ctl.merge_hovered()
            finally:
                ref.qt_stub.QMenu.next_choice = None
            # hover bookkeeping matches through BOTH merge outcomes: a
            # no-op merge keeps the highlight (reference early return,
            # :578-580), a fired merge clears it (:602)
            r, o = _hover_state(engine, ctl)
            assert r == o, (step, "post-merge hover", r, o)

        assert _ref_patches(engine) == sorted(map(tuple, ctl.patches())), \
            (step, op)
        assert sorted(map(tuple, engine.last_detected_events)) == \
            sorted(map(tuple, s.last_detected_events)), (step, op)

    assert len(_ref_patches(engine)) > 0  # the fuzz actually built state


def test_roi_delete_divergence_is_the_documented_one():
    """The reference's Delete removes the PATCH but leaves the event in
    last_detected_events (remove_patch, PlotEngine.py:647-653 — so a
    deleted burst still exports to CSV); we deliberately drop it from both
    (api/session.delete_roi docstring). Pin the exact divergence by
    executing the reference."""
    engine, s, ctl = _interaction_pair()
    ref = reference_exec.load()
    for a, b in ((3.0, 5.0), (10.0, 13.0)):
        _add(engine, ctl, engine.ax_signal, a, b)
    target = _ref_patches(engine)[0]
    x = 0.5 * (target[0] + target[1])
    _hover(engine, ctl, engine.ax_signal, x)
    ref.qt_stub.QMenu.next_choice = "Delete"
    try:
        ev_p = _mouse(engine, "button_press_event", engine.ax_signal, x,
                      button=3)
        _dispatch(engine, "button_press_event", ev_p)
        act = ctl.on_press(ev_p.xdata, button=3)
        assert act == "menu"
        ctl.delete_hovered()
    finally:
        ref.qt_stub.QMenu.next_choice = None

    # both sides dropped the patch
    assert _ref_patches(engine) == sorted(map(tuple, ctl.patches()))
    assert len(_ref_patches(engine)) == 1
    # the reference still exports the deleted event; we do not
    assert len(engine.last_detected_events) == 2
    assert len(s.last_detected_events) == 1


def test_roi_merge_unions_only_contained_matches_reference():
    """Merge semantics verified against the executing reference: the union
    covers only patches geometrically CONTAINED in the hovered one
    (PlotEngine.py:567-599) — an overlapping-but-not-contained patch
    survives."""
    engine, s, ctl = _interaction_pair()
    ref = reference_exec.load()
    _add(engine, ctl, engine.ax_signal, 5.0, 15.0)    # container
    _add(engine, ctl, engine.ax_spec, 7.0, 9.0)       # contained
    _add(engine, ctl, engine.ax_signal, 11.0, 12.5)   # contained
    _add(engine, ctl, engine.ax_spec, 14.0, 18.0)     # overlaps, not contained
    x = 6.0  # inside the container only
    _hover(engine, ctl, engine.ax_signal, x)
    ref.qt_stub.QMenu.next_choice = "Merge"
    try:
        ev_p = _mouse(engine, "button_press_event", engine.ax_signal, x,
                      button=3)
        _dispatch(engine, "button_press_event", ev_p)
        assert ctl.on_press(ev_p.xdata, button=3) == "menu"
        ctl.merge_hovered()
    finally:
        ref.qt_stub.QMenu.next_choice = None
    assert _ref_patches(engine) == sorted(map(tuple, ctl.patches()))
    assert sorted(map(tuple, engine.last_detected_events)) == \
        sorted(map(tuple, s.last_detected_events))


# ---------------------------------------------------------------------------
# batch signal PNG export semantics
# ---------------------------------------------------------------------------

class _RecorderPlt:
    """Stands in for ExportManager's module-level pyplot: real Figures (tiny),
    savefig records (path, xlim, ylim, n_samples) instead of rasterizing the
    reference's 3000-dpi output."""

    def __init__(self):
        self.saved = []

    def figure(self, figsize=None):
        from matplotlib.figure import Figure
        fig = Figure(figsize=(2, 1))
        saved = self.saved

        def savefig(path, **kw):
            ax = fig.axes[0]
            saved.append((os.path.basename(str(path)), ax.get_xlim(),
                          ax.get_ylim(), len(ax.lines[0].get_xdata())))
        fig.savefig = savefig
        return fig

    def close(self, fig):
        pass


@pytest.mark.parametrize("use_proc,use_raw", [(False, True), (True, False),
                                              (True, True)])
def test_batch_png_export_semantics_match_reference(tmp_path, use_proc,
                                                    use_raw):
    """export_batch_signals_to_png executing end to end (shared symmetric
    y-limit over every checked stream, processed-over-raw + fs_raw choice,
    raw-without-rate skip, missing-name skip, filename sanitization, the
    fixed 0-300 s window — ExportManager.py:113-189) vs
    export_batch_signals_png: same exported set, and our PNG bytes
    reproduce under the reference's recorded y-limit."""
    import types as _types
    ref = reference_exec.load()
    rng = np.random.RandomState(22)

    entries = {
        "recA_sweep0": dict(raw=rng.randn(4000) * 3.0,
                            proc=rng.randn(4000) * 0.5,
                            fs=1000.0, fs_raw=500.0),
        "recB_sweep0": dict(raw=rng.randn(2000) * 7.0, proc=None,
                            fs=1000.0, fs_raw=None),     # raw has no rate
        "recC_sweep0": dict(raw=rng.randn(3000) * 2.0, proc=None,
                            fs=2000.0, fs_raw=2000.0),
        'we:ird_sweep0': dict(raw=np.ones(100), proc=None,
                              fs=100.0, fs_raw=100.0),   # sanitized name
    }
    names = list(entries) + ["missing_sweep9"]

    mgr = ref.SweepManager()
    reg = SweepRegistry()
    for nm, e in entries.items():
        mgr.data[nm] = {"filepath": "/f", "sweep_idx": 0, "fs": e["fs"],
                        "fs_raw": e["fs_raw"], "raw": e["raw"],
                        "processed": e["proc"]}
        reg.register(nm, SweepEntry("/f", 0, e["fs"], e["fs_raw"],
                                    e["raw"], e["proc"]))

    rec = _RecorderPlt()
    em = ref.ExportManager()
    saved_plt = ref.export_manager_mod.plt
    ref.export_manager_mod.plt = rec
    ref.qt_stub.QFileDialog.next_directory = str(tmp_path / "ref")
    try:
        parent = _types.SimpleNamespace(
            chk_processed=_types.SimpleNamespace(isChecked=lambda: use_proc),
            chk_original=_types.SimpleNamespace(isChecked=lambda: use_raw))
        msg = em.export_batch_signals_to_png(
            None, mgr, [_Item(n) for n in names], parent_widget=parent)
    finally:
        ref.export_manager_mod.plt = saved_plt

    our_dir = tmp_path / "ours"
    from spectral_tpu.api.export import export_batch_signals_png
    our_msg = export_batch_signals_png(str(our_dir), reg, names,
                                       use_proc=use_proc, use_raw=use_raw,
                                       height=64, width=256)

    ref_names = sorted(p for p, _, _, _ in rec.saved)
    our_names = sorted(p.name for p in our_dir.glob("*.png"))
    assert our_names == ref_names, (msg, our_msg)
    assert int(msg.split()[1]) == int(our_msg.split()[1])

    if rec.saved:
        # identical shared symmetric y-limit and the fixed 0-300 s window
        ylims = {y for _, _, y, _ in rec.saved}
        xlims = {x for _, x, _, _ in rec.saved}
        assert xlims == {(0.0, 300.0)}
        assert len(ylims) == 1
        (ylo, yhi), = ylims
        assert ylo == -yhi
        # closing the loop: our written pixels reproduce under the
        # reference's recorded limit
        import jax.numpy as jnp
        from spectral_tpu.render.waveform import waveform_rgba
        from spectral_tpu.ops.colormap import unpack_rgba
        import jax
        nm = next(n for n in entries if f"{n.replace(':', '_')}.png"
                  in our_names or f"{n}.png" in our_names)
        e = entries[nm]
        if use_proc and e["proc"] is not None:
            sig, fs = e["proc"], e["fs"]
        else:
            sig, fs = e["raw"], e["fs_raw"]
        img = waveform_rgba(jnp.asarray(np.asarray(sig, np.float32)),
                            height=64, width=256, y_limit=float(yhi),
                            n_samples_visible=int(300.0 * fs))
        packed = jax.lax.bitcast_convert_type(img, jnp.uint32)
        expected = unpack_rgba(np.asarray(packed)).reshape(64, 256, 4)
        from spectral_tpu.render.png import encode_png
        p_expected = tmp_path / "expected.png"
        encode_png(expected, path=str(p_expected), compress_level=4)
        safe = nm.replace(":", "_")
        assert (our_dir / f"{safe}.png").read_bytes() == \
            p_expected.read_bytes()


# ---------------------------------------------------------------------------
# display-math fuzz: random configs + degenerate inputs per case, the
# reference executing each one
# ---------------------------------------------------------------------------

def _random_case(rng, i):
    """One (signal, settings) draw across the GUI-legal space, salted with
    degenerate shapes."""
    kind = i % 7
    nperseg = int(rng.choice([32, 96, 256, 480, 1024, 2048]))
    fs = float(rng.choice([250.0, 1000.0, 16000.0]))
    nyq = fs / 2
    fmin = float(rng.uniform(0, nyq * 0.3))
    fmax = float(rng.uniform(fmin + nyq * 0.05, nyq * 1.2))  # may exceed nyq
    log_scale = bool(rng.randint(2))
    n = int(rng.randint(nperseg * 3, nperseg * 20))
    sig = rng.randn(n) * rng.uniform(0.01, 10.0)
    if kind == 1:      # short signal: scipy shrinks nperseg to len(sig)
        n = int(rng.randint(8, nperseg))
        sig = rng.randn(n)
    elif kind == 2:    # constant signal (degenerate dB rescale)
        sig = np.full(n, float(rng.uniform(-2, 2)))
    elif kind == 3:    # all zero
        sig = np.zeros(n)
    elif kind == 4:    # empty band: fmin above Nyquist
        fmin, fmax = nyq * 1.05, nyq * 1.3
    elif kind == 5:    # strong tone
        sig = np.sin(2 * np.pi * min(fs / 8, 40.0)
                     * np.arange(n) / fs) * 3.0
    gm = float(rng.uniform(1e-6, 1e2)) if kind == 6 else None
    return sig.astype(np.float64), nperseg, fs, fmin, fmax, log_scale, gm


@pytest.mark.parametrize("trial", range(FUZZ_TRIALS))
def test_display_math_fuzz_matches_reference(trial):
    """_plot_spectrogram executing across the config space incl. the
    degenerate branches (short-signal shrink, empty band early-return
    :122-124, constant/zero inputs, caller-supplied global_max :126)."""
    rng = np.random.RandomState(1000 + FUZZ_SEED + trial)
    sig, nperseg, fs, fmin, fmax, log_scale, gm = _random_case(rng, trial)

    engine = reference_exec.make_engine()
    settings = ref_settings(nperseg=nperseg, fmin=fmin, fmax=fmax,
                            log_scale=log_scale)
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=fs,
                      settings=settings, global_max=gm)

    s = session_with(sig, fs=fs)
    res = s.plot_sweeps(
        ["rec_sweep0"],
        SpecConfig.scipy_default(nperseg, fmin=fmin, fmax=fmax,
                                 log_scale=log_scale),
        ViewSettings(draw_raw=True, draw_proc=False,
                     mode_raw="Spectrogram"),
        global_max=gm)

    np.testing.assert_allclose(res.f, engine.last_f, rtol=0, atol=1e-9)
    if engine.last_Sxx.size == 0:
        # reference early-return: empty band leaves last_t cleared
        assert engine.last_t.size == 0
        assert res.sxx.size == 0 and s.last_t.size == 0
        return
    np.testing.assert_allclose(res.t, engine.last_t, rtol=0, atol=1e-9)
    ref_img = quadmesh_array(engine)
    assert res.image.shape == ref_img.shape
    peak = float(engine.last_Sxx.max()) if engine.last_Sxx.size else 0.0
    if gm is None and peak < 1e-18:
        # no spectral content (e.g. an exactly-constant input): the
        # reference's +1e-20 floor (PlotEngine.py:127) blanks its f64
        # detrend residue; an f32 pipeline's residue sits above the floor
        # and normalizes to quantization noise — pinned as a documented
        # boundary in test_constant_signal_display_is_f32_boundary
        assert np.all(ref_img < 1e-4)
        assert np.all((res.image >= 0) & (res.image <= 1))
        return
    # image tolerance: the display contract is ~1e-3 dB before the min-max
    # rescale; a log rescale over a tone's ~150 dB leakage floor amplifies
    # that into the low 1e-3 normalized range
    np.testing.assert_allclose(res.image, ref_img,
                               atol=3e-3 if log_scale else 5e-4,
                               err_msg=f"case {trial}: nperseg={nperseg} "
                                       f"fs={fs} band=({fmin},{fmax}) "
                                       f"log={log_scale} gm={gm}")
    # PSD error relative to the image peak (bin-relative error on leakage
    # floors 20+ orders below the peak is meaningless in f32)
    err = np.max(np.abs(res.sxx - engine.last_Sxx)) / max(peak, 1e-30) \
        if res.sxx.size else 0.0
    assert err < 1e-4, (trial, err)


def test_constant_signal_display_is_f32_boundary():
    """A constant (non-zero) input has no spectral content: the reference's
    f64 detrend residue squares to ~1e-24 and its +1e-20 normalization floor
    (PlotEngine.py:127) renders near-BLACK; a float32 pipeline's residue
    (~1e-7 relative, squared ~1e-14) clears that floor and normalizes to
    visible quantization noise. Deliberate, hardware-inherent deviation —
    pinned by executing both on a constant that is NOT exactly
    f32-representable (1.3). For an exactly-representable constant (1.375)
    the f32 detrend residue is exactly zero and BOTH render black, as the
    second half proves; exactly-zero inputs likewise match (fuzz kind-3)."""
    sig = np.full(6000, 1.3)
    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings(log_scale=False))
    ref_img = quadmesh_array(engine)
    assert float(ref_img.max()) < 1e-6  # reference: black

    s = session_with(sig)
    res = s.plot_sweeps(["rec_sweep0"], our_config(log_scale=False),
                        ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    assert np.all((res.image >= 0) & (res.image <= 1))
    assert float(np.max(res.image)) > 1e-3  # ours: visible residue noise

    # exactly-f32-representable constant: residue is exactly zero on both
    # sides — the degenerate all-zero gate (core/scale.py) matches the
    # reference's floored black
    sig2 = np.full(6000, 1.375)
    engine2 = reference_exec.make_engine()
    engine2.plot_extra(signal_raw=sig2, signal_proc=None, fs=FS,
                       settings=ref_settings(log_scale=False))
    assert float(quadmesh_array(engine2).max()) < 1e-6
    s2 = session_with(sig2)
    res2 = s2.plot_sweeps(["rec_sweep0"], our_config(log_scale=False),
                          ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    assert float(np.max(res2.image)) == 0.0


@pytest.mark.parametrize("bad,log_scale", [
    (np.nan, False), (np.nan, True),
    (np.inf, False), (np.inf, True),
    (-np.inf, False), (-np.inf, True),
])
def test_nonfinite_sample_propagation_matches_reference(bad, log_scale):
    """A single NaN/Inf sample contaminates exactly the frames that touch
    it. Linear scale: the reference's clip leaves those pixels NaN
    (matplotlib masks them); our NaN mask must coincide pixel-for-pixel and
    the uncontaminated pixels must still match. Log scale: the reference's
    nan_to_num (PlotEngine.py:129) folds the bad pixels to db=0 before the
    min-max rescale — images must match everywhere. (Inf first becomes NaN
    in BOTH pipelines via the constant detrend: mean(inf-laden segment) is
    inf and inf-inf is NaN, scipy _spectral_py detrend == our framing.)"""
    rng = np.random.RandomState(7)
    sig = rng.randn(6000)
    sig[2345] = bad

    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=sig, signal_proc=None, fs=FS,
                      settings=ref_settings(log_scale=log_scale))
    ref_img = quadmesh_array(engine)

    s = session_with(sig)
    res = s.plot_sweeps(["rec_sweep0"], our_config(log_scale=log_scale),
                        ViewSettings(draw_raw=True, mode_raw="Spectrogram"))
    img = np.asarray(res.image)
    assert img.shape == ref_img.shape

    ref_bad = np.isnan(ref_img)
    our_bad = np.isnan(img)
    if log_scale:
        assert not ref_bad.any() and not our_bad.any()
        np.testing.assert_allclose(img, ref_img, atol=1e-3)
    else:
        assert ref_bad.any()  # the contamination is real in this fixture
        np.testing.assert_array_equal(our_bad, ref_bad)
        np.testing.assert_allclose(img[~our_bad], ref_img[~ref_bad],
                                   atol=5e-4)


def test_decorated_figure_artists_match_reference():
    """The 2-row figure's TIME-DOMAIN layer, artist for artist, against the
    reference's executing plot_extra (PlotEngine.py:78-94): line count,
    colors, labels, sample data, ylabel, legend placement/zorder — then the
    detection spans (plot_detection_lines :655-667) on both axes: extents,
    facecolor incl. alpha 0.5, zorder 10. The display-image differential
    covers the mesh; this covers everything drawn around it."""
    from matplotlib import colors as mcolors

    rng = np.random.RandomState(7)
    raw = burst_signal(rng, n=12_000)
    proc = 0.5 * burst_signal(rng, n=12_000)
    events = [(2.0, 3.5), (7.25, 9.0)]

    engine = reference_exec.make_engine()
    engine.plot_extra(signal_raw=raw, signal_proc=proc, fs=FS,
                      settings=ref_settings(draw_proc=True, mode_raw="Both",
                                            mode_proc="Both"))
    engine.plot_detection_lines(events)

    s = session_with(raw, sig_proc=proc)
    s.plot_sweeps(["rec_sweep0"], our_config(),
                  ViewSettings(draw_raw=True, draw_proc=True,
                               mode_raw="Both", mode_proc="Both"))
    from spectral_tpu.render.figure import SessionFigureView
    view = SessionFigureView()
    view.rebuild(s)
    view.update_overlays(events)

    ref_lines = engine.ax_signal.get_lines()
    our_lines = view.ax_signal.get_lines()
    assert len(ref_lines) == len(our_lines) == 2
    for rl, ol in zip(ref_lines, our_lines):
        assert mcolors.to_rgba(rl.get_color()) == \
            mcolors.to_rgba(ol.get_color())
        assert rl.get_label() == ol.get_label()
        np.testing.assert_array_equal(rl.get_xdata(), ol.get_xdata())
        # the registry stores float32 (device dtype); the reference plots
        # the float64 input — identical samples at f32 resolution
        np.testing.assert_allclose(rl.get_ydata(), ol.get_ydata(),
                                   rtol=0, atol=1e-6)

    assert engine.ax_signal.get_ylabel() == view.ax_signal.get_ylabel()
    ref_leg = engine.ax_signal.get_legend()
    our_leg = view.ax_signal.get_legend()
    assert ref_leg is not None and our_leg is not None
    assert ref_leg._loc == our_leg._loc  # 'upper right'
    assert ref_leg.get_zorder() == our_leg.get_zorder() == 100
    assert [t.get_text() for t in ref_leg.get_texts()] == \
        [t.get_text() for t in our_leg.get_texts()]

    def span_facts(ax):
        out = []
        for p in ax.patches:
            if hasattr(p, "get_width"):  # mpl >= 3.8: axvspan -> Rectangle
                lo, hi = p.get_x(), p.get_x() + p.get_width()
            else:                        # Polygon
                xs = p.get_xy()[:, 0]
                lo, hi = xs.min(), xs.max()
            out.append((float(lo), float(hi),
                        p.get_facecolor(), p.get_zorder()))
        return sorted(out)

    for ref_ax, our_ax in ((engine.ax_signal, view.ax_signal),
                           (engine.ax_spec, view.ax_spec)):
        ref_spans, our_spans = span_facts(ref_ax), span_facts(our_ax)
        assert len(ref_spans) == len(our_spans) == len(events)
        for (ra, rb, rc, rz), (oa, ob, oc, oz) in zip(ref_spans, our_spans):
            assert (ra, rb) == (oa, ob)
            assert rc == oc          # rgba incl. the 0.5 alpha
            assert rz == oz == 10


def test_plot_single_signal_matches_reference():
    """PlotEngine.plot_single_signal (:215-227) vs render_single_signal:
    the reference's OWN executing code sets the axes; ours must agree on
    labels, line data, and the log-scale branch."""
    from spectral_tpu.render.figure import render_single_signal
    rng = np.random.RandomState(5)
    sig = np.abs(rng.randn(4000)).astype(np.float32) + 0.5
    engine = reference_exec.make_engine()
    for use_log in (False, True):
        engine.plot_single_signal("rec_sweep0", sig, FS, use_log=use_log)
        # clear() re-creates the 2-row layout and add_subplot(111) appends:
        # the single-signal axes is the LAST one on the reference figure
        ref_ax = engine.fig.axes[-1]
        fig = render_single_signal("rec_sweep0", sig, FS, use_log=use_log)
        ax = fig.axes[0]
        assert ax.get_xlabel() == ref_ax.get_xlabel()
        assert ax.get_ylabel() == ref_ax.get_ylabel()
        assert ax.get_yscale() == ref_ax.get_yscale()
        np.testing.assert_array_equal(ax.lines[0].get_xdata(),
                                      ref_ax.lines[0].get_xdata())
        np.testing.assert_array_equal(ax.lines[0].get_ydata(),
                                      ref_ax.lines[0].get_ydata())
