"""Burst detection flows: headless equivalents of the reference's
PlotEngine.unsupervised_detect (PlotEngine.py:411-473) and
PlotEngine.learn_and_detect (:244-326), with the HMM state factored out of the
rendering layer (SURVEY.md §1 calls out that coupling as the reference's main
architectural weak point).
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.core import events as ev
from spectral_tpu.models import hmm, hmm_pscan

Event = Tuple[float, float]

# one persistent jit wrapper so repeated decodes hit the compilation cache
# (a fresh jax.jit(...) per call would retrace every time)
_viterbi_jit = jax.jit(hmm.viterbi)


def _engine(parallel: bool):
    """Sequential lax.scan engine (reference-parity) or the parallel-prefix
    engine (models/hmm_pscan.py): same contracts, O(log T) vs O(T) depth."""
    return hmm_pscan if parallel else hmm


def _check_finite_features(X: np.ndarray) -> None:
    """Refuse non-finite feature matrices like the reference stack does
    (hmmlearn -> sklearn check_array raises on NaN/Inf at
    PlotEngine.py:432 model.fit). Without this an overflowed float32
    PSD — e.g. a ~1e18-amplitude waveform, whose power exceeds f32 max —
    flowed NaN through KMeans/EM and silently reported ZERO events."""
    if not np.isfinite(X).all():
        raise ValueError(
            "features contain NaN/Inf; if the input waveform is finite, "
            "its power overflows float32 analysis — rescale the signal "
            "(the analysis is scale-invariant)")


@functools.partial(jax.jit, static_argnames=("parallel",))
def _viterbi_packed(params: hmm.HMMParams, X, parallel: bool = False):
    """Refined-model decode in one dispatch + ONE readback: states and the
    baseline state (argmin mean log-power, PlotEngine.py:445) packed into
    a single array — fetching params.means separately for a host argmin
    costs its own device->host round trip."""
    states = _engine(parallel).viterbi(params, X)
    baseline = jnp.argmin(params.means[:, 0])
    return jnp.concatenate([states, baseline[None].astype(states.dtype)])


@functools.partial(jax.jit, static_argnames=("n_iter", "parallel"))
def _fused_detect_packed(params0: hmm.HMMParams, X, n_iter: int,
                         parallel: bool = False):
    """unsupervised_fit_decode with states and baseline packed into ONE
    output array: every device->host fetch is a separate round trip, so
    the warm interactive path reads the whole decode ([states...,
    baseline]) in a single np.asarray."""
    params, states, baseline, _ll, _it = _engine(
        parallel).unsupervised_fit_decode(params0, X, n_iter=n_iter)
    return params, jnp.concatenate([states,
                                    baseline[None].astype(states.dtype)])


class BurstDetector:
    """Holds the persistent 4-state Gaussian HMM and its refinement flag
    (PlotEngine.py:20-21: GaussianHMM(4, diag, n_iter=100, random_state=42),
    is_model_refined)."""

    # Below this many feature elements a SEQUENTIAL-engine problem runs on
    # host CPU: EM on a hundred-frame sequence is dominated by accelerator
    # round-trips, not compute. Parallel-engine problems always prefer the
    # accelerator (see _uses_cpu). The value was set for the previous
    # accelerator, reached over a slow link, and is not measured on the
    # H100 (ROADMAP S6).
    AUTO_CPU_THRESHOLD = 262144

    # At or above this many FRAMES, engine='auto' switches to the
    # parallel-prefix HMM (models/hmm_pscan.py) on EVERY backend. This is
    # a CORRECTNESS threshold, not a speed knob: the sequential f32
    # E-step materializes -O(T) log alpha/beta whose rounding destroys
    # the sufficient statistics as T grows — max |gamma - f64 oracle|
    # measured 0.012 at T=601, 0.059 at 2048, 1.3 at 4096, and at 65536
    # gamma overflows to inf outright, while the pscan E-step holds
    # ~1.7e-7 at every T (its rescaled blocks never see the offsets; see
    # hmm_pscan.py). Its speed on the H100 is not measured yet; on XLA:CPU
    # pscan is ~4-5x slower than the scan engine, which is the price of
    # correct statistics — the reference's ~600-frame sweeps stay on the
    # (hmmlearn-parity, accurate-at-that-scale) sequential engine.
    PSCAN_THRESHOLD = hmm_pscan.SEQ_SAFE_T

    def __init__(self, n_states: int = 4, n_iter: int = 100, seed: int = 42,
                 device: str = "auto", engine: str = "auto"):
        """device: 'auto' (CPU for small problems, default backend otherwise),
        'cpu', or 'default'. engine: 'auto' (parallel-prefix HMM for
        sequences of >= PSCAN_THRESHOLD frames), 'scan' (always sequential),
        or 'pscan' (always parallel-prefix)."""
        if engine not in ("auto", "scan", "pscan"):
            raise ValueError(f"unknown engine {engine!r}")
        self.n_states = n_states
        self.n_iter = n_iter
        self.seed = seed
        self.device = device
        self.engine = engine
        self.params: Optional[hmm.HMMParams] = None
        self.is_model_refined = False

    def _parallel(self, T: int) -> bool:
        if self.engine == "pscan":
            return True
        return self.engine == "auto" and T >= self.PSCAN_THRESHOLD

    def _uses_cpu(self, n_elems: int, parallel: bool = False) -> bool:
        if self.device == "cpu":
            return True
        if self.device != "auto":
            return False
        # auto: parallel-engine problems always prefer the accelerator
        # (fast there even just above the threshold — the engine exists
        # for T where the f32 sequential statistics are wrong, and on
        # host it pays ~4-5x the scan engine's time); sequential
        # problems below the dispatch-amortization cap stay on host
        return (not parallel) and n_elems < self.AUTO_CPU_THRESHOLD

    def _device_ctx(self, n_elems: int, parallel: bool = False):
        import jax
        if self._uses_cpu(n_elems, parallel):
            return jax.default_device(jax.devices("cpu")[0])
        import contextlib
        return contextlib.nullcontext()

    def reset(self) -> None:
        """PlotEngine.reset_model (:475-478)."""
        self.params = None
        self.is_model_refined = False

    # ------------------------------------------------------------------
    # Warm-start: precompile the detection programs for a feature shape
    # ------------------------------------------------------------------

    _warmed: set = set()            # (T, D, n_states, n_iter) per process

    def warmup(self, T: int, D: int = 2, background: bool = True) -> None:
        """Precompile the fused fit+patch+Viterbi and the standalone
        Viterbi for feature shape (T, D) on the backend this problem size
        will use, so the first interactive detection after a plot pays no
        compile latency. Shape-only AOT lowering — no data, no
        execution. Keyed per shape; jax's jit cache plus the persistent
        compilation cache make repeats free."""
        par = self._parallel(int(T))
        key = (int(T), int(D), self.n_states, self.n_iter, self.device, par)
        if T <= 0 or key in BurstDetector._warmed:
            return
        BurstDetector._warmed.add(key)

        def _compile():
            try:
                with self._device_ctx(T * D, par):
                    X = jax.ShapeDtypeStruct((T, D), jnp.float32)
                    K = self.n_states
                    p = hmm.HMMParams(
                        startprob=jax.ShapeDtypeStruct((K,), jnp.float32),
                        transmat=jax.ShapeDtypeStruct((K, K), jnp.float32),
                        means=jax.ShapeDtypeStruct((K, D), jnp.float32),
                        covars=jax.ShapeDtypeStruct((K, D), jnp.float32))
                    _fused_detect_packed.lower(
                        p, X, n_iter=self.n_iter, parallel=par).compile()
                    _viterbi_packed.lower(p, X, parallel=par).compile()
            except Exception:       # warmup must never break detection
                BurstDetector._warmed.discard(key)

        if background:
            # non-daemon ON PURPOSE: the interpreter joins it at exit, so a
            # script that plots and exits immediately waits for the compile
            # to finish instead of killing the thread mid-XLA-compile —
            # which aborts runtime teardown ("FATAL: exception not
            # rethrown"). The wait is one
            # (persistently cached) compile, and only programs that never
            # detect pay it; pass AnalysisSession(warm_detection=False)
            # to opt out entirely. Known tradeoff: a long-lived client
            # (e.g. the GUI) that exits RIGHT after its first plot blocks
            # until that compile finishes; the CLI one-shots and the serve
            # worker already construct sessions with warm_detection=False.
            threading.Thread(target=_compile, daemon=False,
                             name="detector-warmup").start()
        else:
            _compile()

    # ------------------------------------------------------------------
    # Unsupervised detection (PlotEngine.py:411-473)
    # ------------------------------------------------------------------

    def unsupervised_detect(self, t: np.ndarray, features) -> List[Event]:
        t = np.asarray(t)
        if t.size == 0:
            return []
        feats_np = np.asarray(features, np.float32)
        _check_finite_features(feats_np)

        par = self._parallel(feats_np.shape[0])
        with self._device_ctx(feats_np.size, par):
            X = jnp.asarray(feats_np)
            if not self.is_model_refined:
                if X.shape[0] < self.n_states:
                    raise ValueError(
                        "Not enough data to train the model. Signal may be too short.")
                params0 = hmm.init_params(X, self.n_states, seed=self.seed)
                # fit + escape-route patch + baseline + Viterbi in ONE
                # dispatch (dispatch latency can dominate compute at this
                # size) and ONE readback: states and the baseline
                # state (PlotEngine.py:445) come back packed in a single
                # array — separate fetches of states / baseline /
                # params.means each cost their own device->host round trip
                self.params, packed_d = _fused_detect_packed(
                    params0, X, n_iter=self.n_iter, parallel=par)
                packed = np.asarray(packed_d)
                states, baseline_state = packed[:-1], int(packed[-1])
            else:
                packed = np.asarray(_viterbi_packed(
                    self.params, X, parallel=par))
                states, baseline_state = packed[:-1], int(packed[-1])
        events = ev.baseline_scan(states, t, baseline_state)
        return ev.merge_overlapping_events(events)

    # ------------------------------------------------------------------
    # Semi-supervised "learn from examples" (PlotEngine.py:244-326)
    # ------------------------------------------------------------------

    def learn_and_detect(self, t: np.ndarray, features,
                         rois: Sequence[Event]) -> List[Event]:
        if not rois:
            raise ValueError("No manual regions provided to learn from.")
        t = np.asarray(t)
        X = np.asarray(features, dtype=np.float32)
        _check_finite_features(X)

        precise_bursts: List[Event] = []
        for roi_start_t, roi_end_t in rois:
            idx = np.where((t >= roi_start_t) & (t <= roi_end_t))[0]
            if len(idx) < 2:  # PlotEngine.py:279-281
                continue
            pb = self._find_burst_in_roi(X[idx, :], t[idx])
            if pb:
                precise_bursts.append(pb)

        if not precise_bursts:
            raise ValueError(
                "Could not identify a clear burst in any of the provided regions.")

        labels = ev.build_label_track(t, precise_bursts)
        self.params = hmm.supervised_fit(X, labels, self.n_states)
        self.is_model_refined = True  # PlotEngine.py:387

        par = self._parallel(X.shape[0])
        with self._device_ctx(X.size, par):
            # decode through the same packed program warmup() precompiled
            # (the baseline element is unused here — label_scan semantics);
            # a distinct jit entry would pay a fresh compile on the first
            # Refine Model click, exactly the latency warmup exists to hide
            packed = np.asarray(_viterbi_packed(
                self.params, jnp.asarray(X), parallel=par))
        events = ev.label_scan(packed[:-1], t)
        return ev.merge_overlapping_events(events)

    def _find_burst_in_roi(self, roi_features: np.ndarray, roi_t: np.ndarray
                           ) -> Optional[Event]:
        """2-state HMM burst localization in one ROI (PlotEngine.py:389-409).

        Note the reference's guard compares against the MAIN model's
        n_components (4), not the temp model's 2 — reproduced here.
        """
        if len(roi_features) < self.n_states:
            return None
        # ROIs are normally a few hundred frames (the parity regime), but a
        # user CAN sweep an ROI across a long recording — route those
        # through the parallel engine too (the sequential f32 E-step is
        # wrong from ~2k frames; see PSCAN_THRESHOLD)
        par = self._parallel(len(roi_features))
        eng = _engine(par)
        with self._device_ctx(roi_features.size, par):
            X = jnp.asarray(roi_features, jnp.float32)
            try:
                params0 = hmm.init_params(X, 2, seed=self.seed)
                params, _, _ = eng.fit(params0, X, n_iter=50)
            except (ValueError, FloatingPointError):
                return None
            means = np.asarray(params.means)
            burst_state = int(np.argmax(means[:, 0]))  # larger mean log-power
            states = np.asarray(jax.jit(eng.viterbi)(params, X)
                                if par else _viterbi_jit(params, X))
        burst_idx = np.where(states == burst_state)[0]
        if len(burst_idx) == 0:
            return None
        return float(roi_t[burst_idx[0]]), float(roi_t[burst_idx[-1]])
