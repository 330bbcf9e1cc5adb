"""Event / feature / band-power algebra.

Pure reimplementations of the reference's analysis-layer semantics:

  * features:        PlotEngine._calculate_features   (PlotEngine.py:229-242)
  * baseline scan:   unsupervised state->events       (PlotEngine.py:449-470)
  * label scan:      supervised  state->events        (PlotEngine.py:313-321)
  * interval merge:  _merge_overlapping_events        (PlotEngine.py:669-684)
  * band powers:     calculate_band_powers            (PlotEngine.py:692-719)
  * absolute power:  calculate_absolute_power         (PlotEngine.py:686-690)
  * ROI editing ops: add/delete/merge-contained       (PlotEngine.py:608-645,
                     :553-606) as pure functions on event lists

The scans operate on tiny (T ~ 1e2-1e4) state sequences; event extraction is
done with exact host-side numpy loops mirroring the reference's control flow
bit-for-bit, while the heavy feature computation stays in jnp on device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array
Event = Tuple[float, float]

# Default EEG bands (PlotEngine.py:698-706).
EEG_BANDS: Dict[str, Tuple[float, float]] = {
    "Delta (δ)": (0, 4),
    "Theta (θ)": (4, 8),
    "Alpha (α)": (8, 13),
    "Beta (β)": (13, 30),
    "Gamma (γ)": (30, 80),
    "HFO (ripples)": (80, 250),
}


# ---------------------------------------------------------------------------
# Features (device)
# ---------------------------------------------------------------------------

@jax.jit
def _features_core(psd_tf: Array, w: Array) -> Array:
    # HIGHEST: a default-precision einsum may round the operands (bf16 on
    # the previous accelerator cost ~4e-3 relative; TF32 on the GPU) —
    # outside this module's 2e-4 feature contract (and these reductions
    # are never the hot path).
    power = jnp.einsum("...tf,f->...t", psd_tf.astype(jnp.float32), w,
                       precision=jax.lax.Precision.HIGHEST)
    return features_from_band_power(power)


def features_from_band_power(power: Array) -> Array:
    """(..., T) per-frame band power -> (..., T, 2) HMM features: the exact
    PlotEngine.py:238-242 arithmetic (log10(power + 1e-20) and its
    prepend-first np.diff) applied to an already-reduced band power — the
    streaming path (parallel/streaming.stream_features) folds the PSD down
    to this on device without ever materializing it."""
    log_power = jnp.log10(power + 1e-20)
    delta = jnp.diff(log_power, axis=-1,
                     prepend=log_power[..., :1])
    return jnp.stack([log_power, delta], axis=-1)


def features_from_psd(f: np.ndarray, psd_tf: Array, fmin: float, fmax: float
                      ) -> Array:
    """HMM features from a frame-major PSD (..., T, F) -> (..., T, 2).

    Mirrors PlotEngine.py:238-242: per-frame band power = sum of PSD rows in
    [fmin, fmax]; feature 0 = log10(power + 1e-20); feature 1 = delta of
    feature 0 with the first value prepended (np.diff(..., prepend=x[0])).

    The compute core is jitted (one dispatch instead of five eager ones —
    this sits on the interactive detect path).
    """
    f = np.asarray(f)
    mask = (f >= fmin) & (f <= fmax)
    w = jnp.asarray(mask.astype(np.float32))
    return _features_core(psd_tf, w)


# ---------------------------------------------------------------------------
# State-sequence -> event-interval scans (host, exact)
# ---------------------------------------------------------------------------

def baseline_scan(states: np.ndarray, t: np.ndarray, baseline_state: int
                  ) -> List[Event]:
    """Unsupervised scan (PlotEngine.py:447-470).

    An event opens at t[i-1] (the last baseline point) when the state leaves
    baseline, closes at t[i-1] (the last non-baseline point) when it returns,
    is kept only if end > start, and an open event at the end of the sequence
    closes at t[-1].
    """
    states = np.asarray(states)
    t = np.asarray(t)
    events: List[Event] = []
    in_event, start_time = False, 0.0
    for i in range(1, len(states)):
        is_base = states[i] == baseline_state
        was_base = states[i - 1] == baseline_state
        if not in_event and was_base and not is_base:
            in_event = True
            start_time = float(t[i - 1])
        elif in_event and is_base and not was_base:
            in_event = False
            end_time = float(t[i - 1])
            if end_time > start_time:
                events.append((start_time, end_time))
    if in_event:
        events.append((start_time, float(t[-1])))
    return events


def label_scan(states: np.ndarray, t: np.ndarray) -> List[Event]:
    """Supervised scan (PlotEngine.py:313-321).

    States {1, 2} open an event at t[i]; state 0 closes it at t[i] (kept only
    if t[i] > start). State 3 neither opens nor closes. An open event at the
    end closes at t[-1].
    """
    states = np.asarray(states)
    t = np.asarray(t)
    events: List[Event] = []
    in_event, start_time = False, 0.0
    for i in range(len(states)):
        if not in_event and states[i] in (1, 2):
            in_event, start_time = True, float(t[i])
        elif in_event and states[i] == 0:
            in_event = False
            if t[i] > start_time:
                events.append((start_time, float(t[i])))
    if in_event:
        events.append((start_time, float(t[-1])))
    return events


def merge_overlapping_events(events: Sequence[Event], tolerance: float = 1e-6
                             ) -> List[Event]:
    """Sort by start; merge intervals overlapping within tolerance
    (PlotEngine.py:669-684)."""
    if not events:
        return []
    ev = sorted(events, key=lambda x: x[0])
    merged = [ev[0]]
    for cur_start, cur_end in ev[1:]:
        last_start, last_end = merged[-1]
        if cur_start <= last_end + tolerance:
            merged[-1] = (last_start, max(last_end, cur_end))
        else:
            merged.append((cur_start, cur_end))
    return merged


# ---------------------------------------------------------------------------
# Supervised label track construction (PlotEngine.py:301-308)
# ---------------------------------------------------------------------------

def build_label_track(t: np.ndarray, bursts: Sequence[Event]) -> np.ndarray:
    """4-state labels: 0 baseline, 1 onset sample, 2 interior, 3 offset sample.

    For each precise burst (start_t, end_t): start_idx/end_idx via
    np.searchsorted; skip if start_idx >= end_idx; labels[start_idx] = 1;
    labels[start_idx+1:end_idx] = 2 when end_idx > start_idx+1; labels[end_idx]
    = 3 when end_idx < len(labels).
    """
    t = np.asarray(t)
    labels = np.zeros(len(t), dtype=int)
    for start_t, end_t in bursts:
        start_idx, end_idx = np.searchsorted(t, start_t), np.searchsorted(t, end_t)
        if start_idx >= end_idx:
            continue
        labels[start_idx] = 1
        if end_idx > start_idx + 1:
            labels[start_idx + 1:end_idx] = 2
        if end_idx < len(labels):
            labels[end_idx] = 3
    return labels


# ---------------------------------------------------------------------------
# Band powers / absolute power
# ---------------------------------------------------------------------------

def absolute_power(sxx) -> float:
    """Total power = sum of the (masked) PSD (PlotEngine.py:686-690).

    Host numpy on purpose: the session passes its host-resident last_sxx,
    and a jnp.sum here would upload the full PSD and compile a device
    reduction per shape just to sum an
    array already in host memory — same rule as band_powers below."""
    return float(np.sum(np.asarray(sxx)))


def band_powers(f: np.ndarray, sxx, bands: Optional[Dict[str, Tuple[float, float]]] = None
                ) -> Dict[str, float]:
    """Relative band powers (PlotEngine.py:692-719).

    Sxx is clamped to >= 0; band mask is f >= low AND f < high (upper edge
    exclusive); relative power = band sum / total sum; if the total is below
    1e-18 every band reports 0.0.
    """
    if bands is None:
        bands = EEG_BANDS
    f = np.asarray(f)
    # One device->host transfer, then pure numpy: the per-band reductions are
    # tiny, and issuing them as separate device ops costs a compile per band.
    sxx_lin = np.maximum(0.0, np.asarray(sxx))
    total = float(sxx_lin.sum())
    if total < 1e-18:
        return {name: 0.0 for name in bands}
    out: Dict[str, float] = {}
    for name, (low, high) in bands.items():
        mask = (f >= low) & (f < high)
        band = float(sxx_lin[mask, :].sum()) if mask.any() else 0.0
        out[name] = float(np.clip(band / total, 0.0, None))
    return out


def band_powers_device(f: np.ndarray, psd_tf: Array,
                       band_edges: Sequence[Tuple[float, float]]) -> Array:
    """Batched on-device variant: frame-major PSD (..., T, F) -> (..., B bands).

    Same semantics as band_powers but jit/vmap-friendly with static band
    edges; returns relative powers (zeros when total < 1e-18).
    """
    f = np.asarray(f)
    masks = np.stack([((f >= lo) & (f < hi)).astype(np.float32)
                      for lo, hi in band_edges])  # (B, F)
    sxx_lin = jnp.maximum(0.0, psd_tf)
    total = jnp.sum(sxx_lin, axis=(-2, -1))  # (...,)
    band = jnp.einsum("...tf,bf->...b", sxx_lin, jnp.asarray(masks),
                      precision=jax.lax.Precision.HIGHEST)
    rel = band / jnp.maximum(total[..., None], 1e-30)
    return jnp.where(total[..., None] < 1e-18, jnp.zeros_like(rel), rel)


# ---------------------------------------------------------------------------
# ROI editing operations (pure-function equivalents of PlotEngine's
# interaction layer; SURVEY.md §7 de-scopes the mouse UX, not the ops)
# ---------------------------------------------------------------------------

def add_roi(events: Sequence[Event], start: float, end: float,
            min_width: float) -> List[Event]:
    """Add a drawn ROI (PlotEngine.on_release, :626-642): endpoints are
    sorted, and the ROI is dropped if narrower than one sample period."""
    ev = list(events)
    if abs(start - end) >= min_width:
        ev.append((min(start, end), max(start, end)))
    return ev


def delete_roi(events: Sequence[Event], roi: Event) -> List[Event]:
    """Delete one ROI (PlotEngine.remove_patch semantics, :647-653)."""
    ev = list(events)
    if roi in ev:
        ev.remove(roi)
    return ev


def merge_contained_rois(events: Sequence[Event], container: Event
                         ) -> List[Event]:
    """Context-menu Merge (PlotEngine.on_press, :565-599).

    ROIs geometrically contained in the hovered container are replaced by
    their union (min start, max end); the container itself is removed too.
    If nothing is contained, the list is returned unchanged. Result is sorted
    (the reference sorts last_detected_events at :598).
    """
    contained = [e for e in events
                 if e != container and e[0] >= container[0] and e[1] <= container[1]]
    if not contained:
        return list(events)
    to_remove = set(contained) | {container}
    kept = [e for e in events if e not in to_remove]
    new_event = (min(s for s, _ in contained), max(e for _, e in contained))
    kept.append(new_event)
    return sorted(kept)
