"""Batched burst detection over many sweeps/clips.

The reference detects on one plotted signal at a time (PlotEngine.py:411).
Production fleets run the unsupervised flow over thousands of clips: the EM
fit and Viterbi decode are vmapped into single device launches (sharding the
batch over a mesh composes via parallel.sharding), with only the tiny
state-sequence -> interval scans left on host.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.core import events as ev
from spectral_tpu.models import hmm, hmm_pscan

Event = Tuple[float, float]

# persistent jit wrappers: a fresh jax.jit(lambda ...) per call would key
# the jit cache on the new lambda object and RETRACE and recompile every
# invocation (same rationale as models/detector.py::_viterbi_jit)


def _fused_one(p, x, n, parallel=False):
    """Per-clip fit + escape-patch + baseline + Viterbi, states and baseline
    packed into one (T+1,) array so the whole batch comes back to host in a
    single readback (same packing as detector._fused_detect_packed).
    parallel selects the engine by per-clip length, same correctness rule
    as detector.PSCAN_THRESHOLD (the sequential f32 E-step is wrong from
    ~2k frames — models/hmm_pscan.py)."""
    eng = hmm_pscan if parallel else hmm
    _params, states, baseline, _ll, _it = eng.unsupervised_fit_decode(
        p, x, n_iter=n)
    return jnp.concatenate([states, baseline[None].astype(states.dtype)])


_fused_detect_v = jax.jit(jax.vmap(_fused_one, in_axes=(0, 0, None, None)),
                          static_argnums=(2, 3))
_viterbi_shared = jax.jit(jax.vmap(hmm.viterbi, in_axes=(None, 0)))
_viterbi_shared_ps = jax.jit(jax.vmap(hmm_pscan.viterbi, in_axes=(None, 0)))


def batch_unsupervised_detect(t: np.ndarray, feats: np.ndarray,
                              n_states: int = 4, n_iter: int = 100,
                              seed: int = 42) -> List[List[Event]]:
    """Run the full unsupervised flow per clip over a batch.

    t: (T,) shared frame times; feats: (B, T, D). Returns per-clip merged
    event lists. Mirrors PlotEngine.unsupervised_detect per clip: EM fit,
    escape-route transmat patch, Viterbi, baseline scan, merge.
    """
    feats = np.asarray(feats, np.float32)
    B, T, D = feats.shape
    if not np.isfinite(feats).all():
        # same refusal as the sequential flow
        # (models/detector.py::_check_finite_features): NaN features flow
        # through KMeans/EM without error and silently decode ZERO events.
        # Callers that want per-clip fault isolation (cli
        # _detect_each_batched) filter non-finite clips out first.
        bad = np.where(~np.isfinite(feats).reshape(B, -1).all(axis=1))[0]
        raise ValueError(
            f"features contain NaN/Inf (clips {bad.tolist()[:8]}"
            f"{'...' if bad.size > 8 else ''}); if the input waveforms "
            "are finite, their power overflows float32 analysis — "
            "rescale the signals (the analysis is scale-invariant)")
    if T < n_states:
        # same guard and message as the sequential flow
        # (models/detector.py::unsupervised_detect) so `detect --each
        # --batched` skip lines match the unbatched output
        raise ValueError(
            "Not enough data to train the model. Signal may be too short.")

    inits = [hmm.init_params(feats[b], n_states, seed=seed) for b in range(B)]
    params0 = jax.tree.map(lambda *a: jnp.stack(a), *inits)

    # fit + escape patch + baseline + Viterbi fused into ONE device
    # dispatch (vmapped unsupervised_fit_decode — the patch runs traced via
    # patch_escape_routes_traced, identical arithmetic to the host loop it
    # replaced) and ONE (B, T+1) readback: the two-dispatch form with a
    # host-side patch in between paid an extra dispatch plus two extra
    # device<->host transfers per batch
    packed = np.asarray(_fused_detect_v(params0, jnp.asarray(feats), n_iter,
                                        T >= hmm_pscan.SEQ_SAFE_T))
    states, baselines = packed[:, :-1], packed[:, -1]

    out: List[List[Event]] = []
    for b in range(B):
        evs = ev.baseline_scan(states[b], t, int(baselines[b]))
        out.append(ev.merge_overlapping_events(evs))
    return out


def batch_viterbi_detect(params: hmm.HMMParams, t: np.ndarray,
                         feats: np.ndarray, scan: str = "label"
                         ) -> List[List[Event]]:
    """Decode a batch with one shared model.

    scan='label': the learn_and_detect semantics (states {1,2} open, 0
    closes) — appropriate for supervised-fit models, which generalize only
    to clips with closely matching onset statistics (the tight per-state
    variance floors are reference-faithful, PlotEngine.py:328-355).
    scan='baseline': the unsupervised semantics with baseline =
    argmin(mean log-power) — the robust choice for EM-fitted shared models.
    """
    vit = (_viterbi_shared_ps
           if feats.shape[1] >= hmm_pscan.SEQ_SAFE_T else _viterbi_shared)
    states = np.asarray(vit(params, jnp.asarray(feats, jnp.float32)))
    if scan == "label":
        return [ev.merge_overlapping_events(ev.label_scan(states[b], t))
                for b in range(states.shape[0])]
    baseline = int(np.argmin(np.asarray(params.means)[:, 0]))
    return [ev.merge_overlapping_events(ev.baseline_scan(states[b], t, baseline))
            for b in range(states.shape[0])]
