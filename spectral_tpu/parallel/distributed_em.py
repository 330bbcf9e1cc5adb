"""Data-parallel HMM training over a device mesh.

The reference trains its HMM on one sequence in-process (PlotEngine.py:420).
At fleet scale the natural extension is EM over a *batch* of sequences with
the E-step sharded across devices: every device computes sufficient
statistics for its shard of sequences, the statistics are summed with an
all-reduce
(psum via jnp sums over a sharded batch under jit), and the M-step runs on
the combined statistics — one global model per EM iteration, mathematically
identical to single-chip EM over the concatenated batch.

This is the framework's multi-chip "training step" (exercised by
__graft_entry__.dryrun_multichip on a virtual mesh).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spectral_tpu.models import hmm, hmm_pscan

Array = jax.Array


def _e_step_for(T: int):
    """Sequential E-step below hmm_pscan.SEQ_SAFE_T frames per sequence,
    the parallel-prefix one from there: the sequential f32 passes
    materialize -O(T) log magnitudes whose rounding corrupts gamma from
    ~2k frames (models/hmm_pscan.py docstring has the measured curve)."""
    return hmm_pscan.e_step if T >= hmm_pscan.SEQ_SAFE_T else hmm._e_step


def _batch_e_step(params: hmm.HMMParams, Xb: Array):
    """Per-sequence E-step over (B, T, D); returns summed sufficient stats."""
    e_step = _e_step_for(Xb.shape[1])

    def one(X):
        gamma, xi_sum, ll = e_step(params, X)
        # HIGHEST for the same reason as hmm._m_step: the covariance update
        # is a cancellation, and reduced-precision stats collapse the model.
        hp = jax.lax.Precision.HIGHEST
        return (gamma[0], xi_sum, jnp.sum(gamma, axis=0),
                jnp.matmul(gamma.T, X, precision=hp),
                jnp.matmul(gamma.T, X * X, precision=hp), ll)

    g0, xi, denom, obs, obs2, ll = jax.vmap(one)(Xb)
    # sums over the (sharded) batch dim -> XLA inserts the all-reduce
    return (jnp.sum(g0, 0), jnp.sum(xi, 0), jnp.sum(denom, 0),
            jnp.sum(obs, 0), jnp.sum(obs2, 0), jnp.sum(ll))


def em_step(params: hmm.HMMParams, Xb: Array,
            covars_prior: float = hmm.COVARS_PRIOR
            ) -> Tuple[hmm.HMMParams, Array]:
    """One global EM step on a (sharded) batch (B, T, D).

    Returns (new_params, total log-likelihood). Jit this with the batch
    sharded over the mesh's 'data' axis; parameters replicate. The M-step
    mirrors hmm._m_step (hmmlearn semantics: structural zeros pinned, no
    covariance floor after init) on the batch-summed statistics.
    """
    g0, xi_sum, denom, obs, obs2, total_ll = _batch_e_step(params, Xb)

    num_s = jnp.where(params.startprob == 0, 0.0, g0)
    ssum = jnp.sum(num_s)
    start_new = num_s / jnp.where(ssum == 0, 1.0, ssum)
    num_t = jnp.where(params.transmat == 0, 0.0, xi_sum)
    rsum = jnp.sum(num_t, axis=1, keepdims=True)
    trans_new = num_t / jnp.where(rsum == 0, 1.0, rsum)
    d = jnp.maximum(denom, 1e-30)[:, None]
    means_new = jnp.where(denom[:, None] > 0, obs / d, params.means)
    num = obs2 - 2.0 * means_new * obs + means_new ** 2 * denom[:, None]
    covars_new = (covars_prior + num) / jnp.maximum(denom[:, None], 1e-5)
    return hmm.HMMParams(start_new, trans_new, means_new, covars_new), total_ll


def make_sharded_em_step(mesh: Mesh, batch_axis: str = "data"):
    """jit em_step with the batch sharded and the model replicated."""
    data_sh = NamedSharding(mesh, P(batch_axis))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        em_step,
        in_shardings=(rep, data_sh),
        out_shardings=(rep, rep),
    )


def fit_sharded(params0: hmm.HMMParams, Xb: Array, mesh: Mesh,
                n_iter: int = 100, tol: float = hmm.DEFAULT_TOL,
                batch_axis: str = "data",
                checkpoint_dir: str = None,
                checkpoint_every: int = 10
                ) -> Tuple[hmm.HMMParams, float, int]:
    """Full data-parallel EM fit (host loop over jitted global steps).

    checkpoint_dir enables orbax checkpoint/resume (utils/checkpoint.py):
    the fit resumes from the latest saved iteration if one exists, and
    writes a checkpoint every checkpoint_every iterations plus one at the
    end — a killed fleet run picks up where it stopped.
    """
    step = make_sharded_em_step(mesh, batch_axis)
    Xb = jax.device_put(Xb, NamedSharding(mesh, P(batch_axis)))

    start_it = 0
    prev = -float("inf")
    params = params0
    if checkpoint_dir is not None:
        from spectral_tpu.utils import checkpoint as ckpt
        resumed = ckpt.load_training_state(checkpoint_dir)
        if resumed is not None:
            params, start_it, prev = resumed
    params = jax.device_put(params, NamedSharding(mesh, P()))

    ll = prev
    it = start_it
    last_saved = start_it
    for it in range(start_it + 1, n_iter + 1):
        params, ll_arr = step(params, Xb)
        ll = float(ll_arr)
        if checkpoint_dir is not None and it % checkpoint_every == 0:
            from spectral_tpu.utils import checkpoint as ckpt
            ckpt.save_training_state(checkpoint_dir, params, it, ll)
            last_saved = it
        # hmmlearn ConvergenceMonitor semantics: stop whenever the gain
        # drops below tol — INCLUDING a sharp log-likelihood decrease
        # (tested by test_fit_sharded_stops_on_ll_decrease)
        if ll - prev < tol and it > 1:
            break
        prev = ll
    # final checkpoint — but not a duplicate of an in-loop save: orbax
    # raises StepAlreadyExistsError for a step it already holds, which
    # would crash a fit whose last iteration lands on checkpoint_every
    if checkpoint_dir is not None and it > last_saved:
        from spectral_tpu.utils import checkpoint as ckpt
        ckpt.save_training_state(checkpoint_dir, params, it, ll)
    return params, ll, it
