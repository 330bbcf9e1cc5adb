"""Diagonal-covariance Gaussian HMM in JAX.

Accelerator-native replacement for the reference's hmmlearn dependency
(``hmm.GaussianHMM(n_components=4, covariance_type="diag", n_iter=100,
random_state=42)``, PlotEngine.py:20; 2-state variant at :392). Everything is
log-space, built on ``lax.scan`` / ``lax.while_loop`` so fitting and decoding
jit-compile to single XLA programs and ``vmap`` over batches of sequences.

Algorithmic conventions mirror hmmlearn's documented Baum-Welch variant so the
detection behavior matches the reference:

  * init: uniform startprob/transmat; means from an sklearn-exact KMeans
    (models/kmeans.py — hmmlearn calls sklearn KMeans(random_state, n_init=10));
    covariances = diag(np.cov(X.T, ddof=1)) + min_covar per state;
  * M-step: covars_prior added to the covariance numerator (hmmlearn default
    1e-2 for 'diag'); structural zeros in startprob/transmat stay pinned;
    no covariance floor after init (min_covar is init-only, as in hmmlearn);
  * convergence: stop when the log-likelihood gain drops below tol (1e-2).

SCOPE (f32): these sequential passes materialize log alpha/beta that grow
like -O(T), so their f32 rounding eats the per-state differences as T
grows — the E-step's gamma is within 0.012 of an f64 oracle at the
reference's T~600 but wrong by O(1) from T~4096 and overflows to inf by
T~65536 (hmmlearn runs f64 and never sees this). Long recordings must use
:mod:`spectral_tpu.models.hmm_pscan` (oracle-accurate at every measured T;
same contracts); ``BurstDetector(engine='auto')`` routes there from
PSCAN_THRESHOLD frames automatically.

Closed-form supervised fitting and the transition-matrix "escape route" patch
reproduce PlotEngine._train_supervised (:328-387) and unsupervised_detect's
transmat surgery (:423-437) exactly — see :mod:`spectral_tpu.models.detector`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp

Array = jax.Array

MIN_COVAR = 1e-3      # hmmlearn GaussianHMM default min_covar
COVARS_PRIOR = 1e-2   # hmmlearn default covars_prior for 'diag'
DEFAULT_TOL = 1e-2    # hmmlearn default convergence tolerance
_LOG_EPS = -1e10      # effective log(0)


class HMMParams(NamedTuple):
    """Pytree of HMM parameters (K states, D feature dims)."""
    startprob: Array  # (K,)
    transmat: Array   # (K, K)
    means: Array      # (K, D)
    covars: Array     # (K, D) diagonal variances


# ---------------------------------------------------------------------------
# Emission / forward / backward / viterbi
# ---------------------------------------------------------------------------

def log_emission(params: HMMParams, X: Array) -> Array:
    """Framewise diagonal-Gaussian log-likelihood: (T, D) -> (T, K)."""
    v = jnp.maximum(params.covars, 1e-12)
    diff = X[:, None, :] - params.means[None, :, :]           # (T, K, D)
    return -0.5 * jnp.sum(diff * diff / v + jnp.log(2.0 * jnp.pi * v), axis=-1)


def _safe_log(p: Array) -> Array:
    return jnp.where(p > 0, jnp.log(jnp.maximum(p, 1e-300)), _LOG_EPS)


def forward_log(params: HMMParams, log_b: Array) -> Tuple[Array, Array]:
    """Log-space forward pass. Returns (log_alpha (T,K), loglik)."""
    log_start = _safe_log(params.startprob)
    log_trans = _safe_log(params.transmat)

    a0 = log_start + log_b[0]

    def step(prev, lb):
        nxt = lb + logsumexp(prev[:, None] + log_trans, axis=0)
        return nxt, nxt

    last, rest = jax.lax.scan(step, a0, log_b[1:])
    log_alpha = jnp.concatenate([a0[None], rest], axis=0)
    return log_alpha, logsumexp(last)


def backward_log(params: HMMParams, log_b: Array) -> Array:
    """Log-space backward pass. Returns log_beta (T, K)."""
    log_trans = _safe_log(params.transmat)
    bT = jnp.zeros_like(log_b[0])

    def step(nxt, lb_next):
        cur = logsumexp(log_trans + (lb_next + nxt)[None, :], axis=1)
        return cur, cur

    _, rest = jax.lax.scan(step, bT, log_b[1:], reverse=True)
    return jnp.concatenate([rest, bT[None]], axis=0)


def viterbi(params: HMMParams, X: Array) -> Array:
    """Most-likely state sequence (hmmlearn .predict): (T, D) -> (T,) int32."""
    log_b = log_emission(params, X)
    log_start = _safe_log(params.startprob)
    log_trans = _safe_log(params.transmat)

    d0 = log_start + log_b[0]

    def fwd(prev, lb):
        scores = prev[:, None] + log_trans            # (K from, K to)
        best = jnp.max(scores, axis=0) + lb
        arg = jnp.argmax(scores, axis=0)
        return best, arg

    last, psi = jax.lax.scan(fwd, d0, log_b[1:])      # psi: (T-1, K)
    end = jnp.argmax(last)

    def back(state, a):
        prev = a[state]
        return prev, prev

    _, states_rev = jax.lax.scan(back, end, psi, reverse=True)
    return jnp.concatenate([states_rev, end[None]]).astype(jnp.int32)


def score(params: HMMParams, X: Array) -> Array:
    """Sequence log-likelihood under the model."""
    return forward_log(params, log_emission(params, X))[1]


# ---------------------------------------------------------------------------
# EM (Baum-Welch)
# ---------------------------------------------------------------------------

def _e_step(params: HMMParams, X: Array):
    log_b = log_emission(params, X)
    log_alpha, ll = forward_log(params, log_b)
    log_beta = backward_log(params, log_b)
    log_gamma = log_alpha + log_beta - ll
    gamma = jnp.exp(log_gamma)                        # (T, K)
    log_trans = _safe_log(params.transmat)
    # xi[t, i, j] ∝ alpha[t,i] + trans[i,j] + b[t+1,j] + beta[t+1,j]
    xi_log = (log_alpha[:-1, :, None] + log_trans[None]
              + (log_b[1:] + log_beta[1:])[:, None, :] - ll)
    xi_sum = jnp.sum(jnp.exp(xi_log), axis=0)         # (K, K)
    return gamma, xi_sum, ll


def _m_step(params: HMMParams, X: Array, gamma: Array, xi_sum: Array,
            covars_prior: float = COVARS_PRIOR) -> HMMParams:
    # hmmlearn _BaseHMM._do_mstep semantics (priors at their defaults of 1.0
    # contribute prior-1 == 0): entries that are structurally zero in the
    # current startprob/transmat stay zero; rows whose masked numerator sums
    # to zero are left unnormalized (all-zero), exactly like
    # hmmlearn.utils.normalize.
    num_s = jnp.where(params.startprob == 0, 0.0, gamma[0])
    ssum = jnp.sum(num_s)
    start_new = num_s / jnp.where(ssum == 0, 1.0, ssum)

    num_t = jnp.where(params.transmat == 0, 0.0, xi_sum)
    rsum = jnp.sum(num_t, axis=1, keepdims=True)
    trans_new = num_t / jnp.where(rsum == 0, 1.0, rsum)

    denom = jnp.sum(gamma, axis=0)                    # (K,)
    # HIGHEST precision is load-bearing: a default-precision dot may round
    # the operands (bf16 on the previous accelerator, TF32 on the GPU), and
    # the covariance update below is a cancellation (obs2 - 2 m obs + m^2
    # denom) — rounded stats drive variances to ~0, emission
    # log-likelihoods to -1e4, and EM "converges" in 2 iterations to a
    # collapsed model (zero events on the burst fixture vs the correct CPU
    # decode; HIGHEST restores bit-level agreement). These (T,K)x(T,D)
    # dots are microscopic — no perf cost.
    hp = jax.lax.Precision.HIGHEST
    obs = jnp.matmul(gamma.T, X, precision=hp)        # (K, D)
    obs2 = jnp.matmul(gamma.T, X * X, precision=hp)   # (K, D)
    d = jnp.maximum(denom, 1e-30)[:, None]
    means_new = jnp.where(denom[:, None] > 0, obs / d, params.means)
    # GaussianHMM._do_mstep 'diag': cv_num / max(cv_den, 1e-5) with the
    # covars_prior added to the numerator; hmmlearn applies NO min_covar
    # floor after init (min_covar enters only the initial covariances).
    num = obs2 - 2.0 * means_new * obs + means_new * means_new * denom[:, None]
    covars_new = (covars_prior + num) / jnp.maximum(denom[:, None], 1e-5)
    return HMMParams(start_new, trans_new, means_new, covars_new)


def _em_loop(e_step_fn, params0: HMMParams, X: Array, n_iter: int,
             tol: float) -> Tuple[HMMParams, Array, Array]:
    """Shared Baum-Welch driver (lax.while_loop) parameterized by the
    E-step engine: :func:`_e_step` here (sequential lax.scan passes) or
    :func:`spectral_tpu.models.hmm_pscan.e_step` (parallel-prefix)."""
    def cond(carry):
        params, prev_ll, ll, it = carry
        # hmmlearn ConvergenceMonitor: converged when delta < tol, so the
        # loop continues while delta >= tol
        return jnp.logical_and(it < n_iter,
                               jnp.logical_or(it == 0, ll - prev_ll >= tol))

    def body(carry):
        params, prev_ll, ll, it = carry
        gamma, xi_sum, cur_ll = e_step_fn(params, X)
        new_params = _m_step(params, X, gamma, xi_sum)
        return (new_params, ll, cur_ll, it + 1)

    init = (params0, -jnp.inf, -jnp.inf, jnp.asarray(0))
    params, _, ll, it = jax.lax.while_loop(cond, body, init)
    return params, ll, it


@functools.partial(jax.jit, static_argnames=("n_iter",))
def fit(params0: HMMParams, X: Array, n_iter: int = 100,
        tol: float = DEFAULT_TOL) -> Tuple[HMMParams, Array, Array]:
    """Baum-Welch EM, fully jitted (lax.while_loop). vmap over a batch by
    vmapping this function over (params0, X).

    Returns (params, final_loglik, n_iterations_run).
    """
    return _em_loop(_e_step, params0, X, n_iter, tol)


# ---------------------------------------------------------------------------
# Initialization (host-side, deterministic)
# ---------------------------------------------------------------------------

def kmeans(X: np.ndarray, k: int, seed: int = 42, n_init: int = 10,
           max_iter: int = 300) -> np.ndarray:
    """hmmlearn's GaussianHMM means initialization: sklearn
    ``cluster.KMeans(n_clusters=k, random_state=seed, n_init=10)`` on the
    features (random_state=42 in the reference, PlotEngine.py:20,392).
    :mod:`spectral_tpu.models.kmeans` reproduces sklearn's algorithm and RNG
    consumption exactly (asserted bit-for-bit against sklearn in
    tests/test_hmmlearn_parity.py)."""
    from spectral_tpu.models.kmeans import kmeans_fit
    centers, _labels, _inertia = kmeans_fit(X, k, seed=seed, n_init=n_init,
                                            max_iter=max_iter)
    return centers


def init_params(X, k: int, seed: int = 42, min_covar: float = MIN_COVAR,
                dtype=jnp.float32) -> HMMParams:
    """hmmlearn GaussianHMM._init: uniform start/trans, sklearn-KMeans means,
    diagonal of ``np.cov(X.T) + min_covar*I`` (ddof=1) tiled per state."""
    Xh = np.asarray(X, dtype=np.float64)
    means = kmeans(Xh, k, seed=seed)
    if Xh.shape[0] > 1:
        var = np.var(Xh, axis=0, ddof=1) + min_covar
    else:
        var = np.full(Xh.shape[1], min_covar)
    return HMMParams(
        startprob=jnp.full((k,), 1.0 / k, dtype),
        transmat=jnp.full((k, k), 1.0 / k, dtype),
        means=jnp.asarray(means, dtype),
        covars=jnp.asarray(np.tile(var, (k, 1)), dtype),
    )


# ---------------------------------------------------------------------------
# Closed-form supervised fit (PlotEngine._train_supervised, :328-387)
# ---------------------------------------------------------------------------

def supervised_fit(features, labels, n_states: int,
                   dtype=jnp.float32) -> HMMParams:
    """Exact reproduction of the reference's closed-form supervised fit.

    Per state: >1 samples -> (mean, var + 1e-6); ==1 sample -> (x, 1e-6);
    ==0 samples -> (0, 1e-6). Transition counts row-normalized; rows with no
    outgoing transitions get self-probability 1; if n_states > 3 row 3 is
    forced to a deterministic 3 -> 0 transition; startprob = [1, 0, 0, ...].
    """
    X = np.asarray(features, dtype=np.float64)
    labels = np.asarray(labels)
    D = X.shape[1]
    means, covars = [], []
    for i in range(n_states):
        sf = X[labels == i]
        if sf.shape[0] > 1:
            means.append(sf.mean(axis=0))
            covars.append(sf.var(axis=0) + 1e-6)
        elif sf.shape[0] == 1:
            means.append(sf[0])
            covars.append(np.ones(D) * 1e-6)
        else:
            means.append(np.zeros(D))
            covars.append(np.ones(D) * 1e-6)

    transmat = np.zeros((n_states, n_states))
    for i in range(len(labels) - 1):
        transmat[labels[i], labels[i + 1]] += 1
    row_sums = transmat.sum(axis=1, keepdims=True)
    with np.errstate(invalid="ignore"):
        transmat_prob = np.divide(transmat, row_sums,
                                  out=np.zeros_like(transmat),
                                  where=row_sums != 0)
    for s in np.where(row_sums.flatten() == 0)[0]:
        transmat_prob[s, s] = 1.0
    if n_states > 3:
        transmat_prob[3, :] = 0.0
        transmat_prob[3, 0] = 1.0

    startprob = np.zeros(n_states)
    startprob[0] = 1.0
    return HMMParams(jnp.asarray(startprob, dtype),
                     jnp.asarray(transmat_prob, dtype),
                     jnp.asarray(np.asarray(means), dtype),
                     jnp.asarray(np.asarray(covars), dtype))


# ---------------------------------------------------------------------------
# Unsupervised transmat "escape route" patch (PlotEngine.py:423-437)
# ---------------------------------------------------------------------------

def patch_escape_routes(transmat, baseline_state: int) -> np.ndarray:
    """For every non-baseline state with < 1e-5 probability of reaching the
    baseline and self-transition > 0.1, donate min(5% of self, 0.05) to the
    baseline transition."""
    tm = np.array(transmat, dtype=np.float64, copy=True)
    k = tm.shape[0]
    for i in range(k):
        if i == baseline_state:
            continue
        if tm[i, baseline_state] < 1e-5 and tm[i, i] > 0.1:
            donation = min(tm[i, i] * 0.05, 0.05)
            tm[i, i] -= donation
            tm[i, baseline_state] += donation
    return tm


def patch_escape_routes_traced(transmat: Array, baseline_state: Array) -> Array:
    """jit-traceable :func:`patch_escape_routes` (baseline may be a traced
    scalar): identical arithmetic expressed with one-hot masks."""
    k = transmat.shape[0]
    idx = jnp.arange(k)
    onehot_b = (idx == baseline_state).astype(transmat.dtype)  # (k,)
    diag = jnp.diagonal(transmat)
    # column b via a traced-index gather: exact by construction (the
    # earlier one-hot matmul form needed a HIGHEST annotation so operand
    # rounding could not flip the 1e-5 threshold test below)
    tm_b = jnp.take(transmat, baseline_state, axis=1)
    cond = (idx != baseline_state) & (tm_b < 1e-5) & (diag > 0.1)
    donation = jnp.where(cond, jnp.minimum(diag * 0.05, 0.05), 0.0)
    return (transmat - jnp.diag(donation)
            + donation[:, None] * onehot_b[None, :])


@functools.partial(jax.jit, static_argnames=("n_iter",))
def unsupervised_fit_decode(params0: HMMParams, X: Array, n_iter: int = 100,
                            tol: float = DEFAULT_TOL):
    """The reference's whole unrefined detection compute in ONE dispatch
    (PlotEngine.py:411-445): EM fit, baseline = argmin mean log-power,
    transmat escape-route patch, Viterbi decode.

    Fit and Viterbi used to run as separate dispatches with a host-side
    patch in between; each dispatch and readback is a host round trip that
    can dwarf the O(ms) compute.
    Returns (patched_params, states, baseline_state, loglik, n_iters)."""
    params, ll, it = fit(params0, X, n_iter=n_iter, tol=tol)
    baseline = jnp.argmin(params.means[:, 0])      # PlotEngine.py:445
    params = params._replace(
        transmat=patch_escape_routes_traced(params.transmat, baseline))
    states = viterbi(params, X)
    return params, states, baseline, ll, it
