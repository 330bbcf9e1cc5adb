"""Parallel-prefix (associative-scan) HMM inference for long recordings.

:mod:`spectral_tpu.models.hmm` keeps the reference-parity ``lax.scan``
forms (hmmlearn semantics, PlotEngine.py:20/:411-445) — sequential over T,
which is the right shape for the reference's ~600-frame sweeps but leaves
an accelerator nearly idle on hour-scale recordings (T ~ 5e4..7e5 frames
at the streaming configs' hops): a tiny (K,K) op per sequential step. This
module re-expresses the same passes as parallel-prefix combines over
semiring matrix products — O(T K^3) parallel work, at ~128 + log(T/128)
sequential depth via a two-level chunked scan (see the block comment
above :func:`_prefix`) — and is numerically safe at T ~ 1e6 in f32:

  * forward/backward: log-semiring ((+, x) -> (logsumexp, +)) prefix /
    suffix products of the (K, K) transition+emission matrices. Raw
    log-space prefix values grow like -O(T) and would eat the per-state
    differences at f32 resolution (eps * 1e6 ~ 0.06), so every combine
    renormalizes its (K, K) block to max 0 and carries the offset in a
    compensated (hi, lo) f32 pair (Knuth two-sum) — the block keeps full
    relative precision at any T and the offset only feeds the scalar
    log-likelihood.
  * E-step: gamma_t and xi_t are per-t softmaxes of the NORMALIZED
    alpha/beta blocks — the forward-backward identity makes every offset
    cancel inside the softmax, so the sufficient statistics never touch
    the large constants at all.
  * Viterbi: max-plus prefix scan for the delta lattice, pointwise
    backpointers psi_t[j] = argmax_i(delta_{t-1}[i] + logA[i,j]), and the
    backtrace as an associative suffix scan of FUNCTION COMPOSITION over
    the K-element state maps (combine = gather). psi is the same
    pointwise argmax as the sequential recursion, so paths are
    bitwise-identical wherever f32 resolves the lattice (pinned at
    T<=8192 in the tests). At longer T the SEQUENTIAL engine's deltas
    grow to -O(T) and lose the per-state differences to f32 quantization
    (eps*|delta| ~ 0.016 at T=65536), while this engine's rescaled
    blocks stay bounded — at T=65536 the engines disagree on a fraction
    of a percent of frames and the pscan path's f64 score is BETTER, i.e.
    the disagreements are sequential-engine argmax noise, not pscan
    error.

Contracts match models/hmm.py exactly (same signatures, same return
pytrees); equality against the sequential forms is pinned in
tests/test_hmm_pscan.py. Routing: BurstDetector(engine='auto') picks this
engine from PSCAN_THRESHOLD (2048) frames on EVERY backend — that is a
CORRECTNESS boundary, not a tuning knob: the sequential f32 E-step's
gamma drifts from the f64 oracle by 0.012 at T=601, 0.059 at 2048, O(1)
at 4096, and overflows to inf by 65536, while this engine holds ~1.7e-7
at every measured T. Its speed on the H100 is not measured yet
(chip_smoke.py times the T=524288 run). On XLA:CPU the sequential scan
executes steps at ~0.1 us and is ~4-5x faster — which is why SHORT
sequences stay on it; above the threshold correct statistics outrank the
speed.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from spectral_tpu.models import hmm
from spectral_tpu.models.hmm import (
    HMMParams, DEFAULT_TOL, _safe_log, log_emission,
)

Array = jax.Array

_LOG_EPS_F = hmm._LOG_EPS  # effective log(0), the semiring identities' off-diag

# The sequential f32 E-step (hmm._e_step) is trusted BELOW this many
# frames: measured max |gamma - f64 oracle| is 0.012 at T=601 and 0.059 at
# T=2048, then O(1) at 4096 and inf by 65536. Every auto-routing layer
# (BurstDetector.PSCAN_THRESHOLD, parallel/distributed_em) switches to
# this module at or above it.
SEQ_SAFE_T = 2048


def _two_sum(a: Array, b: Array) -> Tuple[Array, Array]:
    """Knuth two-sum (s = fl(a+b), exact residual e). Local copy of
    core/stft._two_sum — six flops, branch-free."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _log_mm(A: Array, B: Array) -> Array:
    """Log-semiring matrix product: C[i,j] = logsumexp_k A[i,k] + B[k,j].
    Batched over leading axes (associative_scan slices carry them)."""
    return logsumexp(A[..., :, :, None] + B[..., None, :, :], axis=-2)


def _max_mm(A: Array, B: Array) -> Array:
    """Max-plus matrix product: C[i,j] = max_k A[i,k] + B[k,j]."""
    return jnp.max(A[..., :, :, None] + B[..., None, :, :], axis=-2)


def _rescaled(M: Array) -> Tuple[Array, Array, Array]:
    """Split M into (normalized block, offset hi, offset lo=0)."""
    m = jnp.max(M, axis=(-2, -1))
    return M - m[..., None, None], m, jnp.zeros_like(m)


def _combine_log(a, b):
    """Prefix combine in the rescaled log semiring: block product, then
    renormalize and fold the scale into the compensated offset."""
    Ma, ha, la = a
    Mb, hb, lb = b
    M = _log_mm(Ma, Mb)
    m = jnp.max(M, axis=(-2, -1))
    s, e = _two_sum(ha, hb)
    s, e2 = _two_sum(s, m)
    return M - m[..., None, None], s, la + lb + e + e2


# ---------------------------------------------------------------------------
# Two-level chunked prefix/suffix scan
#
# jax.lax.associative_scan lowers to a stride-2 odd/even recursion of
# strided gathers and slices at every level. The classic decomposition —
# a lax.scan over a SHORT chunk axis whose every step combines T/cs
# elements in parallel (fat, batched semiring products), an
# associative_scan over the T/cs chunk totals, then one batched broadcast
# combine — was ~10x faster on the previous accelerator at T=524288 and
# nearly flat in T; not measured on the H100. Below _CHUNKED_MIN the plain
# form wins (no pad/relayout overhead), so small problems keep it.
# ---------------------------------------------------------------------------

_CHUNK = 128          # sequential steps per pass; T/cs runs data-parallel
_CHUNKED_MIN = 4096   # plain associative_scan below this length


def _prefix(combine, elems, identity_of):
    """Inclusive prefix P_t = e_0 * e_1 * ... * e_t (forward order) over
    the leading axis. combine(a, b) must be associative with leading-dim
    broadcasting; identity_of(B) returns B two-sided identities."""
    T = jax.tree_util.tree_leaves(elems)[0].shape[0]
    if T < _CHUNKED_MIN:
        return jax.lax.associative_scan(combine, elems)
    cs = _CHUNK
    nc = -(-T // cs)
    pad = nc * cs - T
    if pad:
        elems = jax.tree.map(
            lambda x, i: jnp.concatenate([x, i], axis=0),
            elems, identity_of(pad))
    # (T, ...) -> (nc, cs, ...) -> (cs, nc, ...): step s combines element
    # s of EVERY chunk at once
    seq = jax.tree.map(
        lambda x: jnp.moveaxis(x.reshape((nc, cs) + x.shape[1:]), 0, 1),
        elems)

    def step(carry, e):
        nxt = combine(carry, e)
        return nxt, nxt

    totals, within = jax.lax.scan(step, identity_of(nc), seq)
    # exclusive chunk prefixes: identity, then inclusive over totals[:-1]
    if nc > 1:
        incl = jax.lax.associative_scan(
            combine, jax.tree.map(lambda x: x[:-1], totals))
        ex = jax.tree.map(lambda i, s: jnp.concatenate([i, s], axis=0),
                          identity_of(1), incl)
    else:
        ex = identity_of(1)
    res = combine(jax.tree.map(lambda x: x[None], ex), within)
    out = jax.tree.map(
        lambda x: jnp.moveaxis(x, 0, 1).reshape((nc * cs,) + x.shape[2:]),
        res)
    return jax.tree.map(lambda x: x[:T], out)


def _suffix(combine, elems, identity_of):
    """Inclusive suffix S_t = e_t * ... * e_{T-1} (forward order): prefix
    of the flipped sequence under the argument-flipped combine."""
    flipped = jax.tree.map(lambda x: jnp.flip(x, axis=0), elems)
    out = _prefix(lambda a, b: combine(b, a), flipped, identity_of)
    return jax.tree.map(lambda x: jnp.flip(x, axis=0), out)


def _identity_log(K, dtype):
    I = jnp.where(jnp.eye(K, dtype=bool), 0.0, _LOG_EPS_F).astype(dtype)

    def identity_of(B):
        z = jnp.zeros((B,), dtype)
        return jnp.broadcast_to(I, (B, K, K)), z, z
    return identity_of


def _identity_max(K, dtype):
    I = jnp.where(jnp.eye(K, dtype=bool), 0.0, _LOG_EPS_F).astype(dtype)

    def identity_of(B):
        return jnp.broadcast_to(I, (B, K, K)), jnp.zeros((B,), dtype)
    return identity_of


def _combine_comp(a: Array, b: Array) -> Array:
    """Function composition over K-element state maps: (a * b)(j) = a[b[j]]
    (explicit broadcast — take_along_axis wants matching ranks/shapes)."""
    shp = jnp.broadcast_shapes(a.shape, b.shape)
    return jnp.take_along_axis(jnp.broadcast_to(a, shp),
                               jnp.broadcast_to(b, shp), axis=-1)


def _identity_comp(K: int):
    def identity_of(B):
        return jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), (B, K))
    return identity_of


def _combine_max(a, b):
    Ma, ha = a
    Mb, hb = b
    M = _max_mm(Ma, Mb)
    m = jnp.max(M, axis=(-2, -1))
    return M - m[..., None, None], ha + hb + m


def _elements(params: HMMParams, log_b: Array) -> Tuple[Array, Array]:
    """(initial rank-1 'reset' matrix with rows a0, transition+emission
    matrices E_t[i,j] = logA[i,j] + log_b[t,j] for t = 1..T-1)."""
    log_start = _safe_log(params.startprob)
    log_trans = _safe_log(params.transmat)
    a0 = log_start + log_b[0]
    K = a0.shape[0]
    R = jnp.broadcast_to(a0[None, :], (K, K))
    E = log_trans[None, :, :] + log_b[1:, None, :]
    return R, E


def _forward_norm(params: HMMParams, log_b: Array):
    """Normalized forward lattice: returns (alpha_norm (T,K) with per-t
    max 0 across states up to the global block rescale, offsets c (T,)
    as a compensated pair, loglik). alpha_norm[t] + c[t] == log_alpha[t]
    of hmm.forward_log up to reassociation."""
    R, E = _elements(params, log_b)
    M0 = jnp.concatenate([R[None], E], axis=0)           # (T, K, K)
    P, hi, lo = _prefix(_combine_log, _rescaled(M0),
                        _identity_log(M0.shape[-1], M0.dtype))
    # prefixes include the rank-1 reset, so every row is identical
    alpha_norm = P[:, 0, :]                              # (T, K)
    ll = logsumexp(alpha_norm[-1]) + hi[-1] + lo[-1]
    return alpha_norm, (hi, lo), ll


def _backward_norm(params: HMMParams, log_b: Array):
    """Normalized backward lattice: (beta_norm (T,K), offsets (hi, lo))
    with beta_norm[t] + c[t] == log_beta[t] of hmm.backward_log."""
    _R, E = _elements(params, log_b)                     # E_t, t=1..T-1
    S, hi, lo = _suffix(_combine_log, _rescaled(E),
                        _identity_log(E.shape[-1], E.dtype))
    beta_inner = logsumexp(S, axis=-1)                   # (T-1, K)
    zK = jnp.zeros_like(log_b[0])
    z1 = jnp.zeros_like(hi[:1])
    return (jnp.concatenate([beta_inner, zK[None]], axis=0),
            (jnp.concatenate([hi, z1]), jnp.concatenate([lo, z1])))


def forward_log(params: HMMParams, log_b: Array) -> Tuple[Array, Array]:
    """Drop-in for :func:`hmm.forward_log` (same (log_alpha, loglik)).
    Prefer :func:`e_step`/:func:`fit` at very large T: materializing raw
    log_alpha re-adds the -O(T) offsets this module exists to avoid."""
    if log_b.shape[0] == 1:
        a0 = _safe_log(params.startprob) + log_b[0]
        return a0[None], logsumexp(a0)
    alpha_norm, (hi, lo), ll = _forward_norm(params, log_b)
    return alpha_norm + (hi + lo)[:, None], ll


def backward_log(params: HMMParams, log_b: Array) -> Array:
    """Drop-in for :func:`hmm.backward_log` (same log_beta)."""
    if log_b.shape[0] == 1:
        return jnp.zeros_like(log_b)
    beta_norm, (hi, lo) = _backward_norm(params, log_b)
    return beta_norm + (hi + lo)[:, None]


def e_step(params: HMMParams, X: Array):
    """Offset-free E-step: (gamma (T,K), xi_sum (K,K), loglik), matching
    hmm._e_step up to float reassociation. gamma_t is the per-t softmax of
    alpha_norm + beta_norm (the forward-backward identity cancels every
    offset and the 1/P(O) factor); xi_t likewise as a per-t softmax over
    the (K, K) transition lattice."""
    log_b = log_emission(params, X)
    T = log_b.shape[0]
    if T == 1:
        a0 = _safe_log(params.startprob) + log_b[0]
        gamma = jax.nn.softmax(a0)[None]
        K = a0.shape[0]
        return gamma, jnp.zeros((K, K), log_b.dtype), logsumexp(a0)
    alpha_norm, _ca, ll = _forward_norm(params, log_b)
    beta_norm, _cb = _backward_norm(params, log_b)
    gamma = jax.nn.softmax(alpha_norm + beta_norm, axis=-1)
    log_trans = _safe_log(params.transmat)
    xi_log = (alpha_norm[:-1, :, None] + log_trans[None]
              + (log_b[1:] + beta_norm[1:])[:, None, :])
    K = log_trans.shape[0]
    xi = jax.nn.softmax(xi_log.reshape(T - 1, K * K), axis=-1)
    xi_sum = jnp.sum(xi, axis=0).reshape(K, K)
    return gamma, xi_sum, ll


def score(params: HMMParams, X: Array) -> Array:
    """Sequence log-likelihood (hmm.score contract)."""
    log_b = log_emission(params, X)
    if log_b.shape[0] == 1:
        return logsumexp(_safe_log(params.startprob) + log_b[0])
    return _forward_norm(params, log_b)[2]


def viterbi(params: HMMParams, X: Array) -> Array:
    """Drop-in for :func:`hmm.viterbi`: most-likely state path, identical
    tie-breaking (the backpointers are the same pointwise argmax; the
    backtrace composes them associatively instead of walking them).
    Bitwise-equal to the sequential path wherever f32 resolves the
    lattice; at very long T it is the more accurate decode (module
    docstring, last bullet — the f64 path score is pinned >= the
    sequential engine's in tests/test_hmm_pscan.py)."""
    log_b = log_emission(params, X)
    T = log_b.shape[0]
    if T == 1:
        a0 = _safe_log(params.startprob) + log_b[0]
        return jnp.argmax(a0)[None].astype(jnp.int32)
    log_trans = _safe_log(params.transmat)
    R, E = _elements(params, log_b)
    M0 = jnp.concatenate([R[None], E], axis=0)
    m0 = jnp.max(M0, axis=(-2, -1))
    K = M0.shape[-1]
    D, _off = _prefix(_combine_max, (M0 - m0[:, None, None], m0),
                      _identity_max(K, M0.dtype))
    delta = D[:, 0, :]                                   # (T, K) normalized
    # psi_t[j] = argmax_i delta_{t-1}[i] + logA[i,j]; the per-t rescale is
    # a constant over i, so the argmax matches the sequential recursion
    psi = jnp.argmax(delta[:-1, :, None] + log_trans[None], axis=-2)
    end = jnp.argmax(delta[-1])
    # backtrace s_t = psi_{t+1}[s_{t+1}]: suffix composition of the state
    # maps under (f * g)(j) = f[g[j]]
    H = _suffix(_combine_comp, psi.astype(jnp.int32),
                _identity_comp(K))                       # (T-1, K)
    states = jnp.concatenate(
        [jnp.take_along_axis(H, jnp.broadcast_to(end, (T - 1, 1)),
                             axis=-1)[:, 0],
         end[None]]).astype(jnp.int32)
    return states


@functools.partial(jax.jit, static_argnames=("n_iter",))
def fit(params0: HMMParams, X: Array, n_iter: int = 100,
        tol: float = DEFAULT_TOL) -> Tuple[HMMParams, Array, Array]:
    """Baum-Welch EM with the parallel-prefix E-step (hmm.fit contract:
    returns (params, final_loglik, n_iterations_run))."""
    return hmm._em_loop(e_step, params0, X, n_iter, tol)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def unsupervised_fit_decode(params0: HMMParams, X: Array, n_iter: int = 100,
                            tol: float = DEFAULT_TOL):
    """hmm.unsupervised_fit_decode (PlotEngine.py:411-445 composition) on
    the parallel-prefix engine: EM fit, baseline = argmin mean log-power,
    escape-route patch, Viterbi — one dispatch."""
    params, ll, it = hmm._em_loop(e_step, params0, X, n_iter, tol)
    baseline = jnp.argmin(params.means[:, 0])
    params = params._replace(
        transmat=hmm.patch_escape_routes_traced(params.transmat, baseline))
    states = viterbi(params, X)
    return params, states, baseline, ll, it
