"""Parallel-prefix HMM engine (models/hmm_pscan.py) vs the sequential
lax.scan forms in models/hmm.py, and vs an f64 oracle.

The pscan engine must be a drop-in: same signatures, same return pytrees,
Viterbi bitwise-identical wherever f32 resolves the lattice (same
pointwise-argmax backpointers; at very long T the SEQUENTIAL engine's
deltas lose near-ties to f32 quantization and the pscan decode scores
strictly better — pinned below), EM within f32 reassociation noise. Accuracy is also pinned the other way: the
rescaled-block representation makes the pscan E-step MORE accurate than
the sequential scan (which materializes -O(T) log magnitudes), so its
gamma is compared to an f64 oracle at a tolerance the sequential form
cannot meet (measured: 1.3e-7 vs 1.2e-2 at T=601).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from spectral_tpu.models import hmm, hmm_pscan


def _fixture(T=601, K=4, D=2, seed=1):
    rng = np.random.RandomState(seed)
    reps = [T // 7] * 6 + [T - 6 * (T // 7)]
    X = (rng.randn(T, D) + np.repeat(rng.randn(7, D), reps, axis=0))
    Xj = jnp.asarray(X.astype(np.float32))
    params = hmm.init_params(X, K, seed=42)
    return params, Xj


def _oracle_fb(params, log_b):
    """f64 numpy forward/backward (scipy logsumexp)."""
    from scipy.special import logsumexp as lse
    T, K = log_b.shape
    lS = np.log(np.maximum(np.asarray(params.startprob, np.float64), 1e-300))
    lA = np.log(np.maximum(np.asarray(params.transmat, np.float64), 1e-300))
    la = np.zeros((T, K))
    la[0] = lS + log_b[0]
    for t in range(1, T):
        la[t] = log_b[t] + lse(la[t - 1][:, None] + lA, axis=0)
    lb = np.zeros((T, K))
    for t in range(T - 2, -1, -1):
        lb[t] = lse(lA + (log_b[t + 1] + lb[t + 1])[None, :], axis=1)
    ll = lse(la[-1])
    return la, lb, ll


def test_forward_backward_match_sequential():
    params, X = _fixture()
    log_b = hmm.log_emission(params, X)
    la1, ll1 = hmm.forward_log(params, log_b)
    la2, ll2 = hmm_pscan.forward_log(params, log_b)
    # absolute log values reach ~-2200; both engines carry f32 noise there
    assert float(jnp.abs(la1 - la2).max()) < 0.1
    assert abs(float(ll1) - float(ll2)) < 0.1
    lb1 = hmm.backward_log(params, log_b)
    lb2 = hmm_pscan.backward_log(params, log_b)
    assert float(jnp.abs(lb1 - lb2).max()) < 0.1


def test_e_step_beats_sequential_against_f64_oracle():
    params, X = _fixture()
    log_b64 = np.asarray(hmm.log_emission(params, X), np.float64)
    la, lb, ll = _oracle_fb(params, log_b64)
    g_oracle = np.exp(la + lb - ll)
    g_seq = np.asarray(hmm._e_step(params, X)[0])
    g_ps, xi_ps, ll_ps = hmm_pscan.e_step(params, X)
    err_ps = np.abs(np.asarray(g_ps) - g_oracle).max()
    err_seq = np.abs(g_seq - g_oracle).max()
    assert err_ps < 1e-5, err_ps
    assert err_ps < err_seq  # the design claim: offset-free beats offset-laden
    assert abs(float(ll_ps) - ll) < 0.05
    # xi rows integrate to gamma[:-1] row sums (forward-backward identity)
    np.testing.assert_allclose(np.asarray(xi_ps).sum(),
                               np.asarray(g_ps)[:-1].sum(), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_viterbi_bitwise_matches_sequential(seed):
    params, X = _fixture(seed=seed)
    v1 = np.asarray(hmm.viterbi(params, X))
    v2 = np.asarray(hmm_pscan.viterbi(params, X))
    assert (v1 == v2).all()


def test_viterbi_matches_on_structural_zero_transmat():
    # supervised params: structural zeros + a deterministic 3->0 row
    params, X = _fixture()
    rng = np.random.RandomState(7)
    labels = rng.randint(0, 4, X.shape[0])
    sp = hmm.supervised_fit(np.asarray(X, np.float64), labels, 4)
    v1 = np.asarray(hmm.viterbi(sp, X))
    v2 = np.asarray(hmm_pscan.viterbi(sp, X))
    assert (v1 == v2).all()


@pytest.mark.parametrize("T", [1, 2, 3])
def test_tiny_T_degenerate(T):
    params, X = _fixture()
    Xs = X[:T]
    assert (np.asarray(hmm.viterbi(params, Xs))
            == np.asarray(hmm_pscan.viterbi(params, Xs))).all()
    g1, xi1, ll1 = hmm._e_step(params, Xs)
    g2, xi2, ll2 = hmm_pscan.e_step(params, Xs)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-4)
    np.testing.assert_allclose(np.asarray(xi1), np.asarray(xi2), atol=1e-4)
    assert abs(float(ll1) - float(ll2)) < 1e-3
    la1, l1 = hmm.forward_log(params, hmm.log_emission(params, Xs))
    la2, l2 = hmm_pscan.forward_log(params, hmm.log_emission(params, Xs))
    np.testing.assert_allclose(np.asarray(la1), np.asarray(la2), atol=1e-4)


def test_fit_matches_sequential():
    params, X = _fixture()
    p1, ll1, it1 = hmm.fit(params, X, n_iter=8, tol=-1e30)
    p2, ll2, it2 = hmm_pscan.fit(params, X, n_iter=8, tol=-1e30)
    assert int(it1) == int(it2) == 8
    assert abs(float(ll1) - float(ll2)) < 0.05
    for f in p1._fields:
        a, b = np.asarray(getattr(p1, f)), np.asarray(getattr(p2, f))
        np.testing.assert_allclose(a, b, atol=2e-3, err_msg=f)


def test_unsupervised_fit_decode_matches_sequential():
    params, X = _fixture()
    p1, s1, b1, ll1, it1 = hmm.unsupervised_fit_decode(params, X)
    p2, s2, b2, ll2, it2 = hmm_pscan.unsupervised_fit_decode(params, X)
    assert int(b1) == int(b2)
    # the convergence monitor (ll gain < tol) sits on a float boundary:
    # f32 reassociation legitimately moves the stop by one iteration
    assert abs(int(it1) - int(it2)) <= 1, (int(it1), int(it2))
    # EM trajectories diverge only by f32 reassociation; the decoded paths
    # must agree except possibly isolated boundary frames
    agree = (np.asarray(s1) == np.asarray(s2)).mean()
    assert agree > 0.995, agree


def test_score_matches():
    params, X = _fixture()
    s1 = float(hmm.score(params, X))
    s2 = float(hmm_pscan.score(params, X))
    assert abs(s1 - s2) < 0.1


def test_long_T_viterbi_and_estep():
    """Longer-than-sweep sequence (exercises the chunked two-level scan,
    T >= _CHUNKED_MIN): exactness must hold at depth."""
    params, X = _fixture(T=8192)
    v1 = np.asarray(hmm.viterbi(params, X))
    v2 = np.asarray(hmm_pscan.viterbi(params, X))
    assert (v1 == v2).all()
    log_b64 = np.asarray(hmm.log_emission(params, X), np.float64)
    la, lb, ll = _oracle_fb(params, log_b64)
    g_oracle = np.exp(la + lb - ll)
    g_ps = np.asarray(hmm_pscan.e_step(params, X)[0])
    assert np.abs(g_ps - g_oracle).max() < 1e-5


def _path_score_f64(params, log_b64, s):
    lS = np.log(np.maximum(np.asarray(params.startprob, np.float64), 1e-300))
    lA = np.log(np.maximum(np.asarray(params.transmat, np.float64), 1e-300))
    return (lS[s[0]] + log_b64[0, s[0]]
            + lA[s[:-1], s[1:]].sum()
            + log_b64[np.arange(1, len(s)), s[1:]].sum())


def test_very_long_T_pscan_viterbi_is_the_better_decode():
    """At T=65536 the SEQUENTIAL engine's f32 deltas reach -O(3e5), where
    eps*|delta| ~ 0.016 swamps near-tie state differences and flips its
    argmax backpointers; the pscan engine's rescaled blocks stay bounded.
    Contract: the engines agree on >99% of frames, and the pscan path's
    f64 score is at least the sequential path's."""
    rng = np.random.RandomState(5)
    T = 65536
    X = jnp.asarray((rng.randn(T, 2) + np.repeat(
        rng.randn(64, 2), T // 64, axis=0)).astype(np.float32))
    params = hmm.init_params(np.asarray(X, np.float64)[:8192], 4, seed=42)
    v_scan = np.asarray(hmm.viterbi(params, X))
    v_ps = np.asarray(hmm_pscan.viterbi(params, X))
    assert (v_scan != v_ps).mean() < 0.01
    log_b64 = np.asarray(hmm.log_emission(params, X), np.float64)
    s_scan = _path_score_f64(params, log_b64, v_scan)
    s_ps = _path_score_f64(params, log_b64, v_ps)
    assert s_ps >= s_scan - 1e-6, (s_scan, s_ps)
    # ... and the sequential E-step has COLLAPSED here (f32 log offsets:
    # gamma overflows past 1, to inf on some backends) while pscan stays
    # a proper distribution — the reason BurstDetector routes long T to
    # this engine on every backend
    g_seq = np.asarray(hmm._e_step(params, X)[0])
    g_ps = np.asarray(hmm_pscan.e_step(params, X)[0])
    assert np.isfinite(g_ps).all()
    assert float(g_ps.max()) <= 1.0 + 1e-6
    np.testing.assert_allclose(g_ps.sum(axis=1), 1.0, rtol=1e-5)
    assert (not np.isfinite(g_seq).all()) or float(g_seq.max()) > 1.5
