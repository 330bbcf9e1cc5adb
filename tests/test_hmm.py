"""Gaussian HMM tests: equivalence with closed-form hand computations,
EM behavior, Viterbi, supervised fit, escape patch (SURVEY.md §4.2)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from spectral_tpu.models import hmm


def _two_state_data(T=400, seed=0):
    """Well-separated 2-state sequence with known segmentation."""
    rng = np.random.RandomState(seed)
    states = np.zeros(T, dtype=int)
    states[100:200] = 1
    states[300:380] = 1
    means = np.array([[-4.0, 0.0], [1.0, 0.0]])
    X = means[states] + 0.15 * rng.randn(T, 2)
    return X.astype(np.float32), states


def _params(start, trans, means, covars):
    return hmm.HMMParams(jnp.asarray(start, jnp.float32),
                         jnp.asarray(trans, jnp.float32),
                         jnp.asarray(means, jnp.float32),
                         jnp.asarray(covars, jnp.float32))


# ---- emission / forward hand-check ----------------------------------------

def test_log_emission_matches_hand_formula():
    p = _params([0.5, 0.5], [[0.9, 0.1], [0.1, 0.9]],
                [[0.0, 0.0], [2.0, -1.0]], [[1.0, 0.5], [2.0, 1.0]])
    X = np.array([[0.3, -0.2], [1.5, 0.5]], dtype=np.float32)
    out = np.asarray(hmm.log_emission(p, jnp.asarray(X)))
    for t in range(2):
        for k in range(2):
            m = np.asarray(p.means)[k]
            v = np.asarray(p.covars)[k]
            ref = -0.5 * np.sum((X[t] - m) ** 2 / v + np.log(2 * np.pi * v))
            np.testing.assert_allclose(out[t, k], ref, rtol=1e-4)


def test_forward_loglik_matches_brute_force():
    """Log-likelihood vs explicit sum over all state paths (T=4, K=2)."""
    p = _params([0.6, 0.4], [[0.7, 0.3], [0.2, 0.8]],
                [[0.0, 0.0], [1.5, 1.0]], [[0.5, 0.5], [0.8, 0.3]])
    rng = np.random.RandomState(1)
    X = rng.randn(4, 2).astype(np.float32)
    log_b = np.asarray(hmm.log_emission(p, jnp.asarray(X)), dtype=np.float64)
    start = np.asarray(p.startprob, np.float64)
    trans = np.asarray(p.transmat, np.float64)
    total = 0.0
    import itertools
    for path in itertools.product([0, 1], repeat=4):
        pr = start[path[0]] * np.exp(log_b[0, path[0]])
        for t in range(1, 4):
            pr *= trans[path[t - 1], path[t]] * np.exp(log_b[t, path[t]])
        total += pr
    _, ll = hmm.forward_log(p, jnp.asarray(log_b, jnp.float32))
    np.testing.assert_allclose(float(ll), np.log(total), rtol=1e-4)


def test_viterbi_matches_brute_force():
    p = _params([0.6, 0.4], [[0.7, 0.3], [0.2, 0.8]],
                [[0.0, 0.0], [1.5, 1.0]], [[0.5, 0.5], [0.8, 0.3]])
    rng = np.random.RandomState(2)
    X = rng.randn(5, 2).astype(np.float32)
    log_b = np.asarray(hmm.log_emission(p, jnp.asarray(X)), dtype=np.float64)
    start = np.log(np.asarray(p.startprob, np.float64))
    trans = np.log(np.asarray(p.transmat, np.float64))
    import itertools
    best, best_path = -np.inf, None
    for path in itertools.product([0, 1], repeat=5):
        s = start[path[0]] + log_b[0, path[0]]
        for t in range(1, 5):
            s += trans[path[t - 1], path[t]] + log_b[t, path[t]]
        if s > best:
            best, best_path = s, path
    states = np.asarray(hmm.viterbi(p, jnp.asarray(X)))
    np.testing.assert_array_equal(states, np.asarray(best_path))


# ---- EM -------------------------------------------------------------------

def test_em_loglik_monotone_and_recovers_states():
    X, true_states = _two_state_data()
    params0 = hmm.init_params(X, 2, seed=42)
    # manual EM loop: loglik must be non-decreasing (within fp noise)
    p = params0
    prev = -np.inf
    for _ in range(15):
        gamma, xi, ll = hmm._e_step(p, jnp.asarray(X))
        assert float(ll) >= prev - 1e-3
        prev = float(ll)
        p = hmm._m_step(p, jnp.asarray(X), gamma, xi)

    params, ll, n_it = hmm.fit(params0, jnp.asarray(X), n_iter=100)
    states = np.asarray(hmm.viterbi(params, jnp.asarray(X)))
    # map state identity by mean ordering
    hi = int(np.argmax(np.asarray(params.means)[:, 0]))
    pred = (states == hi).astype(int)
    accuracy = (pred == true_states).mean()
    assert accuracy > 0.97, accuracy
    # means recovered
    ms = np.sort(np.asarray(params.means)[:, 0])
    np.testing.assert_allclose(ms, [-4.0, 1.0], atol=0.15)


def test_fit_determinism():
    X, _ = _two_state_data(seed=3)
    p1, ll1, _ = hmm.fit(hmm.init_params(X, 2, seed=42), jnp.asarray(X))
    p2, ll2, _ = hmm.fit(hmm.init_params(X, 2, seed=42), jnp.asarray(X))
    np.testing.assert_array_equal(np.asarray(p1.means), np.asarray(p2.means))
    assert float(ll1) == float(ll2)


def test_fit_early_stops_on_convergence():
    X, _ = _two_state_data()
    _, _, n_it = hmm.fit(hmm.init_params(X, 2, seed=42), jnp.asarray(X),
                         n_iter=100)
    assert int(n_it) < 100  # converged before the cap on easy data


def test_fit_vmappable():
    Xs = np.stack([_two_state_data(seed=s)[0] for s in range(3)])
    ps = [hmm.init_params(X, 2, seed=42) for X in Xs]
    batched = jax.tree.map(lambda *a: jnp.stack(a), *ps)
    fitv = jax.vmap(lambda p, x: hmm.fit(p, x, n_iter=30)[1])
    lls = np.asarray(fitv(batched, jnp.asarray(Xs)))
    for i in range(3):
        ll_i = float(hmm.fit(ps[i], jnp.asarray(Xs[i]), n_iter=30)[1])
        np.testing.assert_allclose(lls[i], ll_i, rtol=1e-4)


# ---- supervised fit (PlotEngine.py:328-387) --------------------------------

def test_supervised_fit_hand_computed():
    X = np.array([[0.0, 0.0], [2.0, 0.0], [4.0, 0.0], [6.0, 0.0],
                  [1.0, 1.0], [0.5, 0.5]], dtype=np.float32)
    labels = np.array([0, 1, 2, 2, 3, 0])
    p = hmm.supervised_fit(X, labels, 4)
    means = np.asarray(p.means)
    covars = np.asarray(p.covars)
    # state 0: samples rows 0,5 -> mean (0.25, 0.25), var + 1e-6
    np.testing.assert_allclose(means[0], [0.25, 0.25], atol=1e-6)
    np.testing.assert_allclose(covars[0], np.var([[0, 0], [0.5, 0.5]], axis=0) + 1e-6,
                               rtol=1e-4)
    # state 1: single sample -> mean = x, var = 1e-6
    np.testing.assert_allclose(means[1], [2.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(covars[1], [1e-6, 1e-6], rtol=1e-3)
    # transitions: 0->1, 1->2, 2->2, 2->3, 3->0(forced anyway), 3->0 counted
    tm = np.asarray(p.transmat)
    np.testing.assert_allclose(tm[0], [0, 1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(tm[1], [0, 0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(tm[2], [0, 0, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(tm[3], [1, 0, 0, 0], atol=1e-6)  # forced 3->0
    np.testing.assert_allclose(np.asarray(p.startprob), [1, 0, 0, 0], atol=1e-7)


def test_supervised_fit_zero_sample_state_and_absorbing_row():
    X = np.array([[1.0], [2.0], [3.0]], dtype=np.float32)
    labels = np.array([0, 0, 1])  # states 2,3 unseen; label 1 has no outgoing
    p = hmm.supervised_fit(X, labels, 4)
    means = np.asarray(p.means)
    np.testing.assert_allclose(means[2], [0.0], atol=1e-7)  # default mean 0
    tm = np.asarray(p.transmat)
    # state 1 has no outgoing transitions -> self-prob 1
    np.testing.assert_allclose(tm[1], [0, 1, 0, 0], atol=1e-7)
    # state 2 unseen -> self-prob 1
    np.testing.assert_allclose(tm[2], [0, 0, 1, 0], atol=1e-7)
    # state 3 forced 3->0 even though unseen
    np.testing.assert_allclose(tm[3], [1, 0, 0, 0], atol=1e-7)


# ---- escape-route patch (PlotEngine.py:423-437) ----------------------------

def test_patch_escape_routes():
    tm = np.array([
        [0.98, 0.02, 0.0, 0.0],    # baseline row (state 0): untouched
        [0.0, 0.99, 0.01, 0.0],    # trapped: self 0.99>0.1, to-base 0 -> donate
        [0.05, 0.0, 0.95, 0.0],    # already has 0.05 to baseline: untouched
        [0.0, 0.5, 0.45, 0.05],    # self 0.05<0.1: untouched despite no escape
    ])
    out = hmm.patch_escape_routes(tm, baseline_state=0)
    np.testing.assert_allclose(out[0], tm[0])
    # donation = min(0.99*0.05, 0.05) = 0.0495
    np.testing.assert_allclose(out[1], [0.0495, 0.9405, 0.01, 0.0], atol=1e-12)
    np.testing.assert_allclose(out[2], tm[2])
    np.testing.assert_allclose(out[3], tm[3])
    # rows still sum to 1
    np.testing.assert_allclose(out.sum(1), np.ones(4), atol=1e-12)


def test_patch_donation_capped_at_005():
    tm = np.array([[1.0, 0.0], [0.0, 1.0]])
    out = hmm.patch_escape_routes(tm, baseline_state=0)
    # donation = min(1.0*0.05, 0.05) = 0.05
    np.testing.assert_allclose(out[1], [0.05, 0.95], atol=1e-12)


# ---- kmeans ----------------------------------------------------------------

def test_kmeans_separates_clusters():
    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(50, 2) * 0.1 + [0, 0],
                        rng.randn(50, 2) * 0.1 + [5, 5]])
    c = hmm.kmeans(X, 2, seed=42)
    c = c[np.argsort(c[:, 0])]
    np.testing.assert_allclose(c, [[0, 0], [5, 5]], atol=0.15)


def test_kmeans_deterministic():
    rng = np.random.RandomState(1)
    X = rng.randn(100, 2)
    np.testing.assert_array_equal(hmm.kmeans(X, 4, seed=42),
                                  hmm.kmeans(X, 4, seed=42))


def test_posteriors_match_brute_force():
    """E-step gamma (state posteriors) vs explicit path enumeration."""
    import itertools
    p = _params([0.6, 0.4], [[0.7, 0.3], [0.2, 0.8]],
                [[0.0, 0.0], [1.5, 1.0]], [[0.5, 0.5], [0.8, 0.3]])
    rng = np.random.RandomState(4)
    X = rng.randn(4, 2).astype(np.float32)
    log_b = np.asarray(hmm.log_emission(p, jnp.asarray(X)), np.float64)
    start = np.asarray(p.startprob, np.float64)
    trans = np.asarray(p.transmat, np.float64)

    post = np.zeros((4, 2))
    total = 0.0
    for path in itertools.product([0, 1], repeat=4):
        pr = start[path[0]] * np.exp(log_b[0, path[0]])
        for t in range(1, 4):
            pr *= trans[path[t - 1], path[t]] * np.exp(log_b[t, path[t]])
        total += pr
        for t, s in enumerate(path):
            post[t, s] += pr
    post /= total

    gamma, xi_sum, ll = hmm._e_step(p, jnp.asarray(X))
    np.testing.assert_allclose(np.asarray(gamma), post, rtol=2e-4, atol=1e-6)
    # xi sums: expected transition counts, also against enumeration
    xi_ref = np.zeros((2, 2))
    for path in itertools.product([0, 1], repeat=4):
        pr = start[path[0]] * np.exp(log_b[0, path[0]])
        for t in range(1, 4):
            pr *= trans[path[t - 1], path[t]] * np.exp(log_b[t, path[t]])
        for t in range(3):
            xi_ref[path[t], path[t + 1]] += pr
    xi_ref /= total
    np.testing.assert_allclose(np.asarray(xi_sum), xi_ref, rtol=2e-4,
                               atol=1e-6)


def test_score_matches_forward():
    X, _ = _two_state_data(T=50)
    p = hmm.init_params(X, 2, seed=42)
    ll = float(hmm.score(p, jnp.asarray(X)))
    log_b = hmm.log_emission(p, jnp.asarray(X))
    _, ll2 = hmm.forward_log(p, log_b)
    assert ll == pytest.approx(float(ll2))
    assert np.isfinite(ll)


def test_m_step_single_hand_computed():
    """One M-step from a hand-built gamma reproduces weighted means."""
    X = jnp.asarray(np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]],
                             np.float32))
    gamma = jnp.asarray(np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]],
                                 np.float32))
    xi = jnp.asarray(np.array([[0.5, 0.5], [0.25, 0.75]], np.float32))
    p0 = _params([0.5, 0.5], [[0.5, 0.5], [0.5, 0.5]],
                 [[0.0, 0.0], [1.0, 1.0]], [[1.0, 1.0], [1.0, 1.0]])
    p1 = hmm._m_step(p0, X, gamma, xi)
    # means: state0 = (1*0 + .5*1)/1.5, state1 = (.5*1 + 1*2)/1.5
    np.testing.assert_allclose(np.asarray(p1.means)[:, 0],
                               [0.5 / 1.5, 2.5 / 1.5], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p1.startprob), [1.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(p1.transmat),
                               [[0.5, 0.5], [0.25, 0.75]], rtol=1e-5)


def test_patch_escape_routes_traced_matches_numpy():
    from spectral_tpu.models.hmm import (patch_escape_routes,
                                         patch_escape_routes_traced)
    rng = np.random.RandomState(0)
    for trial in range(6):
        k = int(rng.choice([2, 4, 5]))
        tm = rng.dirichlet(np.ones(k) * 0.2, size=k)  # spiky rows: zeros-ish
        baseline = int(rng.randint(k))
        want = patch_escape_routes(tm, baseline)
        got = np.asarray(patch_escape_routes_traced(
            jnp.asarray(tm, jnp.float64)
            if jax.config.jax_enable_x64 else jnp.asarray(tm, jnp.float32),
            jnp.asarray(baseline)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_unsupervised_fit_decode_matches_staged_flow():
    from spectral_tpu.models.hmm import (fit, init_params,
                                         patch_escape_routes,
                                         unsupervised_fit_decode, viterbi)
    rng = np.random.RandomState(3)
    T = 300
    feats = rng.randn(T, 2).astype(np.float32) * 0.1 - 5.0
    feats[80:150] += 3.0
    X = jnp.asarray(feats)
    p0 = init_params(feats, 4, seed=42)

    p_fused, states_fused, baseline, ll, it = unsupervised_fit_decode(
        p0, X, n_iter=100)

    p_staged, ll2, it2 = fit(p0, X, n_iter=100)
    b2 = int(np.argmin(np.asarray(p_staged.means)[:, 0]))
    tm = patch_escape_routes(np.asarray(p_staged.transmat), b2)
    p_staged = p_staged._replace(transmat=jnp.asarray(tm, jnp.float32))
    states_staged = viterbi(p_staged, X)

    assert int(baseline) == b2 and int(it) == int(it2)
    assert float(ll) == pytest.approx(float(ll2))
    np.testing.assert_allclose(np.asarray(p_fused.transmat),
                               np.asarray(p_staged.transmat), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(states_fused),
                                  np.asarray(states_staged))


# ---- matmul-precision guard ------------------------------------------------

def _dot_precisions(jaxpr):
    """Collect the precision of every dot_general in a (nested) jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            if hasattr(v, "jaxpr"):           # ClosedJaxpr
                out.extend(_dot_precisions(v.jaxpr))
            elif hasattr(v, "eqns"):          # bare Jaxpr
                out.extend(_dot_precisions(v))
    return out


def test_em_dots_are_highest_precision():
    """A default-precision dot rounds f32 operands (TF32 on the GPU, bf16
    on the previous accelerator); through the M-step's cancellation-prone
    covariance update that collapses EM to a degenerate model (2-iteration
    convergence to ll=-425 and ZERO detected events on the burst fixture,
    vs the correct CPU decode). Every dot in the fused detection program
    must therefore carry explicit HIGHEST precision."""
    X, _ = _two_state_data()
    p0 = hmm.init_params(X, 4, seed=42)
    closed = jax.make_jaxpr(
        lambda p, x: hmm.unsupervised_fit_decode(p, x, n_iter=5))(
            p0, jnp.asarray(X))
    precs = _dot_precisions(closed.jaxpr)
    assert precs, "expected dot_general ops in the EM program"
    hp = jax.lax.Precision.HIGHEST
    assert all(p == (hp, hp) for p in precs), precs
