"""Normalization / dB mapping tests against PlotEngine.py:126-131 semantics."""

import numpy as np
import jax.numpy as jnp

from spectral_tpu.core.scale import normalize, normalize_batch


def _ref_normalize(sxx, log_scale=False, global_max=None):
    """Direct float64 re-statement of PlotEngine.py:126-131."""
    base = np.max(sxx) if global_max is None or global_max <= 0 else global_max
    with np.errstate(invalid="ignore", divide="ignore"):  # inf/inf -> NaN
        norm = np.clip(sxx / (base + 1e-20), 0.0, 1.0)
        if log_scale:
            eps = 1e-12
            db = 10.0 * np.log10(norm + eps)
            db = np.nan_to_num(db)
            mn, mx = np.min(db), np.max(db)
            norm = ((db - mn) / (mx - mn) if (mx - mn) > 1e-6
                    else np.zeros_like(db))
    return norm


def test_linear_normalize_matches_reference():
    rng = np.random.RandomState(0)
    sxx = rng.rand(64, 33).astype(np.float32) * 5.0
    ours = np.asarray(normalize(jnp.asarray(sxx)))
    np.testing.assert_allclose(ours, _ref_normalize(sxx), atol=1e-6)


def test_log_normalize_matches_reference():
    rng = np.random.RandomState(1)
    sxx = (rng.rand(64, 33).astype(np.float32) ** 4) * 3.0
    ours = np.asarray(normalize(jnp.asarray(sxx), log_scale=True))
    np.testing.assert_allclose(ours, _ref_normalize(sxx, log_scale=True),
                               atol=2e-5)


def test_global_max_override_and_nonpositive_fallback():
    rng = np.random.RandomState(2)
    sxx = rng.rand(16, 8).astype(np.float32)
    # explicit positive global max is used as base
    ours = np.asarray(normalize(jnp.asarray(sxx), global_max=10.0))
    np.testing.assert_allclose(ours, _ref_normalize(sxx, global_max=10.0),
                               atol=1e-7)
    # non-positive global max falls back to own max (PlotEngine.py:126)
    ours = np.asarray(normalize(jnp.asarray(sxx), global_max=0.0))
    np.testing.assert_allclose(ours, _ref_normalize(sxx), atol=1e-7)
    ours = np.asarray(normalize(jnp.asarray(sxx), global_max=-3.0))
    np.testing.assert_allclose(ours, _ref_normalize(sxx), atol=1e-7)


def test_degenerate_db_range_gives_zeros():
    sxx = np.full((8, 8), 2.5, dtype=np.float32)
    out = np.asarray(normalize(jnp.asarray(sxx), log_scale=True))
    np.testing.assert_array_equal(out, np.zeros_like(sxx))


def test_all_zero_input():
    sxx = np.zeros((8, 8), dtype=np.float32)
    out = np.asarray(normalize(jnp.asarray(sxx)))
    np.testing.assert_array_equal(out, np.zeros_like(sxx))


def test_batch_shared_max():
    rng = np.random.RandomState(3)
    batch = rng.rand(4, 16, 8).astype(np.float32)
    batch[2] *= 10.0  # one loud clip dominates the shared max
    out = np.asarray(normalize_batch(jnp.asarray(batch), share_max=True))
    gm = batch.max()
    for b in range(4):
        np.testing.assert_allclose(out[b], _ref_normalize(batch[b], global_max=gm),
                                   atol=1e-6)


def test_nan_pixel_with_global_max_matches_elementwise_reference():
    """A non-finite PSD value must behave like the reference's ELEMENTWISE
    nan_to_num (the bad pixel renders as db=0 and the extrema come from
    the finite pixels + that 0), not poison the analytic extrema into an
    all-zero image. Regression: the monotone-extrema shortcut returned
    all-black for any NaN under a caller-supplied global_max."""
    rng = np.random.RandomState(7)
    sxx32 = (rng.rand(16, 8).astype(np.float32)) * 1e-3
    sxx32[3, 4] = np.nan
    gm = 2e-3
    out = np.asarray(normalize(jnp.asarray(sxx32), log_scale=True,
                               global_max=gm))
    ref = _ref_normalize(sxx32.astype(np.float64), log_scale=True,
                         global_max=gm)
    assert np.isfinite(out).all()
    assert out.max() > 0.5          # the image is NOT collapsed to zeros
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_inf_pixel_matches_elementwise_reference():
    rng = np.random.RandomState(8)
    sxx32 = (rng.rand(16, 8).astype(np.float32)) * 1e-3
    sxx32[5, 2] = np.inf
    out = np.asarray(normalize(jnp.asarray(sxx32), log_scale=True))
    ref = _ref_normalize(sxx32.astype(np.float64), log_scale=True)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_db_rescale_ends_in_clamp_jaxpr_guard():
    """Structural guard for an accelerator-only behavior: a compiler that
    rewrites the dB min-max rescale as a reciprocal-multiply can overshoot
    the max pixel to
    1.0000001, so core/scale clips the rescaled image to [0, 1] after
    the division (before the degenerate-range select). On CPU the
    division lands at exactly 1.0, so no value test here can catch
    losing that clip — pin the jaxpr instead (same style as the EM
    precision guard): in program order, the clip's elementwise max+min
    pair must occur AFTER the final division (the rescale) of
    normalize(log_scale=True). jnp.clip lowers to max-then-min, not a
    clamp primitive."""
    import jax

    def flat_prims(jaxpr, out):
        for eqn in jaxpr.eqns:
            inner = eqn.params.get("jaxpr")
            if inner is not None:
                flat_prims(getattr(inner, "jaxpr", inner), out)
            else:
                out.append(eqn.primitive.name)
        return out

    jx = jax.make_jaxpr(lambda s: normalize(s, True, None))(jnp.ones((4, 5)))
    prims = flat_prims(jx.jaxpr, [])
    assert "div" in prims, prims
    last_div = len(prims) - 1 - prims[::-1].index("div")
    tail = prims[last_div + 1:]
    assert "max" in tail and "min" in tail, (
        "normalize(log_scale=True) must clip AFTER the rescale division "
        f"(1-ulp overshoot guard); ops after the last div: {tail}")
