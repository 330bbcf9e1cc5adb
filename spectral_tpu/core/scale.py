"""Normalization / dB mapping for display.

Exact reproduction of the reference's post-processing (PlotEngine.py:126-131):

    base = max(Sxx)            # or caller-supplied global_max if > 0
    Sxx_norm = clip(Sxx / (base + 1e-20), 0, 1)
    if log_scale:
        Sxx_db = 10*log10(Sxx_norm + 1e-12); nan_to_num
        rng = max_db - min_db
        Sxx_norm = (Sxx_db - min_db)/rng  if rng > 1e-6 else zeros

The ``global_max`` parameter mirrors PlotEngine.plot_extra/_plot_spectrogram's
``global_max`` argument (PlotEngine.py:78,110,126): when a batch of sweeps is
normalized against a shared maximum. Under pjit with a sharded batch, taking
``jnp.max`` over the whole batch produces that shared maximum with an
all-reduce inserted by XLA automatically.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

Array = jax.Array


def _display_map(sxx: Array, base_max: Array, ext_min: Array,
                 ext_max: Array, log_scale: bool,
                 global_max: Optional[Union[float, Array]],
                 has_nan: Optional[Array]) -> Array:
    """The single implementation of PlotEngine.py:126-131 (both public
    entry points delegate here so the parity-tracked arithmetic exists
    once). base_max is the NaN-propagating max(Sxx) used for base
    selection (np.max semantics); ext_min/ext_max feed the dB extrema;
    has_nan (when provided) folds the 0 that nan_to_num assigns NaN
    pixels into the extrema, exactly like the reference's elementwise
    reduction over the nan_to_num'd dB array."""
    if global_max is None:
        base = base_max
    else:
        gm = jnp.asarray(global_max, sxx.dtype)
        base = jnp.where(gm > 0, gm, base_max)
    if not log_scale:
        return jnp.clip(sxx / (base + 1e-20), 0.0, 1.0)

    # The dB min-max rescale needs min(db)/max(db), but db is a monotone
    # non-decreasing function of Sxx over finite values, so min(db) ==
    # db(min(Sxx)) and max(db) == db(max(Sxx)) BIT-EXACTLY (the same fp
    # ops on the same element). Reducing Sxx once instead of materializing
    # db and reducing it again turns the reference's 3-full-array-pass
    # tail into 2: one fused reduction + one fused elementwise map that
    # XLA folds into whatever consumes the image (e.g. the colormap
    # gather). NaN pixels break monotonicity — they map to 0 via
    # nan_to_num — so the caller passes NaN-ignoring extrema plus
    # has_nan, and the 0 is folded in explicitly.
    def db_of(v):
        return jnp.nan_to_num(
            10.0 * jnp.log10(jnp.clip(v / (base + 1e-20), 0.0, 1.0)
                             + 1e-12))

    min_db = db_of(ext_min)
    max_db = db_of(ext_max)
    if has_nan is not None:
        min_db = jnp.where(has_nan, jnp.minimum(min_db, 0.0), min_db)
        max_db = jnp.where(has_nan, jnp.maximum(max_db, 0.0), max_db)
    rng = max_db - min_db
    db = db_of(sxx)
    rescaled = (db - min_db) / jnp.where(rng > 1e-6, rng, 1.0)
    # The reference's numpy division lands the max pixel at exactly 1.0;
    # an accelerator compiler may rewrite x/rng as x * (1/rng), whose
    # double rounding can overshoot by 1 ulp (1.0000001). Clip to the
    # reference's value range — an identity wherever the division is
    # exact, so CPU parity tests are unaffected.
    rescaled = jnp.clip(rescaled, 0.0, 1.0)
    return jnp.where(rng > 1e-6, rescaled, jnp.zeros_like(db))


def normalize(sxx: Array, log_scale: bool = False,
              global_max: Optional[Union[float, Array]] = None) -> Array:
    """Map a PSD spectrogram to the [0, 1] display image.

    global_max semantics (PlotEngine.py:126): used as the base only if > 0,
    otherwise fall back to max(Sxx). Pass a traced scalar for cross-batch
    normalization, or None for per-image normalization.
    """
    # nanmin/nanmax + isnan fuse into the same single reduction pass; the
    # NaN-propagating max keeps np.max base-selection parity.
    return _display_map(sxx, jnp.max(sxx), jnp.nanmin(sxx), jnp.nanmax(sxx),
                        log_scale, global_max,
                        jnp.any(jnp.isnan(sxx)) if log_scale else None)


def normalize_from_stats(sxx: Array, own_min: Array, own_max: Array,
                         log_scale: bool = False,
                         global_max: Optional[Union[float, Array]] = None
                         ) -> Array:
    """:func:`normalize` with the image's min/max supplied by the caller
    (e.g. reduced inside the Pallas kernel) — BIT-IDENTICAL output for
    finite PSDs, since normalize itself only consumes min(sxx)/max(sxx)
    (the dB extrema are the monotone dB map evaluated at them). Saves the
    reduction pass over the full array: the remaining work is one fused
    elementwise map. Assumes a finite PSD (the Pallas kernel's masked
    stats are finite whenever the input signal is)."""
    return _display_map(sxx, own_max, own_min, own_max, log_scale,
                        global_max, None)


def normalize_batch(sxx_batch: Array, log_scale: bool = False,
                    share_max: bool = False) -> Array:
    """Normalize a freq-major batch (B, F, T). share_max=True uses one max
    across the batch — the reference's global_max workflow (one base across
    the batch, PlotEngine.py:78,110,126); the dB min-max rescale stays
    per-image, as each reference figure rescales its own dB range. Under
    pjit with a sharded batch the shared max becomes an all-reduce."""
    if share_max:
        gm = jnp.max(sxx_batch)
        return jax.vmap(lambda s: normalize(s, log_scale, gm))(sxx_batch)
    return jax.vmap(lambda s: normalize(s, log_scale, None))(sxx_batch)
