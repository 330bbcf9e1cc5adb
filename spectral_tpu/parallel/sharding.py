"""Sharded batch pipelines (pjit / NamedSharding).

The throughput workloads (BASELINE.json config 5: 10k clips end-to-end across
several devices) are embarrassingly parallel over clips: shard the batch
dimension over the 'data' mesh axis and let every device run the fused
STFT -> scale -> colormap pipeline on its shard. The only cross-device
communication is the optional shared normalization maximum (the reference's
``global_max`` parameter, PlotEngine.py:78,110,126), which XLA lowers to an
all-reduce when requested.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import numpy as np

from spectral_tpu.config import SpecConfig
from spectral_tpu.core.scale import normalize_batch
from spectral_tpu.core.stft import (power_spectrogram_fm, freq_axis,
                                    band_row_slice as _band_slice)
from spectral_tpu.core.mel import mel_filterbank, mel_centers
from spectral_tpu.ops.colormap import apply_colormap_packed

Array = jax.Array


def batched_spectrogram_fn(fs: float, cfg: SpecConfig, *,
                           use_matmul: bool = True,
                           colormap: Optional[str] = "jet",
                           share_max: bool = False,
                           flip_image: bool = False,
                           psd_sharding=None):
    """Build the per-shard batch pipeline (B, n) -> dict of outputs.

    flip_image=True emits "image" (and "rgb_packed") display-flipped —
    row 0 is the HIGHEST frequency, the PNG row order — with the flip
    folded into the DFT matrix columns on the dense route, so no
    device-side flip pass exists anywhere in the image path
    (bit-identical packed words). "psd"/"mel" stay frame-major unflipped
    regardless.

    cfg.fmin/fmax mask frequency rows BEFORE normalization, exactly like
    the reference (PlotEngine.py:114-127: mask, then base = max over the
    masked band) and like the render/stream paths; for mel configs the
    mask applies to the mel-center axis (api/session semantics). The
    masked rows are a static contiguous slice, so the flip fold still
    applies. In mel mode the side output "psd" stays full-band (it is the
    pre-mel spectrum, not the displayed one).

    psd_sharding (a NamedSharding over the freq-major (B, F, T) spectrum)
    pins the DFT contraction's layout under pjit: sharding F over a mesh
    axis is TENSOR parallelism over frequency bins — each device contracts
    frames against its slice of the DFT matrix columns (the matrices are
    generated on device inside jit, so each device materializes only its
    rows) and the downstream per-image max/min reductions become
    collectives. The reference has no counterpart (single-process scipy);
    this is the scaling form for huge-nfft spectra that outgrow one
    device.

    Returns a plain jax-traceable function; wrap with jit/pjit via
    :func:`shard_pipeline` or call directly under vmap.
    """
    n_mels = cfg.n_mels
    # static band-row slices (reference mask, PlotEngine.py:114-115)
    if n_mels:
        band = None
        band_mel = _band_slice(
            mel_centers(n_mels, fs, cfg.mel_fmin, cfg.mel_fmax,
                        cfg.mel_htk), cfg.fmin, cfg.fmax)
    else:
        band = _band_slice(freq_axis(cfg, fs), cfg.fmin, cfg.fmax)
        band_mel = None

    def fn(xb: Array):
        # freq-major spine: the display/mel consumers want (B, F, T), and
        # power_spectrogram_fm folds that transpose into the dense DFT
        # contraction. The frame-major "psd" output transposes back — a cost
        # only paid when a caller actually consumes it (XLA DCEs it away
        # under jit otherwise), exactly mirroring the old layout's cost
        # when the image was consumed.
        flip_dense = flip_image and not n_mels
        # the band mask folds into the dense DFT matrix columns (together
        # with the flip), so banded displays never compute or materialize
        # the full-band spectrum (core/stft._dense_dft)
        psd_fm = power_spectrogram_fm(xb, fs, cfg, use_matmul=use_matmul,
                                      flip_freqs=flip_dense,
                                      band=band)  # (B, F[band], T)
        if psd_sharding is not None:
            psd_fm = jax.lax.with_sharding_constraint(psd_fm, psd_sharding)
        if n_mels:
            out = {"psd": jnp.swapaxes(psd_fm, -1, -2)}  # full-band pre-mel
            fb = mel_filterbank(n_mels, psd_fm.shape[-2], fs, cfg.mel_fmin,
                                cfg.mel_fmax, cfg.mel_htk)
            mel_fm = jnp.einsum("mf,...ft->...mt",
                                jnp.asarray(fb, psd_fm.dtype), psd_fm,
                                precision=jax.lax.Precision.HIGHEST)
            if band_mel is not None:
                lo, hi = band_mel
                mel_fm = mel_fm[..., lo:hi, :]
            out["mel"] = jnp.swapaxes(mel_fm, -1, -2)
            base_fm = jnp.flip(mel_fm, -2) if flip_image else mel_fm
        else:
            psd_unf = jnp.flip(psd_fm, -2) if flip_dense else psd_fm
            out = {"psd": jnp.swapaxes(psd_unf, -1, -2)}
            base_fm = psd_fm            # already flipped when flip_dense
        # normalize is flip-invariant per pixel (min/max are exact), so the
        # flipped image is bitwise the flip of the unflipped one
        img = normalize_batch(base_fm, cfg.log_scale, share_max)
        out["image"] = img
        # per-clip health of the DISPLAYED spectrum (pre-normalize: the dB
        # map's nan_to_num launders inf into finite pixels) — consumers
        # that ignore it pay nothing (XLA DCEs the reduction); the export
        # pipeline uses it to skip/raise instead of writing garbage PNGs.
        # Besides inf/NaN (f32 power overflow, non-finite samples) the
        # flag also trips on TOTAL f32 underflow: a tiny-but-real clip
        # (detrended amplitude under ~1e-10) whose |X|^2 underflows every
        # bin to zero would export a blank image the reference's f64
        # never produces. True silence / pure DC (detrended amplitude
        # exactly 0, where f64 is zero too) stays healthy.
        adet = jnp.max(jnp.abs(xb - jnp.mean(xb, axis=-1, keepdims=True)),
                       axis=-1)
        underflow = (~jnp.any(base_fm != 0, axis=(-2, -1))
                     & (adet > 0) & (adet < 1e-10))
        out["finite"] = (jnp.all(jnp.isfinite(base_fm), axis=(-2, -1))
                         & ~underflow)
        if colormap:
            out["rgb_packed"] = apply_colormap_packed(
                img, colormap, flip_rows=not flip_image)
        return out

    return fn


def time_sharded_spectrogram(mesh: Mesh, fs: float, cfg: SpecConfig, *,
                             seq_axis: str = "data",
                             use_matmul: bool = True):
    """Sequence parallelism over ONE recording's raw sample axis.

    The dp/tp forms above parallelize over clips and frequency bins; this
    is the third mesh axis of the problem — a single recording too long
    for one device, sharded along TIME. Each device holds a contiguous span
    of samples and computes the frames that START in its span; because
    frames overlap by ``nperseg - hop`` samples, each device first fetches
    that many samples from its right neighbour with ONE
    ``lax.ppermute`` (one neighbour-to-neighbour copy — no all-gather, no
    full-signal replication anywhere). The reference has no counterpart
    (single-process scipy over the whole array, PlotEngine.py:113); this
    is the scaling form for recordings too long for one device.

    Returns a jitted callable ``x (..., L) -> psd (..., L//hop, F)`` where
    the last axis of ``x`` and the frame axis of the output are sharded
    over ``seq_axis``. The output is an ordinary GSPMD global array:
    downstream reductions (band-power folds, normalization max) compose
    under jit and lower to collectives automatically.

    The frame axis is the evenly-shardable ``L//hop``, NOT scipy's
    ``num_frames(L, nperseg, hop)``: the last ``L//hop - num_frames``
    rows (< nperseg/hop, all on the last shard) are frames whose window
    would cross the end of the recording — scipy drops them; here they
    are ZEROED in-shard so sums/maxes over frames match the valid-frame
    answer exactly. They cannot be sliced off on device: an uneven
    sharded axis is unrepresentable (jit rejects it) and the only other
    lowering is a full all-gather of the spectrogram just to drop <4
    rows (observed before this design). Slice ``[..., :num_frames(L,
    cfg.nperseg, cfg.hop_), :]`` after fetching to host (or accept the
    gather) when the exact scipy shape is needed.

    .. warning:: The zero rows are neutral ONLY for nonnegative
       reductions (sum, max, mean-after-rescale). A min over frames, a
       log/dB map, or normalize-style (val - min)/(max - min) scaling
       sees the zeros as real data (min collapses to 0; log underflows
       to -inf). For those folds, slice to the valid frame count first
       — the returned callable carries it as ``fn.num_valid_frames(L)``
       — or fold only over ``[..., :fn.num_valid_frames(L), :]``.

    Constraints (checked at trace time): ``center=False`` framing (the
    scipy contract; centered padding does not decompose across shards),
    ``L`` divisible by the axis size, per-shard length a multiple of
    ``hop`` (so every frame start lands in exactly one shard), and halo
    ``nperseg - hop <= L/D`` (halo crosses at most one neighbour).
    Per-frame values match :func:`core.stft.power_spectrogram` exactly up
    to matmul-shape reassociation (pinned in tests/test_parallel.py).
    """
    if cfg.center:
        raise ValueError("time_sharded_spectrogram requires center=False "
                         "framing (centered padding does not decompose "
                         "across time shards)")
    if cfg.mode == "complex":
        raise ValueError("mode='complex' has no power spectrogram")
    if seq_axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {seq_axis!r}: {mesh.shape}")
    from spectral_tpu.core.stft import num_frames, power_spectrogram
    D = mesh.shape[seq_axis]
    hop, nperseg = cfg.hop_, cfg.nperseg
    halo = nperseg - hop

    def call(x: Array) -> Array:
        L = x.shape[-1]
        if L % D:
            raise ValueError(f"sample axis {L} not divisible by "
                             f"{seq_axis!r} size {D}")
        Lc = L // D
        if Lc % hop:
            raise ValueError(f"per-shard length {Lc} must be a multiple of "
                             f"hop {hop} so frame starts align to shards")
        if halo > Lc:
            raise ValueError(f"halo nperseg-hop={halo} exceeds the shard "
                             f"length {Lc}; use fewer shards")
        t_total = num_frames(L, nperseg, hop)
        if t_total <= 0:
            raise ValueError(f"recording ({L} samples) shorter than one "
                             f"frame ({nperseg})")
        lead = (None,) * (x.ndim - 1)
        perm = [(d + 1, d) for d in range(D - 1)]
        t_loc = Lc // hop

        def body(xs: Array) -> Array:
            if halo:
                h = jax.lax.ppermute(xs[..., :halo], seq_axis, perm)
                xs = jnp.concatenate([xs, h], axis=-1)
            # (Lc + halo - nperseg)//hop + 1 == Lc//hop local frames —
            # exactly the frames starting in this shard
            psd = power_spectrogram(xs, fs, cfg, use_matmul=use_matmul)
            if t_loc * D > t_total:
                # the last shard's tail frames window into the ppermute
                # zero-fill (no right neighbour) — scipy drops these
                # partial frames; zero them in-shard (docstring)
                g = (jax.lax.axis_index(seq_axis) * t_loc
                     + jnp.arange(t_loc))
                psd = psd * (g < t_total).astype(psd.dtype)[:, None]
            return psd

        return jax.shard_map(body, mesh=mesh,
                             in_specs=P(*lead, seq_axis),
                             out_specs=P(*lead, seq_axis, None))(x)

    from spectral_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    fn = jax.jit(call)
    # Host-side companion for the docstring's min/log-fold warning: the
    # count of frames that are real (non-zeroed) for a given length.
    fn.num_valid_frames = lambda L: num_frames(L, nperseg, hop)
    return fn


def shard_pipeline(mesh: Mesh, fs: float, cfg: SpecConfig, *,
                   use_matmul: bool = True,
                   colormap: Optional[str] = "jet",
                   share_max: bool = False,
                   batch_axis: str = "data",
                   freq_axis: Optional[str] = None):
    """jit the batch pipeline with the batch dim sharded over `batch_axis`.

    The batch size must be divisible by the mesh axis size.

    freq_axis adds TENSOR parallelism over frequency bins on top of the
    data parallelism: the freq-major spectrum is constrained to
    P(batch_axis, freq_axis, None), so each device contracts frames
    against its own slice of the (device-generated) DFT matrix columns and
    the per-image normalization max/min ride collectives across the freq
    shards. Outputs stay batch-sharded (GSPMD gathers the freq shards at
    the boundary) — the win is that no device ever materializes the full
    (B/dp, F, T) spectrum or the full DFT matrices, the scaling form for
    huge-nfft work. Mel configs compose: the mel contraction reduces over
    the sharded F axis (a reduce-scatter/all-reduce).
    """
    from spectral_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    psd_sh = (NamedSharding(mesh, P(batch_axis, freq_axis, None))
              if freq_axis else None)
    fn = batched_spectrogram_fn(fs, cfg, use_matmul=use_matmul,
                                colormap=colormap, share_max=share_max,
                                psd_sharding=psd_sh)
    in_sh = NamedSharding(mesh, P(batch_axis))
    out_sh = NamedSharding(mesh, P(batch_axis))
    return jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
