"""STFT / power-spectral-density spectrogram core (pure jnp, jit/vmap-friendly).

Reproduces the numerical contract of the reference's compute core,
``scipy.signal.spectrogram(data, fs=fs, nperseg=nperseg, scaling="density",
mode="psd")`` at PlotEngine.py:113 (and :232), with all scipy defaults:

  * window     : Tukey(0.25), periodic
  * noverlap   : nperseg // 8   (hop = nperseg - nperseg // 8)
  * nfft       : nperseg
  * detrend    : 'constant' (per-segment mean removed before windowing)
  * scaling    : 'density'  (PSD scale 1 / (fs * sum(w**2)))
  * sides      : one-sided rFFT, interior bins doubled
  * time axis  : t[k] = (nperseg/2 + k*hop) / fs
  * boundary   : none (trailing samples that do not fill a segment are dropped)

plus a generalized mode (explicit hop, hann/hamming/..., optional centering)
for the north-star configurations. Design notes:

  * framing is expressed as reshape + static strided slices + concat (no
    gather) when gcd(nperseg, hop) > 1, which XLA lowers to cheap data
    movement; a gather fallback covers pathological hops;
  * the DFT can be computed either with jnp.fft.rfft or as two real matmuls
    against a window-folded DFT matrix (one GEMM per part; constant-detrend
    is folded into the matrix as well) — see :func:`dft_matrices`;
  * everything is shape-static given (len(x), SpecConfig) and vmaps over a
    leading batch dimension.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.config import SpecConfig
from spectral_tpu.core.windows import get_window

Array = jax.Array


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def num_frames(n: int, nperseg: int, hop: int) -> int:
    """Number of complete frames (scipy boundary=None: trailing rest dropped)."""
    if n < nperseg:
        return 0
    return (n - nperseg) // hop + 1


def ensure_real_waveform(x: Array) -> Array:
    """Coerce a public-API waveform to a real, >=32-bit float array.

    Accepts array-likes (lists/tuples) like numpy. bool/int PCM and
    sub-32-bit floats (float16/bfloat16) promote to float32 BEFORE any
    arithmetic: downstream window/DFT constants take the waveform's
    dtype, so a narrow input used to run the whole contraction in that
    dtype — int16 gave garbage, bfloat16 ~7e-3 relative error, far
    outside the 1e-3 dB contract (scipy likewise computes on a float
    copy). float64 passes through (the x64 validation runs rely on it).
    Complex waveforms are refused with a clear error: the reference
    analyzes real sweeps only (PlotEngine.py:113), and mode='complex'
    concerns the OUTPUT of stft(), not its input — the matmul engines
    would otherwise emit complex "power" silently.
    """
    x = jnp.asarray(x)
    if x.ndim == 0:
        raise ValueError("waveform must have at least one axis (got a "
                         "scalar); pass a 1-D signal or a (..., n) batch")
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise ValueError(
            f"real-valued waveform required, got {x.dtype} (complex "
            "STFT output is cfg.mode='complex'; complex inputs are not "
            "supported)")
    if (not jnp.issubdtype(x.dtype, jnp.inexact)
            or jnp.finfo(x.dtype).bits < 32):
        x = x.astype(jnp.float32)
    return x


def frame_signal(x: Array, nperseg: int, hop: int) -> Array:
    """Extract overlapping frames: (..., n) -> (..., nframes, nperseg).

    Gather-free when g = gcd(nperseg, hop) > 1: view the signal as rows of
    width g, then each frame is nperseg/g consecutive row-groups starting
    every hop/g rows — built from static strided slices + concat.
    """
    x = ensure_real_waveform(x)
    n = x.shape[-1]
    nf = num_frames(n, nperseg, hop)
    if nf <= 0:
        return jnp.zeros(x.shape[:-1] + (0, nperseg), x.dtype)

    g = math.gcd(nperseg, hop)
    if g > 1:
        pieces_per_frame = nperseg // g   # row-groups per frame
        step = hop // g                   # row stride between frame starts
        used_rows = (nf - 1) * step + pieces_per_frame
        rows = x[..., : used_rows * g].reshape(x.shape[:-1] + (used_rows, g))
        # piece i of every frame: rows[i], rows[i+step], ... (nf entries)
        pieces = [
            jax.lax.slice_in_dim(rows, i, i + (nf - 1) * step + 1, stride=step,
                                 axis=rows.ndim - 2)
            for i in range(pieces_per_frame)
        ]
        return jnp.concatenate(pieces, axis=-1)

    # Fallback: explicit gather (rare: gcd == 1). Indices are built with
    # traced iota, NOT a numpy constant: an (nf, nperseg) int array would
    # embed in the program (~40 MB for a 2 M-sample signal at 1023/256).
    idx = (jnp.arange(nf, dtype=jnp.int32)[:, None] * hop
           + jnp.arange(nperseg, dtype=jnp.int32)[None, :])
    return x[..., idx]


# ---------------------------------------------------------------------------
# Window / scaling constants (host-side, float64, baked into the program)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _window_f64(cfg: SpecConfig) -> np.ndarray:
    return get_window(cfg.window, cfg.nperseg, periodic=True)


def _require_fs(fs: float) -> float:
    """Reject nonpositive / non-finite sampling rates at the API boundary.

    Every fs-consuming formula divides by it (1/fs bin spacing,
    1/(fs*sum(w^2)) density scale), so a bad rate silently yields inf/NaN
    PSDs and axes instead of an error. The IO loaders already validate at
    parse time (SweepRegistry.register); this guards direct library calls
    (power_spectrogram / streaming / freq_axis) with the same contract.
    """
    try:
        f = float(fs)
    except (TypeError, ValueError):
        raise ValueError(
            f"sampling rate must be a positive finite number, got {fs!r}")
    if not (math.isfinite(f) and f > 0):
        raise ValueError(
            f"sampling rate must be a positive finite number, got {fs!r}")
    return f


def psd_scale(cfg: SpecConfig, fs: float) -> float:
    """Scalar PSD scale: 'density' -> 1/(fs*sum(w^2)); 'spectrum' -> 1/sum(w)^2."""
    fs = _require_fs(fs)
    w = _window_f64(cfg)
    if cfg.scaling == "density":
        return float(1.0 / (fs * np.sum(w * w)))
    return float(1.0 / (np.sum(w) ** 2))


def onesided_weights(cfg: SpecConfig, fs: float) -> np.ndarray:
    """Per-bin multiplier combining PSD scale and one-sided doubling.

    scipy doubles every interior bin of the one-sided spectrum: bins
    1..n-2 when nfft is even (Nyquist bin present, not doubled), bins
    1..n-1 when nfft is odd. DC is never doubled.
    """
    scale = psd_scale(cfg, fs)
    nb = cfg.n_freqs
    wts = np.full(nb, scale, dtype=np.float64)
    if cfg.onesided and cfg.mode == "psd":
        if cfg.nfft_ % 2 == 0:
            wts[1:-1] *= 2.0
        else:
            wts[1:] *= 2.0
    return wts


def freq_axis(cfg: SpecConfig, fs: float) -> np.ndarray:
    """Frequency bin centers (np.fft.rfftfreq semantics)."""
    fs = _require_fs(fs)
    if cfg.onesided:
        return np.fft.rfftfreq(cfg.nfft_, d=1.0 / fs)
    return np.fft.fftfreq(cfg.nfft_, d=1.0 / fs)


def time_axis(cfg: SpecConfig, fs: float, n: int) -> np.ndarray:
    """Frame-center times: t[k] = (nperseg/2 + k*hop)/fs (scipy spectrogram).

    When center=True (generalized mode) frames are centered at k*hop/fs.
    """
    fs = _require_fs(fs)
    nf = num_frames(n + (2 * (cfg.nperseg // 2) if cfg.center else 0),
                    cfg.nperseg, cfg.hop_)
    k = np.arange(nf, dtype=np.float64)
    if cfg.center:
        return k * cfg.hop_ / fs
    return (cfg.nperseg / 2.0 + k * cfg.hop_) / fs


# ---------------------------------------------------------------------------
# DFT-as-matmul constants (GEMM path; constant detrend folded in)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def dft_matrices(cfg: SpecConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices A_re, A_im of shape (nperseg, n_freqs).

    For a raw frame f (length nperseg): X[k] = sum_n d[n] w[n] e^{-2πi nk/nfft}
    where d = f - mean(f) under constant detrend. Both the window and the
    detrend projection are folded into the matrices:

        X_re = f @ A_re,  X_im = f @ A_im
        A[n,k] = w[n] c/s(-2π n k / nfft);  A <- (I - 1 1ᵀ/N) A  (detrend)

    so the full STFT is two matmuls over the framed signal.
    """
    N = cfg.nperseg
    nfft = cfg.nfft_
    w = _window_f64(cfg)
    n = np.arange(N, dtype=np.float64)[:, None]
    k = np.arange(cfg.n_freqs, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    a_re = w[:, None] * np.cos(ang)
    a_im = w[:, None] * np.sin(ang)
    if cfg.detrend == "constant":
        a_re = a_re - np.mean(a_re, axis=0, keepdims=True)
        a_im = a_im - np.mean(a_im, axis=0, keepdims=True)
    elif cfg.detrend == "linear":
        # fold the least-squares line projection: A <- (I - P) A with P the
        # orthogonal projector onto span{1, n}
        ns = np.arange(N, dtype=np.float64)[:, None]
        Q = np.linalg.qr(np.concatenate([np.ones((N, 1)), ns], axis=1))[0]
        a_re = a_re - Q @ (Q.T @ a_re)
        a_im = a_im - Q @ (Q.T @ a_im)
    return np.ascontiguousarray(a_re), np.ascontiguousarray(a_im)


# Constant-size threshold above which the DFT matrices are generated on
# device instead of baked into the program: 2 matrices at nperseg=2048 are
# already ~19 MB of f32 constants, which bloats executables. The value was
# set for the previous accelerator's compile service and is not measured on
# the H100 (ROADMAP S6).
DEVICE_DFT_BYTES = 8 * 2 ** 20


def dft_matrices_device(cfg: SpecConfig, dtype=jnp.float32):
    """Device-side (traced) construction of the window/detrend-folded real
    DFT matrices — same values as :func:`dft_matrices` to ~1e-7 relative.

    Key accuracy trick: the phase n*k/nfft wraps, so the angle is computed
    from m = (n*k) mod nfft (exact in int32 for nperseg <= 8192, since
    n*k < 2^31) and only then scaled by 2*pi/nfft — keeping |angle| <= 2*pi
    where f32 cos/sin stay at ~1e-7 error. Computing cos(-2*pi*n*k/nfft)
    directly in f32 would lose the phase entirely for large n*k.
    """
    N = cfg.nperseg
    nfft = cfg.nfft_
    w = jnp.asarray(_window_f64(cfg), dtype)[:, None]
    n = jax.lax.iota(jnp.int32, N)[:, None]
    k = jax.lax.iota(jnp.int32, cfg.n_freqs)[None, :]
    m = (n * k) % nfft
    ang = (-2.0 * jnp.pi / nfft) * m.astype(dtype)
    a_re = w * jnp.cos(ang)
    a_im = w * jnp.sin(ang)
    if cfg.detrend == "constant":
        a_re = a_re - jnp.mean(a_re, axis=0, keepdims=True)
        a_im = a_im - jnp.mean(a_im, axis=0, keepdims=True)
    elif cfg.detrend == "linear":
        ns = jnp.arange(N, dtype=dtype)[:, None]
        q1 = jnp.full((N, 1), 1.0 / jnp.sqrt(jnp.asarray(N, dtype)), dtype)
        c = ns - (N - 1) / 2.0
        q2 = c / jnp.sqrt(jnp.sum(c * c))
        Q = jnp.concatenate([q1, q2], axis=1)
        # HIGHEST: these projections bake into the DFT matrices themselves,
        # and a default-precision dot (TF32 on the GPU) would put its
        # operand rounding into every matrix entry
        hp = jax.lax.Precision.HIGHEST
        a_re = a_re - jnp.matmul(Q, jnp.matmul(Q.T, a_re, precision=hp),
                                 precision=hp)
        a_im = a_im - jnp.matmul(Q, jnp.matmul(Q.T, a_im, precision=hp),
                                 precision=hp)
    return a_re, a_im


def use_device_dft(cfg: SpecConfig) -> bool:
    """True when the folded DFT matrices are too large to embed as program
    constants (see DEVICE_DFT_BYTES)."""
    return 2 * 4 * cfg.nperseg * cfg.n_freqs > DEVICE_DFT_BYTES


def default_use_matmul(cfg: Optional[SpecConfig] = None) -> bool:
    """The engine ``use_matmul=None`` resolves to: XLA's FFT engine (rFFT;
    cuFFT on the GPU) on every backend and at every shape.

    The dense window-folded DFT and the two-stage Cooley-Tukey matmul
    engines run when pinned with ``use_matmul=True``. Which engine wins
    each shape on the H100 is not measured yet (ROADMAP S2); this function
    is the one place that decision will live.
    """
    return False


def matmul_precision(cfg: SpecConfig):
    """Dot precision of the DFT matmul engines, by ``cfg.precision``:

      'accurate' -> Precision.HIGHEST: full f32 products (never TF32 on the
                    GPU) — the production default, inside the 1e-3 dB
                    contract;
      'fast'     -> DotAlgorithmPreset.BF16_BF16_F32_X3: three bf16 passes
                    with f32 accumulation — display-only (README: about
                    5e-2 dB), NOT for the scipy contract. A plain
                    single-pass bf16 dot loses the spectrum entirely.

    There is no useful tier between 3 and 6 passes: a 4-pass
    "compensated X3" — X3(A,W) + dot(A-bf16(A), W-bf16(W)) — has exactly
    X3's error, because that error is the 2-way bf16 split's
    representation truncation (the third 8-bit mantissa chunk enters via
    a3*b1 + a1*b3), which no add-on pass over the 2-way residuals can
    recover. chip_smoke.py prints the 'fast' tier's error on the card; a
    compiler that refuses the preset fails the call loudly.
    """
    if cfg.precision == "accurate":
        return jax.lax.Precision.HIGHEST
    return jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


# ---------------------------------------------------------------------------
# Core spectrogram
# ---------------------------------------------------------------------------

def detrend_frames(frames: Array, detrend: str, nperseg: int) -> Array:
    """Per-frame detrend on framed signals (..., nframes, nperseg): 'none',
    'constant' (mean removal) or 'linear' (closed-form least-squares line
    removal). Shared by the FFT/CT engines and the sweep grid's CT branch
    (the dense engine folds detrend into its matrices instead)."""
    if detrend == "constant":
        return frames - jnp.mean(frames, axis=-1, keepdims=True)
    if detrend == "linear":
        n = jnp.arange(nperseg, dtype=frames.dtype)
        xc = n - (nperseg - 1) / 2.0
        denom = jnp.sum(xc * xc)
        mean = jnp.mean(frames, axis=-1, keepdims=True)
        slope = jnp.sum(frames * xc, axis=-1, keepdims=True) / denom
        return frames - mean - slope * xc
    return frames


def _prep_frames(x: Array, cfg: SpecConfig) -> Array:
    """Pad (center mode), frame, detrend. Returns (..., nframes, nperseg)."""
    x = ensure_real_waveform(x)   # before the pad's x.ndim / dtype use
    if cfg.center:
        p = cfg.nperseg // 2
        pad = [(0, 0)] * (x.ndim - 1) + [(p, p)]
        x = jnp.pad(x, pad, mode=cfg.pad_mode)
    frames = frame_signal(x, cfg.nperseg, cfg.hop_)
    return detrend_frames(frames, cfg.detrend, cfg.nperseg)


def stft(x: Array, cfg: SpecConfig,
         use_matmul: Optional[bool] = None) -> Array:
    """Complex STFT: (..., n) -> (..., nframes, n_freqs), frame-major.

    use_matmul selects the matmul real-DFT path (covers nfft >= nperseg,
    including scipy's zero-padded transforms); None auto-routes
    (:func:`default_use_matmul`).
    """
    if use_matmul is None:
        use_matmul = default_use_matmul(cfg)
    if not use_matmul:
        frames = _prep_frames(x, cfg)
        w = jnp.asarray(_window_f64(cfg), frames.dtype)
        fw = frames * w
        # n=cfg.nfft_ zero-pads each frame to nfft (scipy semantics)
        if cfg.onesided:
            return jnp.fft.rfft(fw, n=cfg.nfft_, axis=-1)
        return jnp.fft.fft(fw, n=cfg.nfft_, axis=-1)

    # the matmul path frames internally (window + detrend are folded into
    # the DFT matrices) — framing here too would double the framing work
    xr, xi = _matmul_dft(x, cfg)
    return jax.lax.complex(xr, xi)


# Below this nfft the dense window-folded DFT holds its own (one matmul,
# perfect fusion) and the factorized path's display-dB error exceeds the
# matmul-tier budget; at and above it the two-stage factorization cuts the
# FLOPs ~20x at 8192. The threshold was tuned on the previous accelerator
# and is not measured on the H100 (ROADMAP S6).
CT_MIN_NFFT = 2048


def ct_factors(cfg: SpecConfig) -> Optional[Tuple[int, int]]:
    """(N1, N2) for the Cooley-Tukey two-stage DFT, or None when the dense
    path should be used. N1 = 128 is a tile size chosen for the previous
    accelerator, not measured on the H100 (ROADMAP S6). nfft > nperseg
    (zero-padded transforms, scipy's nfft arg) is
    handled by padding the windowed frames to nfft before the stages.

    Zero-padding can pair a small nperseg with a large nfft; the dense
    window-folded matrices are only (nperseg, n_freqs) there, so the
    routing compares per-frame MAC counts — dense 2*nperseg*n_freqs vs
    CT 2*nfft*N1 (stage 1) + 4*N2*K2*N1 (stage 2) — instead of assuming
    CT wins at every large nfft (at nperseg=256/nfft=2048 the dense form
    does ~12% fewer MACs; at nperseg=32 it does 9x fewer)."""
    nfft = cfg.nfft_
    if nfft % 128 != 0 or nfft < CT_MIN_NFFT:
        return None
    N1, N2 = 128, nfft // 128
    K2 = N2 // 2 + 1 if cfg.onesided else N2
    if 2 * cfg.nperseg * cfg.n_freqs <= 2 * nfft * N1 + 4 * N2 * K2 * N1:
        return None
    return N1, N2


@functools.lru_cache(maxsize=16)
def _ct_matrices(nfft: int, N1: int, N2: int, onesided: bool):
    """Host-built (f64 trig on exact modular phases) stage matrices:
    W1 (N1, N1), twiddle (N2, N1), W2 (N2, K2). Tiny constants — e.g.
    ~100 KB total at nfft=8192 vs ~268 MB for the dense pair."""
    n1 = np.arange(N1)
    m1 = np.outer(n1, n1) % N1
    a1 = -2.0 * np.pi * m1 / N1
    k1 = np.arange(N1)[None, :]
    n2 = np.arange(N2)[:, None]
    at = -2.0 * np.pi * ((k1 * n2) % nfft) / nfft
    K2 = N2 // 2 + 1 if onesided else N2
    m2 = (np.arange(N2)[:, None] * np.arange(K2)[None, :]) % N2
    a2 = -2.0 * np.pi * m2 / N2
    return (np.cos(a1), np.sin(a1), np.cos(at), np.sin(at),
            np.cos(a2), np.sin(a2))


def _ct_dft(x: Array, cfg: SpecConfig, factors: Tuple[int, int]
            ) -> Tuple[Array, Array]:
    """Two-stage (Cooley-Tukey) DFT as batched matmuls.

    With n = N2*n1 + n2 and k = k1 + N1*k2:
      stage 1: A[n2, k1] = sum_n1 x[n1, n2] W_N1^{n1 k1}
      twiddle: B = A * W_N^{n2 k1}
      stage 2: X[k1 + N1 k2] = sum_n2 B[n2, k1] W_N2^{n2 k2}

    FLOPs per frame drop from 2*N*(N/2+1) (dense real DFT) to
    ~2*N*N1 + 4*N*K2 — ~20x at nfft=8192 — while every contraction
    stays a well-shaped matmul. Unlike the dense path the window cannot
    fold into the transform, so frames are prepped explicitly (same
    elementwise prep as the rFFT engine); accuracy is better than dense
    (shorter dot chains)."""
    frames = _prep_frames(x, cfg)                     # (..., T, nperseg)
    w = jnp.asarray(_window_f64(cfg), frames.dtype)
    fw = frames * w
    if cfg.nfft_ > cfg.nperseg:  # scipy nfft zero-padding semantics
        pad = [(0, 0)] * (fw.ndim - 1) + [(0, cfg.nfft_ - cfg.nperseg)]
        fw = jnp.pad(fw, pad)
    return ct_dft_frames(fw, cfg.nfft_, factors, cfg.onesided,
                         cfg.n_freqs, matmul_precision(cfg))


def ct_dft_frames(fw: Array, nfft: int, factors: Tuple[int, int],
                  onesided: bool, n_freqs: int, prec,
                  compensate: bool = False) -> Tuple[Array, Array]:
    """The factorized transform on already windowed/detrended frames
    (..., T, nfft) — the sweep grid batches a window dimension over this
    (parallel/sweep_grid.py), sharing one framing across the group.

    compensate=True recovers the TWIDDLE step's f32 rounding exactly
    (two-product/two-sum EFT on the elementwise complex multiply) and
    carries it through stage 2 as a cheap extra contraction — the twiddle
    injects eps * |A| ABSOLUTE error that stage 2 sums into every bin,
    the dominant transform-internal term of the display-dB budget at
    large nperseg (see _ct_power_compensated's module comment). The
    default path is bit-identical to before."""
    N1, N2 = factors
    c1, s1, ct, st, c2, s2 = _ct_matrices(nfft, N1, N2, onesided)
    W1c, W1s = (jnp.asarray(c1, fw.dtype), jnp.asarray(s1, fw.dtype))
    TWc, TWs = (jnp.asarray(ct, fw.dtype), jnp.asarray(st, fw.dtype))
    W2c, W2s = (jnp.asarray(c2, fw.dtype), jnp.asarray(s2, fw.dtype))

    lead = fw.shape[:-1]
    xr = jnp.swapaxes(fw.reshape(lead + (N1, N2)), -1, -2)  # (..., n2, n1)
    Are = jnp.matmul(xr, W1c, precision=prec)               # (..., n2, k1)
    Aim = jnp.matmul(xr, W1s, precision=prec)
    if compensate:
        p1, e1 = _two_prod(Are, TWc)
        p2, e2 = _two_prod(Aim, TWs)
        Bre, es = _two_sum(p1, -p2)
        eBre = (e1 - e2) + es
        p3, e3 = _two_prod(Are, TWs)
        p4, e4 = _two_prod(Aim, TWc)
        Bim, es = _two_sum(p3, p4)
        eBim = (e3 + e4) + es
    else:
        Bre = Are * TWc - Aim * TWs
        Bim = Are * TWs + Aim * TWc
    # contract n2 (the -2 axis): X[k2, k1]
    Xre = (jnp.einsum("...sk,sm->...mk", Bre, W2c, precision=prec)
           - jnp.einsum("...sk,sm->...mk", Bim, W2s, precision=prec))
    Xim = (jnp.einsum("...sk,sm->...mk", Bre, W2s, precision=prec)
           + jnp.einsum("...sk,sm->...mk", Bim, W2c, precision=prec))
    if compensate:
        # the residual is O(eps * |A|): one default-precision pass (TF32
        # on the GPU) suffices — its own error lands orders of magnitude
        # below the term being recovered.
        # This is the ONE deliberate exemption to CLAUDE.md's
        # HIGHEST-on-contract-paths rule; the exact HIGHEST/DEFAULT dot
        # mix of the route is pinned by
        # tests/test_stft_ct.py::test_compensated_route_precision_mix_is_pinned
        rp = jax.lax.Precision.DEFAULT
        Xre = Xre + (jnp.einsum("...sk,sm->...mk", eBre, W2c, precision=rp)
                     - jnp.einsum("...sk,sm->...mk", eBim, W2s, precision=rp))
        Xim = Xim + (jnp.einsum("...sk,sm->...mk", eBre, W2s, precision=rp)
                     + jnp.einsum("...sk,sm->...mk", eBim, W2c, precision=rp))
    # flat k = k1 + N1*k2; one-sided output slices to n_freqs
    K2 = Xre.shape[-2]
    Xre = Xre.reshape(lead + (K2 * N1,))[..., :n_freqs]
    Xim = Xim.reshape(lead + (K2 * N1,))[..., :n_freqs]
    return Xre, Xim


# ---------------------------------------------------------------------------
# Compensated f32 prep for the CT route (error-free transformations)
#
# At large nperseg the display-dB contract (<=1e-3 dB vs scipy f64,
# PlotEngine.py:113 at the GUI's legal max nperseg=8192, GUI.py:87-90) is
# dominated NOT by the transform but by the f32 rounding of the prep chain
# (detrend mean subtraction + window product): measured decomposition at
# 8192 on white noise — f32 prep + PERFECT f64 DFT already shows 9.3e-4 dB,
# i.e. no transform-side fix alone can widen the margin. The prep rounding
# is recoverable exactly in f32 (error-free transformations: Knuth two-sum,
# Dekker two-product), and the DFT is linear, so the lost bits ride a
# second, CHEAP transform of the residual (|X+R|^2 in the sum form). The
# twiddle step's rounding — the dominant transform-internal term — is
# recovered the same way inside ct_dft_frames(compensate=True).
# chip_smoke.py prints the compensated and the plain route's display-dB
# error at 8192 on the card: the EFTs survive only if the compiler neither
# reassociates them nor contracts them into FMAs that change their
# rounding. The cost is paid only on the 'accurate' tier's CT route
# (nfft >= 2048 display/analysis configs), never on the dense headline
# path. The residuals are ~eps scale, so their transforms tolerate one
# default-precision pass. Note: the Dekker split constant 4097 = 2^12+1 is
# f32-specific — the route is gated to f32 inputs (f64 validation runs
# keep the plain path; their error is ~1e-12 already). Known limit: deep
# spectral floors of near-pure TONES sit ~0.1-0.25 dB off scipy f64 in
# ANY f32 arithmetic (the floor is 1e-12 of the peak; the stage matmuls'
# own eps*||frame|| leakage dominates there, compensated or not) — the
# contract's bench artifact and the golden suite measure noise-like
# signals, where the budget holds with the margins above.
# ---------------------------------------------------------------------------

def _two_sum(a: Array, b: Array) -> Tuple[Array, Array]:
    """Knuth two-sum: s = fl(a+b) and the EXACT rounding residual e
    (a + b == s + e in exact arithmetic). 6 flops, branch-free."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _two_prod(a: Array, b: Array) -> Tuple[Array, Array]:
    """Dekker two-product for f32: p = fl(a*b) and the EXACT residual e
    (a * b == p + e). The 2^12+1 split halves the 24-bit mantissa so the
    partial products are exact in f32. Valid while 4097*|a| does not
    overflow (|a| < ~8e34 — far beyond any waveform)."""
    split = jnp.asarray(4097.0, a.dtype)  # 2**12 + 1
    p = a * b
    c = split * a
    a1 = c - (c - a)
    a2 = a - a1
    c = split * b
    b1 = c - (c - b)
    b2 = b - b1
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def _mean_2sum(fr: Array, nperseg: int) -> Tuple[Array, Array]:
    """Compensated per-frame mean as a double-f32 pair (m_hi, m_lo).

    Pairwise two-sum tree (log2(nperseg) vectorized halving levels — no
    scan), zero-padded to a power of two (zeros are exact); level errors
    are accumulated naively (they are O(eps), their own rounding is
    O(eps^2)). The divide-by-N residual is recovered with a two-product
    of the quotient (exact when N is a power of two, first-order
    otherwise)."""
    n2 = 1 << (nperseg - 1).bit_length()
    if n2 != nperseg:
        fr = jnp.pad(fr, [(0, 0)] * (fr.ndim - 1) + [(0, n2 - nperseg)])
    s = fr
    e_acc = jnp.zeros(fr.shape[:-1] + (1,), fr.dtype)
    while s.shape[-1] > 1:
        s, e = _two_sum(s[..., 0::2], s[..., 1::2])
        e_acc = e_acc + jnp.sum(e, axis=-1, keepdims=True)
    n = jnp.asarray(float(nperseg), fr.dtype)
    m_hi = s / n
    t, e_t = _two_prod(m_hi, n)
    m_lo = ((s - t) - e_t + e_acc) / n
    return m_hi, m_lo


def _ct_power_compensated(x: Array, cfg: SpecConfig,
                          factors: Tuple[int, int]) -> Array:
    """Raw |X|^2 via the CT route with compensated f32 prep (module
    comment above). Returns the unscaled power, frame-major
    (..., nframes, n_freqs)."""
    x = ensure_real_waveform(x)
    if cfg.center:
        p = cfg.nperseg // 2
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(p, p)],
                    mode=cfg.pad_mode)
    frames = frame_signal(x, cfg.nperseg, cfg.hop_)
    w = jnp.asarray(_window_f64(cfg), frames.dtype)
    if cfg.detrend == "constant":
        m_hi, m_lo = _mean_2sum(frames, cfg.nperseg)
        d, e_d = _two_sum(frames, -m_hi)
        r_d = e_d - m_lo
    else:  # 'none' (the 'linear' detrend keeps the plain path)
        d, r_d = frames, None
    fw, e_p = _two_prod(d, w)
    r = e_p if r_d is None else r_d * w + e_p
    if cfg.nfft_ > cfg.nperseg:  # scipy nfft zero-padding semantics
        pad = [(0, 0)] * (fw.ndim - 1) + [(0, cfg.nfft_ - cfg.nperseg)]
        fw, r = jnp.pad(fw, pad), jnp.pad(r, pad)
    xr, xi = ct_dft_frames(fw, cfg.nfft_, factors, cfg.onesided,
                           cfg.n_freqs, matmul_precision(cfg),
                           compensate=True)
    # the residual is O(eps * |fw|): one default-precision transform of it
    # contributes far below eps — one pass instead of HIGHEST's
    rr, ri = ct_dft_frames(r, cfg.nfft_, factors, cfg.onesided,
                           cfg.n_freqs, jax.lax.Precision.DEFAULT)
    # |X+R|^2 as the SUM form, not |X|^2 + cross-term: the cross form can
    # go NEGATIVE near spectral zeros (|X| ~ 0, correction dominates),
    # which the display clip turns into -120 dB pixels (measured 0.25 dB
    # blowup on a pure tone). The sum is nonnegative by construction; the
    # (xr+rr) rounding is eps RELATIVE to the bin — harmless — while the
    # recovered residual was eps * ||frame|| ABSOLUTE, the term that
    # poisoned small bins.
    sr, si = xr + rr, xi + ri
    return sr * sr + si * si


def _use_compensated_ct(x: Array, cfg: SpecConfig) -> bool:
    """The compensated route applies on the 'accurate' tier for f32 inputs
    with a foldable detrend; everything else keeps the plain CT path."""
    return (cfg.precision == "accurate"
            and cfg.detrend in ("constant", "none")
            and jnp.result_type(jnp.asarray(x).dtype, jnp.float32)
            == jnp.float32)


def _matmul_dft(x: Array, cfg: SpecConfig) -> Tuple[Array, Array]:
    """Real-DFT via matmuls: the dense window/detrend-folded form for
    small transforms, the two-stage factorized form (:func:`_ct_dft`)
    above CT_MIN_NFFT. (..., n) -> (X_re, X_im), (..., nframes, n_freqs).

    nfft > nperseg (scipy's zero-padded transform) is native to both
    forms: the dense matrices are the first nperseg rows of the
    nfft-transform (padded zeros contribute nothing), and the CT form
    pads the windowed frames."""
    fac = ct_factors(cfg)
    if fac is not None:
        return _ct_dft(x, cfg, fac)
    return _dense_dft(x, cfg)


def _dense_dft(x: Array, cfg: SpecConfig, freq_major: bool = False,
               flip_freqs: bool = False,
               band: Optional[Tuple[int, int]] = None
               ) -> Tuple[Array, Array]:
    """The dense window/detrend-folded DFT matmuls.

    freq_major=True emits (..., n_freqs, nframes) directly by contracting
    the frame axis against the matrix rows (einsum "nf,...tn->...ft") —
    the display path's layout with no transpose materialized on device.
    flip_freqs=True additionally reverses the matrix COLUMNS so frequency
    rows come out display-flipped (highest frequency first) with no
    device-side flip pass. Per output element the contraction is
    identical, so values are bitwise equal to (flipped) swapaxes of the
    frame-major result.

    band=(lo, hi) folds the reference's frequency row mask
    (PlotEngine.py:114-115) into the matrices too: only the masked bins'
    COLUMNS are kept (sliced on the unflipped bin axis, before the flip),
    so a banded display — e.g. the GUI's EEG default fmax=30 Hz, 62 of
    513 rows at nperseg=1024/fs=1000 — contracts ~8x fewer MACs and
    never materializes the full-band spectrum. Each retained output
    element is the identical dot product, so values stay bitwise equal
    to slicing the full result."""
    prec = matmul_precision(cfg)
    x = ensure_real_waveform(x)   # before the pad's x.ndim / dtype use
    raw = frame_signal(
        x if not cfg.center else jnp.pad(
            x, [(0, 0)] * (x.ndim - 1) + [(cfg.nperseg // 2,) * 2],
            mode=cfg.pad_mode),
        cfg.nperseg, cfg.hop_)
    # NOTE: a "packed" variant — [A_re | A_im interior] as ONE GEMM with
    # exactly nfft output columns (the imag DC/Nyquist columns are
    # identically zero) — was slower end to end on the previous
    # accelerator: XLA fuses re^2+im^2 into the two-matmul epilogues, and
    # the packed form's slice/pad arithmetic breaks that fusion. Not
    # measured on the H100.
    if use_device_dft(cfg):
        a_re_d, a_im_d = dft_matrices_device(cfg, raw.dtype)
        if band is not None:
            a_re_d = a_re_d[:, band[0]:band[1]]
            a_im_d = a_im_d[:, band[0]:band[1]]
        if flip_freqs:
            a_re_d = jnp.flip(a_re_d, axis=1)
            a_im_d = jnp.flip(a_im_d, axis=1)
    else:
        a_re, a_im = dft_matrices(cfg)
        if band is not None:
            a_re, a_im = a_re[:, band[0]:band[1]], a_im[:, band[0]:band[1]]
        if flip_freqs:
            a_re, a_im = a_re[:, ::-1], a_im[:, ::-1]
        a_re_d = jnp.asarray(np.ascontiguousarray(a_re), raw.dtype)
        a_im_d = jnp.asarray(np.ascontiguousarray(a_im), raw.dtype)
    if freq_major:
        xr = jnp.einsum("nf,...tn->...ft", a_re_d, raw, precision=prec)
        xi = jnp.einsum("nf,...tn->...ft", a_im_d, raw, precision=prec)
    else:
        xr = jnp.matmul(raw, a_re_d, precision=prec)
        xi = jnp.matmul(raw, a_im_d, precision=prec)
    return xr, xi


def power_spectrogram(x: Array, fs: float, cfg: SpecConfig,
                      use_matmul: Optional[bool] = None) -> Array:
    """PSD spectrogram, frame-major: (..., n) -> (..., nframes, n_freqs).

    Matches scipy.signal.spectrogram(..., scaling=cfg.scaling, mode='psd')
    values (scipy returns freq-major (n_freqs, nframes); transpose to
    compare). use_matmul=None auto-routes per backend
    (:func:`default_use_matmul`).
    """
    if cfg.mode == "complex":
        raise ValueError("mode='complex' has no power spectrogram; "
                         "use stft() (or spectrogram(), which routes it)")
    if use_matmul is None:
        use_matmul = default_use_matmul(cfg)
    if use_matmul:
        fac = ct_factors(cfg)
        if fac is not None and _use_compensated_ct(x, cfg):
            p = _ct_power_compensated(x, cfg, fac)
        else:
            xr, xi = _matmul_dft(x, cfg)
            p = xr * xr + xi * xi
    else:
        frames = _prep_frames(x, cfg)
        w = jnp.asarray(_window_f64(cfg), frames.dtype)
        fw = frames * w
        X = jnp.fft.rfft(fw, n=cfg.nfft_, axis=-1) if cfg.onesided \
            else jnp.fft.fft(fw, n=cfg.nfft_, axis=-1)
        p = jnp.real(X) ** 2 + jnp.imag(X) ** 2
    return _scale_psd(p, cfg, fs)


def _scale_psd(p: Array, cfg: SpecConfig, fs: float, *,
               freq_major: bool = False, flip_freqs: bool = False,
               band: Optional[Tuple[int, int]] = None) -> Array:
    """Apply the onesided/window scaling (and scipy's mode='magnitude'
    sqrt-of-scale) to a raw |X|^2 spectrogram. freq_major=True broadcasts
    the weights down a frequency axis at -2; flip_freqs pre-flips them to
    match a display-flipped frequency axis; band=(lo, hi) slices them to
    a banded spectrum's rows (the DC/Nyquist no-doubling weights follow
    the retained bins).

    Weights follow p's dtype (like the window constant): an unconditional
    float32 cast silently capped float64 validation runs at ~2e-8
    relative error."""
    wts = onesided_weights(cfg, fs)
    if band is not None:
        wts = wts[band[0]:band[1]]
    if flip_freqs:
        wts = wts[::-1].copy()
    w = jnp.asarray(wts, p.dtype)
    if freq_major:
        w = w[:, None]
    if cfg.mode == "magnitude":
        return jnp.sqrt(p) * jnp.sqrt(w)
    return p * w


def power_spectrogram_fm(x: Array, fs: float, cfg: SpecConfig,
                         use_matmul: Optional[bool] = None,
                         flip_freqs: bool = False,
                         band: Optional[Tuple[int, int]] = None) -> Array:
    """Freq-major PSD: (..., n) -> (..., n_freqs, nframes) — the display/
    pipeline layout (the reference renders freq-major, PlotEngine.py:123).
    flip_freqs=True returns rows display-flipped (highest frequency first,
    the PNG row order). band=(lo, hi) returns only those bins of the
    UNFLIPPED one-sided axis (the reference's row mask,
    PlotEngine.py:114-115), flipped within the band when flip_freqs.

    On the dense matmul route the transpose, the flip, AND the band mask
    are all folded into the DFT contraction itself (:func:`_dense_dft`),
    so no relayout/flip pass or full-band intermediate is materialized on
    device; values are bitwise identical to (flipped) slicing of
    ``swapaxes(power_spectrogram(...), -1, -2)``. The CT and FFT routes
    fall back to transposing/flipping/slicing the frame-major result
    (their internal layouts do not admit the folds).
    """
    if cfg.mode == "complex":
        raise ValueError("mode='complex' has no power spectrogram; "
                         "use stft() (or spectrogram(), which routes it)")
    if band is not None and not cfg.onesided:
        raise ValueError("band slicing requires a one-sided spectrum")
    if use_matmul is None:
        use_matmul = default_use_matmul(cfg)
    if use_matmul and ct_factors(cfg) is None:
        xr, xi = _dense_dft(x, cfg, freq_major=True, flip_freqs=flip_freqs,
                            band=band)
        p = xr * xr + xi * xi
        return _scale_psd(p, cfg, fs, freq_major=True,
                          flip_freqs=flip_freqs, band=band)
    p = jnp.swapaxes(
        power_spectrogram(x, fs, cfg, use_matmul=use_matmul), -1, -2)
    if band is not None:
        p = p[..., band[0]:band[1], :]
    return jnp.flip(p, axis=-2) if flip_freqs else p


def effective_config(cfg: SpecConfig, n: int) -> SpecConfig:
    """scipy's short-signal auto-shrink: nperseg greater than the signal
    length shrinks to the length (with scipy's UserWarning text), and the
    scipy-default hop/noverlap recompute from the shrunk nperseg — so a
    signal shorter than nperseg yields ONE frame like the reference, not
    an empty spectrogram. Scoped to scipy-compat semantics (hop=None,
    center=False); generalized explicit-hop configs keep their static
    shape and yield zero frames, as num_frames documents."""
    if 0 < n < cfg.nperseg and cfg.hop is None and not cfg.center:
        import dataclasses
        import warnings
        warnings.warn(f"nperseg = {cfg.nperseg} is greater than input "
                      f"length  = {n}, using nperseg = {n}", UserWarning)
        return dataclasses.replace(cfg, nperseg=n)
    return cfg


def spectrogram(x: Array, fs: float, cfg: SpecConfig,
                use_matmul: Optional[bool] = None
                ) -> Tuple[np.ndarray, np.ndarray, Array]:
    """Full reference-parity spectrogram: returns (f, t, Sxx) freq-major.

    Mirrors PlotEngine._plot_spectrogram's compute portion (PlotEngine.py:113-115):
    scipy call + frequency-band row mask [cfg.fmin, cfg.fmax] applied BEFORE any
    normalization. f/t are host numpy (static given shapes); Sxx is a device
    array of shape (..., n_masked_freqs, nframes).
    """
    x = ensure_real_waveform(x)   # array-likes, dtype promotion, complex ban
    cfg = effective_config(cfg, x.shape[-1])
    f = freq_axis(cfg, fs)
    t = time_axis(cfg, fs, x.shape[-1])
    if cfg.mode == "complex":
        # scipy mode='complex': complex STFT scaled by sqrt(psd scale),
        # no one-sided doubling
        p = stft(x, cfg, use_matmul=use_matmul) * np.sqrt(psd_scale(cfg, fs))
    else:
        p = power_spectrogram(x, fs, cfg, use_matmul=use_matmul)  # (..., T, F)
    sxx = jnp.swapaxes(p, -1, -2)  # freq-major like scipy
    if cfg.fmin is not None or cfg.fmax is not None:
        f, sxx = mask_band_rows(f, sxx, cfg.fmin, cfg.fmax)
    return f, t, sxx


def band_row_slice(f: np.ndarray, fmin: Optional[float],
                   fmax: Optional[float]) -> Optional[Tuple[int, int]]:
    """Static (lo, hi) row slice of the reference's frequency mask
    (PlotEngine.py:114-115) on a monotone frequency axis; None = no mask.
    Raises on an empty band (a dataset export should refuse instead of
    writing blank images; interactive callers that need the reference's
    empty-band early-return check emptiness themselves first) and on a
    non-contiguous mask (two-sided fftfreq ordering — use
    :func:`mask_band_rows`' gather fallback there)."""
    if fmin is None and fmax is None:
        return None
    lo = fmin if fmin is not None else -np.inf
    hi = fmax if fmax is not None else np.inf
    idx = np.where((f >= lo) & (f <= hi))[0]
    if idx.size == 0:
        raise ValueError(
            f"the requested band [{fmin}, {fmax}] Hz contains no "
            f"frequency rows (axis spans {f[0]:.6g}..{f[-1]:.6g} Hz)")
    if idx.size != int(idx[-1]) - int(idx[0]) + 1:
        raise ValueError("band mask is non-contiguous on this frequency "
                         "axis (two-sided spectra are not supported here)")
    return int(idx[0]), int(idx[-1]) + 1


def mask_band_rows(f: np.ndarray, sxx, fmin: Optional[float],
                   fmax: Optional[float]):
    """Apply the reference's frequency row mask (PlotEngine.py:114-115) to a
    freq-major spectrogram (..., F, T). Works on device or numpy arrays.

    Uses a slice when the masked band is contiguous (one-sided spectra; a
    slice is a cheap copy where a gather is an indexed load) and falls back
    to a gather for non-contiguous masks (two-sided fftfreq ordering)."""
    lo = fmin if fmin is not None else -np.inf
    hi = fmax if fmax is not None else np.inf
    mask = (f >= lo) & (f <= hi)
    idx = np.where(mask)[0]
    f = f[mask]
    axis = sxx.ndim - 2
    if idx.size == 0:
        return f, sxx[..., :0, :]
    contiguous = bool(np.all(np.diff(idx) == 1))
    if isinstance(sxx, np.ndarray):
        out = (sxx[..., idx[0]:idx[-1] + 1, :] if contiguous
               else np.take(sxx, idx, axis=axis))
    elif contiguous:
        out = jax.lax.slice_in_dim(sxx, int(idx[0]), int(idx[-1]) + 1,
                                   axis=axis)
    else:
        out = jnp.take(sxx, jnp.asarray(idx), axis=axis)
    return f, out
