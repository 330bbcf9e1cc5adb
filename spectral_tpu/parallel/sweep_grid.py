"""Parameter-sweep grids: many (nperseg, hop, window) combos on one signal.

BASELINE.json config 3: "16 combos of (n_fft in 256..4096, hop, window fn)
over one clip, vmapped into one launch". Combos that share (nperseg,
hop, detrend, scaling) produce identically-shaped outputs and differ only in
the window — and since the DFT is a matmul with the window folded into the
matrix (core.stft.dft_matrices), a window sweep is ONE batched matmul over
stacked DFT matrices: frames are built once per shape group and shared.
Different shapes launch separately but share the same signal buffer in HBM
(SURVEY.md §7 hard-part 6).

Engine choice: the dense (<2048) and factorized Cooley-Tukey (>=2048)
matmul forms. An rFFT-based grid engine (frames x stacked windows ->
jnp.fft.rfft) was slower at every group size on the previous accelerator,
whose FFTs ran without its matrix units; which engine wins on the H100 is
not measured yet (ROADMAP S2). Scale-out is clip-parallel: the batched
grid lowers with zero cross-clip collectives when the batch dim is sharded
over a mesh (tests/test_sweep_grid_batch.py).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.config import SpecConfig
from spectral_tpu.core.stft import (ct_dft_frames, ct_factors, dft_matrices,
                                    dft_matrices_device, frame_signal,
                                    onesided_weights, use_device_dft,
                                    _window_f64)

Array = jax.Array


def _shape_key(cfg: SpecConfig) -> Tuple:
    # precision is part of the key: the group's matmuls run at ONE tier, so
    # mixing 'accurate' and 'fast' configs in a group would silently compute
    # some of them at the wrong tier (bf16 3-pass breaks the 1e-3 dB
    # contract for an 'accurate' config)
    return (cfg.nperseg, cfg.hop_, cfg.nfft_, cfg.detrend, cfg.scaling,
            cfg.center, cfg.pad_mode, cfg.onesided, cfg.precision)


def sweep_grid(x: Array, fs: float, configs: Sequence[SpecConfig]
               ) -> List[Array]:
    """Compute PSD spectrograms for every config over one signal.

    Returns one frame-major PSD array per config (same order). Within a
    shape group the window dimension is vmapped: stacked window-folded DFT
    matrices, one framing, one batched matmul.
    """
    groups: Dict[Tuple, List[int]] = defaultdict(list)
    for i, cfg in enumerate(configs):
        if cfg.mode != "psd":
            # the fused (re^2 + im^2) * weights form IS the PSD; magnitude/
            # complex configs would silently get PSD values back
            raise ValueError("sweep_grid supports mode='psd' configs only")
        groups[_shape_key(cfg)].append(i)

    results: List[Array] = [None] * len(configs)  # type: ignore
    for key, idxs in groups.items():
        nperseg, hop = key[0], key[1]
        xg = x
        if key[5]:   # center=True: same reflect pad as core._prep_frames —
            # framing the raw signal would drop frames and shift centers
            # vs power_spectrogram for the identical config
            p = nperseg // 2
            pad = [(0, 0)] * (x.ndim - 1) + [(p, p)]
            xg = jnp.pad(x, pad, mode=key[6])
        frames = frame_signal(xg, nperseg, hop)  # shared per group
        wts = np.stack([onesided_weights(configs[i], fs) for i in idxs])

        from spectral_tpu.core.stft import matmul_precision
        prec = matmul_precision(configs[idxs[0]])

        fac = ct_factors(configs[idxs[0]])
        if fac is not None:
            # Large transforms: the factorized CT engine. The window no
            # longer folds into a per-config matrix, so detrend applies to
            # the shared frames once (the dense path folds it into the
            # matrices) and the window dimension is a broadcast multiply —
            # no per-window DFT matrices in HBM at all (the dense 4096
            # pair is ~67 MB per window).
            from spectral_tpu.core.stft import detrend_frames
            frames = detrend_frames(frames, key[3], nperseg)
            W = len(idxs)
            nfft = key[2]
            wins = np.stack([_window_f64(configs[i]) for i in idxs])
            wb = jnp.asarray(wins, frames.dtype).reshape(
                (W,) + (1,) * (frames.ndim - 1) + (nperseg,))
            fw = wb * frames[None]
            if nfft > nperseg:  # scipy nfft zero-padding semantics
                fw = jnp.pad(fw, [(0, 0)] * (fw.ndim - 1)
                             + [(0, nfft - nperseg)])
            xr, xi = ct_dft_frames(fw, nfft, fac,
                                   key[7], configs[idxs[0]].n_freqs, prec)
            wtsb = jnp.asarray(wts, frames.dtype).reshape(
                (W,) + (1,) * (frames.ndim - 1) + (wts.shape[-1],))
            psds = (xr * xr + xi * xi) * wtsb
            for j, i in enumerate(idxs):
                results[i] = psds[j]
            continue

        if use_device_dft(configs[idxs[0]]):
            # large nperseg: generate the folded DFT matrices ON DEVICE
            # (same mechanism as power_spectrogram) — embedding them as
            # program constants at e.g. nperseg=4096 would bake ~67 MB
            # PER WINDOW into the jitted program
            mats = [dft_matrices_device(configs[i], frames.dtype)
                    for i in idxs]
            a_re_d = jnp.stack([m[0] for m in mats])
            a_im_d = jnp.stack([m[1] for m in mats])
        else:
            a_re_d = jnp.asarray(np.stack(
                [dft_matrices(configs[i])[0] for i in idxs]), frames.dtype)
            a_im_d = jnp.asarray(np.stack(
                [dft_matrices(configs[i])[1] for i in idxs]), frames.dtype)

        def one(ar, ai, w):
            xr = jnp.matmul(frames, ar, precision=prec)
            xi = jnp.matmul(frames, ai, precision=prec)
            return (xr * xr + xi * xi) * w

        psds = jax.vmap(one)(a_re_d, a_im_d,
                             jnp.asarray(wts, frames.dtype)[:, None, :])
        for j, i in enumerate(idxs):
            results[i] = psds[j]
    return results


def default_grid(n_ffts=(256, 1024, 2048, 4096),
                 windows=("hann", "hamming", ("tukey", 0.25), "blackman"),
                 hop_divisor: int = 4) -> List[SpecConfig]:
    """The 16-combo north-star grid: n_fft x window, hop = n_fft / divisor.

    Spans the full BASELINE.json config-3 range "n_fft in 256..4096" (the
    4096 group runs with device-generated DFT matrices)."""
    out = []
    for n in n_ffts:
        for w in windows:
            out.append(SpecConfig(nperseg=n, hop=n // hop_divisor, window=w,
                                  detrend="none"))
    return out
