"""On-device colormap application.

Replaces the reference's matplotlib rasterization hot loop
(``pcolormesh(..., cmap='jet')`` at PlotEngine.py:134, measured ~360 ms per
513x178 image on CPU) with a LUT gather that XLA fuses with the normalization
arithmetic: normalized [0,1] image -> uint8 RGB(A) array on device, DMA'd to
host only for PNG encoding.

Index mapping matches matplotlib's Colormap.__call__: idx = clip(floor(x * N),
0, N-1), so pixels equal the reference's rendering of the same data.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.render.lut import get_lut

Array = jax.Array


def apply_colormap(img: Array, lut: Optional[np.ndarray] = None,
                   name: str = "jet", flip_rows: bool = False) -> Array:
    """Map a normalized image (..., H, W) in [0, 1] to uint8 RGB (..., H, W, 3).

    flip_rows=True flips the frequency axis so row 0 is the highest frequency
    (image convention: origin at top-left; the reference's pcolormesh puts low
    frequencies at the bottom).
    """
    if lut is None:
        lut = get_lut(name)
    n = lut.shape[0]
    lut_dev = jnp.asarray(lut)
    idx = jnp.clip((img * n).astype(jnp.int32), 0, n - 1)
    rgb = lut_dev[idx]
    if flip_rows:
        rgb = jnp.flip(rgb, axis=-3)
    return rgb


import functools

from spectral_tpu.render.lut import _SEGMENTS, _channel_lut


@functools.lru_cache(maxsize=16)
def _hinge_coeffs(name: str, N: int = 256):
    """Hinge decomposition of a colormap channel as a function of the LUT
    index: z(i) = z0 + sum_j dslope_j * relu(i - t_j), byte = floor(z + eps).

    A 256-entry LUT gather was ~6x the entire STFT on the previous
    accelerator (not measured on the H100; ROADMAP races the two) — but
    each channel of these colormaps is piecewise linear in the index, so it
    evaluates in a handful of fused elementwise ops. Byte-exactness against the LUT is VERIFIED here for all N indices
    using a float32 simulation of the device arithmetic; if any entry
    disagrees (jump discontinuities, pathological margins), returns None and
    the caller falls back to the gather.
    """
    seg = _SEGMENTS[name]
    eps = np.float32(1.0 / 512.0)
    out = []
    for ch in ("red", "green", "blue"):
        data = np.array(seg[ch], dtype=np.float64)
        x = data[:, 0] * (N - 1)
        y0, y1 = data[:, 1], data[:, 2]
        if not np.allclose(y0[1:-1], y1[1:-1]):
            return None  # discontinuous channel: gather only
        with np.errstate(divide="ignore", invalid="ignore"):
            slopes = 255.0 * (y0[1:] - y1[:-1]) / (x[1:] - x[:-1])
        z0 = np.float32(255.0 * y1[0])
        prev = 0.0
        hinges = []  # (dslope, t)
        for j, s in enumerate(slopes):
            hinges.append((np.float32(s - prev), np.float32(x[j])))
            prev = s
        # f32 simulation of the device computation over every index
        i32 = np.arange(N, dtype=np.float32)
        z = np.full(N, z0, dtype=np.float32)
        for ds, t in hinges:
            z = (z + ds * np.maximum(i32 - t, np.float32(0))).astype(np.float32)
        sim = np.floor(np.clip(z + eps, 0.0, 255.0)).astype(np.int64)
        target = _np_floor_lut(seg[ch], N)
        # matplotlib's internal linspace noise shifts a few entries by ±1;
        # bake per-index corrections (a handful of fused selects on device)
        diff = target - sim
        if np.abs(diff).max() > 1:
            return None
        corrections = tuple((int(i), int(diff[i]))
                            for i in np.nonzero(diff)[0])
        if len(corrections) > 96:
            return None  # cheaper to gather at that point
        # re-verify with corrections applied
        sim2 = sim.copy()
        for i, d in corrections:
            sim2[i] += d
        if not np.array_equal(sim2, target):
            return None
        out.append((z0, tuple(hinges), corrections))
    return tuple(out), eps


def _np_floor_lut(channel_data, N: int) -> np.ndarray:
    return (np.asarray(_channel_lut(channel_data, N)) * 255).astype(np.int64)


def apply_colormap_packed(img: Array, name: str = "jet",
                          flip_rows: bool = False,
                          opaque: bool = True,
                          method: str = "auto") -> Array:
    """Colormap to packed little-endian RGBA words: (..., H, W) -> uint32.

    Some device->host paths move sub-word dtypes far slower than 32-bit
    words (the previous accelerator's link did; not measured on the H100).
    Packing R|G<<8|B<<16|A<<24 on device keeps the transfer on the word
    path; :func:`unpack_rgba` restores (H, W, 4) uint8 on host as a
    zero-copy view.

    method: 'arith' evaluates the piecewise-linear channels directly as
    elementwise ops (byte-exact, verified at trace time), 'gather' uses the
    LUT, 'auto' picks arith when verified.
    """
    n = 256
    if method not in ("auto", "arith", "gather"):
        # a typo'd method used to fall through to the gather path silently
        raise ValueError(f"unknown colormap method: {method!r} "
                         "(expected 'auto', 'arith' or 'gather')")
    idx = jnp.clip((img * n).astype(jnp.int32), 0, n - 1)

    coeffs = _hinge_coeffs(name, n) if method in ("auto", "arith") else None
    if method == "arith" and coeffs is None:
        raise ValueError(f"colormap {name!r} not expressible arithmetically")

    if coeffs is not None:
        (chans, eps) = coeffs
        fi = idx.astype(jnp.float32)
        bytes_ = []
        for z0, hinges, corrections in chans:
            z = jnp.full_like(fi, z0)
            for ds, t in hinges:
                z = z + ds * jnp.maximum(fi - t, 0.0)
            b8 = jnp.floor(jnp.clip(z + eps, 0.0, 255.0)).astype(jnp.int32)
            for i, d in corrections:
                b8 = b8 + jnp.where(idx == i, d, 0)
            bytes_.append(b8.astype(jnp.uint32))
        r, g, b = bytes_
        a = jnp.uint32(255 << 24) if opaque else jnp.uint32(0)
        out = r | (g << 8) | (b << 16) | a
    else:
        lut8 = get_lut(name).astype(np.uint32)
        a = np.uint32(255 << 24) if opaque else np.uint32(0)
        packed_lut = (lut8[:, 0] | (lut8[:, 1] << 8) | (lut8[:, 2] << 16) | a)
        out = jnp.asarray(packed_lut)[idx]

    if flip_rows:
        out = jnp.flip(out, axis=-2)
    return out


def unpack_rgba(packed: np.ndarray) -> np.ndarray:
    """uint32 (..., H, W) -> uint8 (..., H, W, 4) (little-endian view)."""
    arr = np.ascontiguousarray(np.asarray(packed, dtype="<u4"))
    return arr.view(np.uint8).reshape(arr.shape + (4,))


def colormap_index_packed(img: Array, flip_rows: bool = False) -> Array:
    """Quantize to 256-level colormap indices and pack FOUR indices per
    little-endian uint32 word: (..., H, W) -> uint32 (..., H, ceil(W/4)).

    Pairs with indexed-color (PLTE) PNG export: one byte per pixel crosses
    the host boundary instead of four, and the encoder deflates
    a third of the RGB byte count — at byte-identical colors, since the
    palette IS the LUT that apply_colormap_packed's arithmetic reproduces
    (verified byte-exact in tests). Packing into 32-bit words keeps the
    transfer off the pathological sub-word path (see apply_colormap_packed);
    :func:`unpack_indices` restores (..., H, W) uint8 on host."""
    n = 256
    idx = jnp.clip((img * n).astype(jnp.int32), 0, n - 1).astype(jnp.uint32)
    if flip_rows:
        idx = jnp.flip(idx, axis=-2)
    w = idx.shape[-1]
    pad = (-w) % 4
    if pad:
        idx = jnp.pad(idx, [(0, 0)] * (idx.ndim - 1) + [(0, pad)])
    q = idx.reshape(idx.shape[:-1] + ((w + pad) // 4, 4))
    return (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
            | (q[..., 3] << 24))


def unpack_indices(packed: np.ndarray, width: int) -> np.ndarray:
    """uint32 (..., H, ceil(W/4)) -> uint8 (..., H, W) index image."""
    arr = np.ascontiguousarray(np.asarray(packed, dtype="<u4"))
    flat = arr.view(np.uint8).reshape(arr.shape[:-1] + (arr.shape[-1] * 4,))
    return flat[..., :width]


def apply_colormap_rgba(img: Array, alpha: Optional[Array] = None,
                        name: str = "jet", flip_rows: bool = False) -> Array:
    """Same as apply_colormap but with an alpha channel (default opaque).

    Passing an alpha mask reproduces the reference's transparent-PNG export
    (ExportManager.py:108: savefig(transparent=True) makes the figure
    background transparent; the data area stays opaque)."""
    rgb = apply_colormap(img, name=name, flip_rows=flip_rows)
    if alpha is None:
        a = jnp.full(rgb.shape[:-1] + (1,), 255, jnp.uint8)
    else:
        a = jnp.clip(alpha * 255.0, 0, 255).astype(jnp.uint8)
        if a.ndim == rgb.ndim - 1:   # an (..., H, W) mask like img: add the
            a = a[..., None]         # channel axis BEFORE the row flip (a
        if flip_rows:                # 2-D mask has no axis -3 to flip yet)
            a = jnp.flip(a, axis=-3)
    return jnp.concatenate([rgb, a], axis=-1)
