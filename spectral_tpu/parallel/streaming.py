"""Chunked streaming STFT with overlap carry.

The reference loads whole recordings into RAM and concatenates sweeps
(PlotEngine.py:193); the long-form workload (BASELINE.json config 4: 1-hour
48 kHz recording) instead streams fixed-size chunks host->HBM with a carry of
trailing samples between chunks, so device memory stays bounded by the chunk
size while frame centers and counts are *identical* to the monolithic
computation (SURVEY.md §5 long-context).

Scheme: with hop h and frame length nperseg, the carry length is
c = (ceil(nperseg/h) - 1) * h  (the smallest multiple of h >= nperseg - h)
and the chunk length m must be a multiple of h. Each step frames
[carry | chunk] at local offsets 0, h, ..., m-h — exactly m/h frames whose
absolute start samples are j*m - c + i*h, i.e. the monolithic hop grid.
Chunk 0's first c/h slots fall before the signal and are masked invalid.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spectral_tpu.config import SpecConfig
from spectral_tpu.core.stft import num_frames, power_spectrogram

Array = jax.Array


def carry_len(cfg: SpecConfig) -> int:
    h = cfg.hop_
    return (math.ceil(cfg.nperseg / h) - 1) * h


def _validate_chunking(cfg: SpecConfig, size: int, what: str) -> None:
    """Shared entry contract of every streaming driver.

    Off-hop-grid sizes would silently produce a frame grid misaligned with
    the monolithic computation (steps would jump by size % hop). Mel
    configs are refused rather than silently ignored: the streamers emit
    the linear-frequency PSD (mel is a display/pipeline projection — fold
    it over the streamed PSD, or use the export pipeline), and a caller
    who set n_mels would otherwise get full linear rows back with no
    warning."""
    h = cfg.hop_
    if size % h != 0:
        raise ValueError(f"{what} must be a multiple of hop={h}")
    if size < cfg.nperseg:
        raise ValueError(f"{what} must be >= nperseg")
    if cfg.n_mels:
        raise ValueError(
            "streaming drivers emit the linear-frequency PSD and ignore "
            "n_mels; project to mel in a fold over the streamed PSD (or "
            "use the export pipeline) instead of a mel config")


class StreamingSTFT:
    """Stateful chunked STFT. Feed equal-sized chunks (multiple of hop);
    receive (frames, valid_mask, first_abs_frame_index) per chunk."""

    def __init__(self, fs: float, cfg: SpecConfig, chunk_size: int,
                 use_matmul: Optional[bool] = None):
        h = cfg.hop_
        _validate_chunking(cfg, chunk_size, "chunk_size")
        self.cfg = cfg
        self.fs = fs
        self.chunk_size = chunk_size
        self.c = carry_len(cfg)
        self.frames_per_chunk = chunk_size // h
        self._chunk_idx = 0
        self._carry = jnp.zeros(self.c, jnp.float32)

        import dataclasses
        if cfg.center:
            raise ValueError(
                "streaming drivers require center=False: the overlap carry "
                "reproduces the uncentered (scipy) frame grid; centered "
                "framing pads the WHOLE signal by nperseg//2, which has no "
                "chunked equivalent — compute it monolithically instead")
        stream_cfg = dataclasses.replace(cfg, center=False, fmin=None,
                                         fmax=None)

        def step(carry: Array, chunk: Array):
            buf = jnp.concatenate([carry, chunk])
            psd = power_spectrogram(buf, fs, stream_cfg,
                                    use_matmul=use_matmul)
            new_carry = buf[chunk.shape[0]:]
            return new_carry, psd

        self._step = jax.jit(step)

    def reset(self) -> None:
        self._chunk_idx = 0
        self._carry = jnp.zeros(self.c, jnp.float32)

    def process(self, chunk: Array) -> Tuple[Array, np.ndarray, int]:
        """One chunk (exactly chunk_size samples) -> (psd (m/h, F), valid
        mask (m/h,), absolute index of this block's first frame slot)."""
        if chunk.shape[-1] != self.chunk_size:
            raise ValueError(
                f"expected chunk of {self.chunk_size}, got {chunk.shape[-1]}")
        self._carry, psd = self._step(self._carry,
                                      jnp.asarray(chunk, jnp.float32))
        h = self.cfg.hop_
        first_abs = self._chunk_idx * self.frames_per_chunk - self.c // h
        valid = np.arange(self.frames_per_chunk) + first_abs >= 0
        self._chunk_idx += 1
        return psd, valid, first_abs


class BlockStreamingSTFT:
    """Device-efficient streaming: stages B chunks per dispatch.

    B consecutive chunks are contiguous signal, so the per-chunk
    overlap-carry frame grid of B StreamingSTFT.process calls is *exactly*
    the monolithic hop grid of the staged buffer ``[carry | chunk_0 ...
    chunk_{B-1}]``: with carry c = (ceil(nperseg/hop)-1)*hop and block
    length L = B*chunk_size (both multiples of hop), the buffer yields
    (c + L - nperseg)//hop + 1 == L/hop complete frames at local offsets
    0, hop, 2*hop, ... — the same slots the chunk loop produces one chunk
    at a time. One dispatch therefore runs ONE large matmul (or batched
    rFFT) over L/hop frames instead of B host round-trips, which is what
    makes long-form audio (BASELINE config 4: 1 h @ 48 kHz, the workload
    scipy serves at PlotEngine.py:113 over concatenated sweeps :193)
    fast on the device while its memory stays bounded by the block size.
    """

    def __init__(self, fs: float, cfg: SpecConfig, chunk_size: int,
                 chunks_per_block: int = 32,
                 use_matmul: Optional[bool] = None):
        h = cfg.hop_
        _validate_chunking(cfg, chunk_size, "chunk_size")
        if chunks_per_block < 1:
            raise ValueError("chunks_per_block must be >= 1")
        self.cfg = cfg
        self.fs = fs
        self.chunk_size = chunk_size
        self.chunks_per_block = chunks_per_block
        self.block_size = chunk_size * chunks_per_block
        self.c = carry_len(cfg)
        self.frames_per_block = self.block_size // h
        self._block_idx = 0
        self._carry = jnp.zeros(self.c, jnp.float32)

        import dataclasses
        if cfg.center:
            raise ValueError(
                "streaming drivers require center=False: the overlap carry "
                "reproduces the uncentered (scipy) frame grid; centered "
                "framing pads the WHOLE signal by nperseg//2, which has no "
                "chunked equivalent — compute it monolithically instead")
        stream_cfg = dataclasses.replace(cfg, center=False, fmin=None,
                                         fmax=None)
        c = self.c

        def step(carry: Array, block: Array):
            buf = jnp.concatenate([carry, block])
            psd = power_spectrogram(buf, fs, stream_cfg,
                                    use_matmul=use_matmul)
            new_carry = jax.lax.slice_in_dim(buf, buf.shape[0] - c,
                                             buf.shape[0], axis=0)
            return new_carry, psd

        self._step = jax.jit(step)

    def reset(self) -> None:
        self._block_idx = 0
        self._carry = jnp.zeros(self.c, jnp.float32)

    def process_block(self, block) -> Tuple[Array, np.ndarray, int]:
        """One block (chunks_per_block * chunk_size samples) ->
        (psd (L/hop, F) device array, valid mask, first absolute frame)."""
        if block.shape[-1] != self.block_size:
            raise ValueError(
                f"expected block of {self.block_size}, got {block.shape[-1]}")
        self._carry, psd = self._step(self._carry,
                                      jnp.asarray(block, jnp.float32))
        h = self.cfg.hop_
        first_abs = self._block_idx * self.frames_per_block - self.c // h
        valid = np.arange(self.frames_per_block) + first_abs >= 0
        self._block_idx += 1
        return psd, valid, first_abs


def stream_spectrogram(x, fs: float, cfg: SpecConfig, chunk_size: int,
                       use_matmul: Optional[bool] = None,
                       chunks_per_block: Optional[int] = None) -> Array:
    """Host driver: stream a full signal through BlockStreamingSTFT and
    return the frame-major PSD, identical to power_spectrogram(x)
    (property-tested: chunked == monolithic).

    chunks_per_block chunks are staged per device dispatch (default: up to
    64, capped at the actual chunk count); the final partial block is
    zero-padded and the output trimmed to the monolithic frame count
    (scipy drops trailing partial frames)."""
    x = np.asarray(x, np.float32)
    n = x.shape[-1]
    total_frames = num_frames(n, cfg.nperseg, cfg.hop_)
    n_chunks = max(1, math.ceil(n / chunk_size))
    if chunks_per_block is None:
        chunks_per_block = min(n_chunks, 64)
    s = BlockStreamingSTFT(fs, cfg, chunk_size, chunks_per_block,
                           use_matmul=use_matmul)
    blocks = []
    n_blocks = max(1, math.ceil(n / s.block_size))
    for j in range(n_blocks):
        block = x[j * s.block_size:(j + 1) * s.block_size]
        if block.shape[0] < s.block_size:
            block = np.pad(block, (0, s.block_size - block.shape[0]))
        psd, valid, first_abs = s.process_block(block)
        blocks.append(np.asarray(psd)[valid])
    out = np.concatenate(blocks, axis=0)[:total_frames]
    return jnp.asarray(out)


class ScanStreamer:
    """Device-resident streaming program for a fixed signal length: ONE
    dispatch, `lax.scan` over staged chunk blocks with the overlap carry
    threaded as scan state. fold(acc, psd_block, valid_mask) -> (acc, y);
    the jitted program is built once in __init__, so repeated calls on
    same-length signals reuse the compiled executable.

    batch > 0 streams a FLEET of equal-length recordings together: the scan
    still walks chunk blocks, but each step computes the block for every
    recording at once (psd_block (batch, frames_per_block, F)). Shard the
    batch dim over a mesh ('data' axis) and each device streams its
    recordings — long-form data parallelism (exercised by
    __graft_entry__.dryrun_multichip). With the default unroll=None, a
    fleet whose batch dim arrives PARTITIONED over a mesh is detected at
    call time and routed through the batched form automatically — the
    small-fleet unroll (below) slices per-recording xs, which would force
    GSPMD to gather each recording onto every chip. Passing unroll=True
    explicitly overrides that protection (single-chip / replicated inputs
    only); unroll=False always keeps the batched form. The form actually
    used by the last call is recorded in ``self.last_layout``."""

    def __init__(self, fs: float, cfg: SpecConfig, block_size: int, n: int,
                 use_matmul: Optional[bool], fold, init, batch: int = 0,
                 unroll: Optional[bool] = None):
        import dataclasses
        h = cfg.hop_
        _validate_chunking(cfg, block_size, "block_size")
        c = carry_len(cfg)
        self.total_frames = num_frames(n, cfg.nperseg, h)
        self.skip = c // h
        self.n = n
        self.batch = batch
        self.n_blocks = max(1, math.ceil(n / block_size))
        self.block_size = block_size
        self.padded_len = self.n_blocks * block_size
        self._init = init
        fpb = block_size // h
        total_frames = self.total_frames
        n_blocks = self.n_blocks
        if cfg.center:
            raise ValueError(
                "streaming drivers require center=False: the overlap carry "
                "reproduces the uncentered (scipy) frame grid; centered "
                "framing pads the WHOLE signal by nperseg//2, which has no "
                "chunked equivalent — compute it monolithically instead")
        stream_cfg = dataclasses.replace(cfg, center=False, fmin=None,
                                         fmax=None)
        lead = (batch,) if batch else ()

        # Small fleets (0 < batch < 8) unroll per-recording MONO bodies
        # inside the scan step instead of batched (B, ...) arrays: the
        # scan xs are then per-recording (nb, L) arrays, and the fold
        # still sees the stacked (B, fpb, F) psd, so the fold contract is
        # unchanged. The bound 8 was tuned for the previous accelerator's
        # (8, 128) memory tiling and is not measured on the H100. At
        # batch >= 8 the batched form is kept (no B-fold program
        # duplication). unroll=None applies this single-device heuristic;
        # a fleet whose batch dim arrives PARTITIONED over a mesh is
        # rerouted to the batched form at call time (__call__ checks
        # x.sharding) so each device keeps streaming only its own
        # recordings.
        if unroll is None:
            unroll_fleet = 0 < batch < 8
        else:
            unroll_fleet = bool(unroll) and batch > 0

        def make_run(unrolled: bool):
            def step(carry_acc, jb):
                carry, acc = carry_acc
                if unrolled:
                    j, chans = jb[0], jb[1:]
                    psds, new_carry = [], []
                    for b in range(batch):
                        buf = jnp.concatenate([carry[b], chans[b]], axis=-1)
                        psds.append(power_spectrogram(
                            buf, fs, stream_cfg, use_matmul=use_matmul))
                        new_carry.append(jax.lax.slice_in_dim(
                            buf, buf.shape[-1] - c, buf.shape[-1], axis=0))
                    psd = jnp.stack(psds)
                    new_carry = tuple(new_carry)
                else:
                    j, block = jb
                    buf = jnp.concatenate([carry, block], axis=-1)
                    psd = power_spectrogram(buf, fs, stream_cfg,
                                            use_matmul=use_matmul)
                    new_carry = jax.lax.slice_in_dim(buf, buf.shape[-1] - c,
                                                     buf.shape[-1],
                                                     axis=buf.ndim - 1)
                abs_idx = j * fpb - c // h + jnp.arange(fpb)
                valid = (abs_idx >= 0) & (abs_idx < total_frames)
                acc, y = fold(acc, psd, valid)
                return (new_carry, acc), y

            def run(blocks, init):
                # blocks arrive pre-shaped lead + (nb, L) from __call__
                # (host inputs upload in this form directly). They become
                # scan xs (per-recording (nb, L) arrays for small fleets; a
                # transpose copy for batch >= 8). lax.dynamic_slice
                # windows in the scan body and a channels-last (n, B)
                # layout were both slower on the previous accelerator;
                # neither is measured on the H100.
                if unrolled:
                    xs = (jnp.arange(n_blocks),) + tuple(
                        blocks[b] for b in range(batch))
                    carry0 = (jnp.zeros(c, jnp.float32),) * batch
                else:
                    if batch:
                        blocks = jnp.moveaxis(blocks, 0, 1)   # (nb, B, L)
                    xs = (jnp.arange(n_blocks), blocks)
                    carry0 = jnp.zeros(lead + (c,), jnp.float32)
                (_, acc), ys = jax.lax.scan(step, (carry0, init), xs)
                return acc, ys

            return run

        self._unroll_fleet = unroll_fleet
        self._run = jax.jit(make_run(unroll_fleet))
        # unroll=None picked the unrolled layout heuristically; keep a
        # batched fallback for call-time rerouting of mesh-partitioned
        # fleets (compiled lazily — costs nothing unless used). An
        # EXPLICIT unroll=True is the caller's override and is respected.
        self._run_batched = (jax.jit(make_run(False))
                             if unroll is None and unroll_fleet else None)
        self.last_layout: Optional[str] = None

    def __call__(self, x):
        """x: (n,) — or (batch, n) when batch > 0 — host numpy or device
        array -> (final_acc, stacked_ys)."""
        pad = self.padded_len - x.shape[-1]
        pad_spec = [(0, 0)] * (1 if self.batch else 0) + [(0, pad)]
        shape = ((self.batch,) if self.batch else ()) + (
            self.n_blocks, self.block_size)
        if isinstance(x, np.ndarray):
            # pad + reshape on HOST: the upload lands as lead + (nb, L)
            # directly, with no device-side pad or relayout copy
            xp = jnp.asarray(
                np.pad(np.asarray(x, np.float32), pad_spec).reshape(shape))
        else:
            xp = jnp.asarray(x, jnp.float32)
            if pad:
                xp = jnp.pad(xp, pad_spec)
            xp = xp.reshape(shape)
        run = self._run
        self.last_layout = ("unrolled" if self._unroll_fleet
                            else "batched" if self.batch else "single")
        if self._run_batched is not None and not isinstance(x, np.ndarray):
            # the default-heuristic unroll is single-device only: a fleet
            # whose batch dim is partitioned over a mesh would be gathered
            # onto every device by the per-recording xs slicing — reroute
            # it through the batched layout (one recording per device)
            sh = getattr(x, "sharding", None)
            try:
                partitioned = (sh is not None
                               and sh.shard_shape(x.shape)[0] != x.shape[0])
            except (TypeError, ValueError):  # odd/uneven sharding: be safe
                partitioned = sh is not None and not sh.is_fully_replicated
            if partitioned:
                run = self._run_batched
                self.last_layout = "batched"
        return run(xp, self._init)


def scan_spectrogram(x, fs: float, cfg: SpecConfig, chunk_size: int,
                     use_matmul: Optional[bool] = None,
                     chunks_per_block: int = 64,
                     mesh=None, seq_axis: str = "data") -> Array:
    """Fully device-resident streaming STFT: ONE dispatch for the whole
    signal, `lax.scan` over staged chunk blocks with the overlap carry
    threaded as scan state. Working set per scan step is one block; the
    stacked PSD lands in device memory and is returned trimmed
    to the monolithic frame grid, identical to power_spectrogram(x).

    With ``mesh`` (and >1 device on ``seq_axis``) the recording is instead
    SHARDED ALONG TIME over the mesh axis and computed by
    :func:`spectral_tpu.parallel.sharding.time_sharded_spectrogram` — each
    device holds a contiguous span of samples, fetches the nperseg-hop halo
    from its right neighbour with one ``lax.ppermute``, and computes only
    its own frames. The sample axis is zero-padded on the host up to a
    multiple of D*hop (so every frame start lands in exactly one shard) and
    placed straight into its time sharding — no device ever holds the
    whole recording; the returned
    PSD is sliced back to the monolithic frame grid (the slice gathers
    only at the consumer boundary). Falls back to the single-device scan
    when the sharded form cannot apply: centered framing (the scipy
    contract's center=False is required — centered padding does not
    decompose across shards), complex mode, or a recording so short the
    halo would span a whole shard."""
    _validate_chunking(cfg, chunk_size, "chunk_size")
    if mesh is not None:
        D = int(mesh.shape.get(seq_axis, 1))
        L0 = int(x.shape[-1])
        hop, nperseg = cfg.hop_, cfg.nperseg
        quantum = D * hop
        Lp = -(-L0 // quantum) * quantum              # ceil to D*hop
        if (D > 1 and not cfg.center and cfg.mode != "complex"
                and nperseg - hop <= Lp // D and L0 >= nperseg):
            from jax.sharding import NamedSharding, PartitionSpec
            from spectral_tpu.core.stft import num_frames
            from spectral_tpu.parallel.sharding import (
                time_sharded_spectrogram)
            lead = (None,) * (x.ndim - 1)
            sh = NamedSharding(mesh, PartitionSpec(*lead, seq_axis))
            xh = np.asarray(x, np.float32)
            if Lp != L0:
                xh = np.pad(xh, [(0, 0)] * (xh.ndim - 1) + [(0, Lp - L0)])
            xp = jax.device_put(xh, sh)
            psd = time_sharded_spectrogram(mesh, fs, cfg, seq_axis=seq_axis,
                                           use_matmul=use_matmul
                                           if use_matmul is not None
                                           else True)(xp)
            # frames windowing into the zero pad are dropped exactly by
            # slicing to the ORIGINAL length's frame count (frame i is
            # real iff i*hop + nperseg <= L0)
            return psd[..., :num_frames(L0, nperseg, hop), :]
    block = chunk_size * max(1, chunks_per_block)
    n_blocks = max(1, math.ceil(x.shape[-1] / block))
    if n_blocks == 1:
        block = chunk_size * max(1, min(
            chunks_per_block, math.ceil(x.shape[-1] / chunk_size)))
    s = ScanStreamer(fs, cfg, block, x.shape[-1], use_matmul,
                     lambda acc, psd, valid: (acc, psd), jnp.zeros(()))
    _, ys = s(x)
    flat = ys.reshape(-1, ys.shape[-1])
    return jax.lax.slice_in_dim(flat, s.skip, s.skip + s.total_frames, axis=0)


def stream_fold(x, fs: float, cfg: SpecConfig, chunk_size: int, fold, init,
                use_matmul: Optional[bool] = None,
                chunks_per_block: int = 64):
    """Device-resident streaming *reduction*: ONE dispatch, bounded HBM —
    the PSD is folded block-by-block into `acc` and never materialized.

    fold(acc, psd_block (frames_per_block, F), valid (frames_per_block,)
    bool) -> acc. Invalid slots (the zero-carry warmup frames of block 0 and
    trailing zero-pad frames) must be masked by the fold using `valid`.
    Long-form analytics (global max for shared normalization, band powers,
    feature statistics — the quantities PlotEngine.py:686-719 computes from
    the full in-RAM Sxx) run this way over arbitrarily long recordings."""
    _validate_chunking(cfg, chunk_size, "chunk_size")
    block = chunk_size * max(1, chunks_per_block)
    s = ScanStreamer(fs, cfg, block, x.shape[-1], use_matmul,
                     lambda acc, psd, valid: (fold(acc, psd, valid),
                                              jnp.zeros(())), init)
    return s(x)[0]


def stream_band_powers(x, fs: float, cfg: SpecConfig, chunk_size: int,
                       bands=None, use_matmul: Optional[bool] = None,
                       chunks_per_block: int = 64):
    """Long-form EEG band powers: ONE device dispatch over the whole
    recording, PSD folded into per-band sums on the fly.

    Reproduces the reference's semantics exactly (PlotEngine.py:692-719 via
    core/events.band_powers): Sxx clamped >= 0, band mask f >= low AND
    f < high (upper edge exclusive), relative power = band/total, all-zero
    result when total < 1e-18 — including the fmin/fmax row pre-mask the
    reference applies before any analysis (PlotEngine.py:114-115). The
    reference computes this from the full in-RAM Sxx; here hour-scale
    recordings never materialize one.

    Returns (dict name -> relative power, total_power).
    """
    from spectral_tpu.core.events import EEG_BANDS
    from spectral_tpu.core.stft import freq_axis
    if bands is None:
        bands = EEG_BANDS
    f = freq_axis(cfg, fs)
    lo = cfg.fmin if cfg.fmin is not None else -np.inf
    hi = cfg.fmax if cfg.fmax is not None else np.inf
    row = (f >= lo) & (f <= hi)                      # pre-mask rows
    masks = np.stack([(row & (f >= b_lo) & (f < b_hi)).astype(np.float32)
                      for b_lo, b_hi in bands.values()])        # (B, F)
    total_mask = row.astype(np.float32)

    masks_j = jnp.asarray(masks)
    total_j = jnp.asarray(total_mask)

    def fold(acc, psd, valid):
        band_acc, tot = acc
        p = jnp.maximum(psd, 0.0) * valid[:, None].astype(psd.dtype)
        # HIGHEST: a default-precision f32 dot may run in reduced
        # precision (TF32 on the GPU) inside the band reductions
        # (core/events.py has the same guard)
        hp = jax.lax.Precision.HIGHEST
        return (band_acc + jnp.sum(jnp.matmul(p, masks_j.T, precision=hp),
                                   axis=0),
                tot + jnp.sum(jnp.matmul(p, total_j, precision=hp)))

    band_sums, total = stream_fold(
        x, fs, cfg, chunk_size, fold,
        (jnp.zeros(len(bands)), jnp.zeros(())),
        use_matmul=use_matmul, chunks_per_block=chunks_per_block)
    band_sums = np.asarray(band_sums)
    total = float(total)
    if total < 1e-18:
        return {name: 0.0 for name in bands}, total
    return ({name: float(np.clip(band_sums[i] / total, 0.0, None))
             for i, name in enumerate(bands)}, total)


def iter_stream(chunks: Iterator[np.ndarray], fs: float, cfg: SpecConfig,
                chunk_size: int, use_matmul: Optional[bool] = None
                ) -> Iterator[Tuple[np.ndarray, int]]:
    """Generator form for true streaming sources: yields (psd_block,
    first_abs_frame_index) with invalid slots already dropped — both the
    leading carry region and, for a short final chunk, trailing frames that
    would extend past the real samples (zero-padding is an implementation
    detail, not signal)."""
    s = StreamingSTFT(fs, cfg, chunk_size, use_matmul=use_matmul)
    h = cfg.hop_
    n_seen = 0
    ended = False
    for chunk in chunks:
        if ended:
            # a short chunk's zero padding entered the carry; splicing more
            # real samples after it would shift every subsequent frame's
            # content against its reported absolute index with no way for
            # the validity gate to notice — refuse instead of corrupting
            raise ValueError(
                "iter_stream received a chunk after a short (final) chunk; "
                "short reads are only valid as the last chunk of a stream")
        chunk = np.asarray(chunk, np.float32)
        n_seen += chunk.shape[0]
        if chunk.shape[0] < chunk_size:
            ended = True
            chunk = np.pad(chunk, (0, chunk_size - chunk.shape[0]))
        psd, valid, first_abs = s.process(chunk)
        abs_idx = first_abs + np.arange(s.frames_per_chunk)
        valid = valid & (abs_idx * h + cfg.nperseg <= n_seen)
        yield np.asarray(psd)[valid], max(first_abs, 0)


def stream_features(x, fs: float, cfg: SpecConfig, chunk_size: int,
                    use_matmul: Optional[bool] = None,
                    chunks_per_block: int = 64):
    """Per-frame HMM detection features for an arbitrarily long recording:
    ONE device dispatch, bounded HBM. The PSD is folded block-by-block to
    per-frame band power over the session's detection band (cfg.fmin..fmax
    defaulting to the full axis — api/session._features semantics,
    PlotEngine.py:238-242) and never materialized; an hour of 48 kHz audio
    yields a ~1.4 GB PSD but only a ~2.7 MB power track.

    Returns (t (T,) host frame times, feats (T, 2) on device) — identical
    to core/events.features_from_psd of the monolithic PSD up to float
    reassociation (pinned in tests/test_parallel.py)."""
    from spectral_tpu.core.events import features_from_band_power
    from spectral_tpu.core.stft import freq_axis, time_axis
    _validate_chunking(cfg, chunk_size, "chunk_size")
    f = freq_axis(cfg, fs)
    fmin = cfg.fmin if cfg.fmin is not None else 0.0
    fmax = cfg.fmax if cfg.fmax is not None else float(f[-1])
    w = jnp.asarray(((f >= fmin) & (f <= fmax)).astype(np.float32))
    hp = jax.lax.Precision.HIGHEST

    def fold(acc, psd, valid):
        # HIGHEST for the same reason as events._features_core: a
        # default-precision dot may round the PSD (TF32 on the GPU)
        return acc, jnp.einsum("tf,f->t", psd.astype(jnp.float32), w,
                               precision=hp)

    block = chunk_size * max(1, chunks_per_block)
    n_blocks = max(1, math.ceil(x.shape[-1] / block))
    if n_blocks == 1:
        block = chunk_size * max(1, min(
            chunks_per_block, math.ceil(x.shape[-1] / chunk_size)))
    s = ScanStreamer(fs, cfg, block, x.shape[-1], use_matmul, fold,
                     jnp.zeros(()))
    _, ys = s(x)
    power = jax.lax.slice_in_dim(ys.reshape(-1), s.skip,
                                 s.skip + s.total_frames, axis=0)
    return time_axis(cfg, fs, x.shape[-1]), features_from_band_power(power)


def stream_detect(x, fs: float, cfg: SpecConfig, chunk_size: int,
                  detector=None, use_matmul: Optional[bool] = None,
                  chunks_per_block: int = 64):
    """Hour-scale unsupervised burst detection in bounded memory: streaming
    feature extraction (:func:`stream_features`) into a BurstDetector,
    whose engine='auto' routes long feature sequences to the
    parallel-prefix HMM (models/hmm_pscan.py — the sequential f32 E-step
    is wrong from ~2k frames). The reference's equivalent needs the whole
    Sxx in RAM (PlotEngine.py:411-473 after :113's full STFT); here
    neither the PSD nor the display image ever exists.

    Returns merged (start, end) events (same scan + merge semantics as the
    plot-based flow; identical results on the same recording are pinned in
    tests/test_parallel.py)."""
    from spectral_tpu.models.detector import BurstDetector
    t, feats = stream_features(x, fs, cfg, chunk_size,
                               use_matmul=use_matmul,
                               chunks_per_block=chunks_per_block)
    det = detector if detector is not None else BurstDetector()
    return det.unsupervised_detect(t, np.asarray(feats))
