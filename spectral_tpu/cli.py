"""Command-line interface.

The reference has no CLI (entry point: ``python GUI.py``, GUI.py:588-598);
headless operation is a new capability. Subcommands mirror the app's actions:

  render      file(s) -> spectrogram PNG
  detect      file -> burst events (unsupervised), optional CSV
  learn       file + ROI list -> refined detection, optional CSV
  bands       file -> EEG band powers
  grid        parameter-sweep grid -> one .npz of PSDs per combo
  stream      long recording -> streamed PSD / dB image / band powers
  export-specs  WAV dataset -> spectrogram PNGs (overlapped pipeline)
  export-batch  files -> per-sweep waveform PNGs
  serve       long-lived JSONL worker (warm compiled programs + sessions)
  info        file -> registered sweeps
  bench       quick throughput probe on the current backend
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np


def _make_config(args) -> "SpecConfig":
    from spectral_tpu.config import SpecConfig
    precision = "fast" if getattr(args, "fast", False) else "accurate"
    if args.scipy_compat:
        if getattr(args, "window", None):
            # silently rendering Tukey while the user asked for hann would
            # be worse than refusing
            sys.exit("error: --scipy-compat fixes the window to "
                     "tukey(0.25) (the reference's scipy default); "
                     "drop --window or drop --scipy-compat")
        cfg = SpecConfig.scipy_default(
            nperseg=args.nperseg, fmin=args.fmin, fmax=args.fmax,
            log_scale=args.log, precision=precision)
        if getattr(args, "mels", 0):
            # --mels composes with the scipy framing (every subcommand,
            # not just export-specs)
            import dataclasses
            cfg = dataclasses.replace(cfg, n_mels=args.mels)
        return _with_nfft(cfg, args)
    return _with_nfft(SpecConfig.north_star(
        n_fft=args.nperseg, hop=args.hop or args.nperseg // 4,
        window=args.window or "hann", fmin=args.fmin, fmax=args.fmax,
        log_scale=args.log, precision=precision,
        n_mels=args.mels if getattr(args, "mels", 0) else None), args)


def _with_nfft(cfg, args):
    """Apply --nfft (zero-padded transform length, scipy's nfft arg)."""
    nfft = getattr(args, "nfft", None)
    if not nfft:
        return cfg
    import dataclasses
    try:
        return dataclasses.replace(cfg, nfft=nfft)
    except ValueError as e:   # nfft < nperseg
        sys.exit(f"error: {e}")


def _session_for(paths: List[str], args):
    from spectral_tpu.api.session import AnalysisSession
    from spectral_tpu.config import ViewSettings
    # warm_detection=False: these are one-shot commands. The background
    # warmup thread only pays off when there is user think-time between
    # plot and detect; here the process either detects immediately (the
    # main thread compiles the same program itself) or never (render/
    # bands), and exiting while a daemon thread is mid-compile crashes
    # runtime teardown ("FATAL: exception not rethrown").
    s = AnalysisSession(warm_detection=False)
    names = []
    for p in paths:
        try:
            names += s.load(p)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {p}")
        except ValueError as e:
            sys.exit(f"error: {e}")
    if not names:
        sys.exit("no sweeps loaded")
    # Files loaded, heavy device work is next: persist its compiles. Every
    # one-shot CLI process otherwise re-pays every compile on each
    # invocation. Lazy ON PURPOSE — after the cheap-validation fast-fail
    # paths above, never at import time (CLAUDE.md: it initializes the
    # backend); no-op on the CPU backend and under SPECTRAL_TPU_NO_CACHE=1.
    from spectral_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    sel = names if args.combine else names[:1]
    if len(names) > 1 and not args.combine:
        # the non-combine path analyzes the first sweep only (reference
        # PlotEngine.py:203-206); say so instead of silently dropping data
        print(f"note: {len(names)} sweeps loaded; analyzing only "
              f"{sel[0]} (pass --combine to concatenate them)",
              file=sys.stderr)
    s.plot_sweeps(sel, _make_config(args),
                  ViewSettings(combine=args.combine, mode_proc="Spectrogram",
                               mode_raw="Spectrogram"))
    return s, names


def _add_spec_args(p, combine: bool = True):
    p.add_argument("--nperseg", type=int, default=1024)
    p.add_argument("--hop", type=int, default=None,
                   help="frame hop (default nperseg//4; scipy mode ignores)")
    p.add_argument("--nfft", type=int, default=None,
                   help="zero-padded transform length (scipy's nfft; "
                        "default nperseg, must be >= nperseg)")
    p.add_argument("--window", default=None,
                   help="window function (default hann; invalid with "
                        "--scipy-compat, which fixes tukey 0.25)")
    p.add_argument("--scipy-compat", action="store_true",
                   help="reference-exact mode: Tukey(0.25), hop=nperseg-nperseg//8")
    p.add_argument("--fmin", type=float, default=None)
    p.add_argument("--fmax", type=float, default=None)
    p.add_argument("--log", action="store_true", help="dB display scale")
    p.add_argument("--fast", action="store_true",
                   help="bf16 3-pass matmuls: ~5e-2 dB error "
                        "(display-only; default 'accurate' holds 1e-3 dB)")
    if combine:  # meaningless for single-recording / clip-dataset commands
        p.add_argument("--combine", action="store_true",
                       help="concatenate all sweeps (reference combine mode)")


def _detect_each_batched(s, names, base_cfg):
    """Fleet mode: group same-(length, fs) sweeps — the normal shape of a
    multi-sweep ABF/NIX recording — and run each group's EM fit + escape
    patch + Viterbi as ONE vmapped device dispatch (models/batch.py)
    instead of one round trip per sweep. Returns {name: events | error}.
    Shared by `detect --each --batched` and serve's `detect_batch`.

    Same flow per clip as the sequential path (proc-preferred source,
    authoritative entry fs, cfg.fmin/fmax feature band, short-signal
    config shrink); EM under vmap may reassociate f32 reductions, so
    borderline boundaries can differ at float level — which is why this
    is opt-in (--batched) rather than the default."""
    import jax.numpy as jnp
    from spectral_tpu.core import events as ev_mod
    from spectral_tpu.core.stft import (effective_config, freq_axis,
                                        power_spectrogram, time_axis)
    from spectral_tpu.models.batch import batch_unsupervised_detect

    groups, sigs = {}, {}
    out = {}
    for name in names:
        e = s.registry.data[name]
        sig = e.processed if e.processed is not None else e.raw
        if sig is None:
            out[name] = ValueError("no signal data")
            continue
        x = np.asarray(sig, np.float32)
        sigs[name] = x
        groups.setdefault((len(x), e.fs), []).append(name)
    for (n, fs), group in groups.items():
        cfg = effective_config(base_cfg, n)
        f = freq_axis(cfg, fs)
        t = time_axis(cfg, fs, n)
        try:
            if t.size == 0:
                raise ValueError("Not enough data to train the model. "
                                 "Signal may be too short.")
            xb = jnp.asarray(np.stack([sigs[nm] for nm in group]))
            psd = power_spectrogram(xb, fs, cfg)
            fmin = cfg.fmin if cfg.fmin is not None else 0.0
            fmax = cfg.fmax if cfg.fmax is not None else float(f[-1])
            feats = np.asarray(ev_mod.features_from_psd(f, psd, fmin, fmax))
            # per-clip fault isolation: a NaN/Inf feature row (overflowed
            # f32 power, non-finite samples) skips THAT sweep with the
            # sequential path's message instead of failing the group —
            # batch_unsupervised_detect refuses whole batches otherwise
            finite = np.isfinite(feats.reshape(len(group), -1)).all(axis=1)
            bad_err = ValueError(
                "features contain NaN/Inf; if the input waveform is "
                "finite, its power overflows float32 analysis — rescale "
                "the signal (the analysis is scale-invariant)")
            for nm in (nm for nm, ok in zip(group, finite) if not ok):
                out[nm] = bad_err
            group = [nm for nm, ok in zip(group, finite) if ok]
            if not group:
                continue
            results = batch_unsupervised_detect(t, feats[finite])
        except ValueError as e:
            for nm in group:
                out[nm] = e
            continue
        for nm, evs in zip(group, results):
            out[nm] = evs
    return out


def _detect_each(args) -> int:
    """Per-sweep unsupervised detection: a fresh HMM per sweep (the
    reference's persistent model only makes sense within one plot), printed
    as `sweep<TAB>start<TAB>end` lines plus an optional combined CSV in the
    reference's schema (ExportManager.py:43-50 columns; IBI restarts per
    sweep; sweep index parsed as the reference does). --batched runs
    same-length groups as one vmapped device dispatch."""
    from spectral_tpu.api.session import AnalysisSession
    from spectral_tpu.config import ViewSettings
    from spectral_tpu.io.registry import split_display_name
    s = AnalysisSession(warm_detection=False)  # one-shot (see _session_for)
    names = []
    for p in args.files:
        try:
            names += s.load(p)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {p}")
        except ValueError as e:
            sys.exit(f"error: {e}")
    if not names:
        sys.exit("no sweeps loaded")
    batched = (_detect_each_batched(s, names, _make_config(args))
               if args.batched else None)
    rows = []
    for name in names:
        if batched is not None:
            got = batched.get(name)
            if isinstance(got, Exception) or got is None:
                print(f"{name}\tskipped: {got}", file=sys.stderr)
                continue
            events = got
        else:
            s.reset_model()
            try:
                # plot inside the per-sweep guard: a sweep whose PSD
                # overflows f32 (session overflow check) must skip like
                # any other per-sweep failure, not abort the whole fleet
                s.plot_sweeps([name], _make_config(args),
                              ViewSettings(mode_proc="Spectrogram",
                                           mode_raw="Spectrogram"))
                events = s.unsupervised_detect()
            except ValueError as e:       # e.g. sweep too short to train on
                print(f"{name}\tskipped: {e}", file=sys.stderr)
                continue
        base, sweep_idx = split_display_name(name)
        prev_end = None
        for a, b in events:
            print(f"{name}\t{a:.4f}\t{b:.4f}")
            ibi = float("nan") if prev_end is None else a - prev_end
            rows.append((base, sweep_idx if sweep_idx is not None else "",
                         a, b, ibi))
            prev_end = b
    if args.csv:
        if not rows:
            # consistent with the non---each path's export_events_csv:
            # zero events is an error, not a header-only "success"
            print("Error: No burst data to export.")
            return 1
        import csv as _csv
        # utf-8 regardless of locale (Source File carries arbitrary
        # names; surrogateescape round-trips ASCII-locale fsdecode)
        with open(args.csv, "w", newline="", encoding="utf-8",
                  errors="surrogateescape") as fh:
            w = _csv.writer(fh)
            w.writerow(["Burst ID", "Source File", "Sweep",
                        "Start Time (s)", "End Time (s)",
                        "Inter Burst Interval (s)"])
            for i, (base, idx, a, b, ibi) in enumerate(rows, 1):
                w.writerow([i, base, idx, a, b, ibi])
        print(f"Successfully exported {len(rows)} events to {args.csv}")
    return 0


def _serve(stdin, stdout, *, max_sessions: int = 16,
           request_timeout: Optional[float] = None,
           max_request_bytes: int = 1 << 20,
           max_rss_mb: float = 8192.0) -> int:
    """JSONL request/response worker over a stream pair.

    See _make_serve_loop for the protocol; this is the stdin/stdout
    entry (one stream pair, EOF or shutdown ends the worker)."""
    _make_serve_loop(max_sessions=max_sessions,
                     request_timeout=request_timeout,
                     max_request_bytes=max_request_bytes,
                     max_rss_mb=max_rss_mb)(stdin, stdout)
    return 0


def _serve_tcp(host: str, port: int, *, ready=None,
               max_sessions: int = 16,
               request_timeout: Optional[float] = None,
               max_request_bytes: int = 1 << 20,
               max_rss_mb: float = 8192.0,
               idle_timeout: Optional[float] = None) -> int:
    """The same JSONL worker over TCP (no pipe relay needed): clients
    connect, speak the protocol, and disconnect; the warm state —
    compiled programs AND the LRU session cache — persists across
    connections, which is the point of a serving process. Connections
    are served one at a time (the device is a serial resource; requests
    from a second client queue in the TCP backlog). {"cmd": "shutdown"}
    stops the server; a client dropping mid-response does not.

    Binds host (default loopback — the protocol has no auth; front it
    with a real proxy for anything beyond a trusted host). port 0 picks
    an ephemeral port; `ready(actual_port)` is called once listening
    (tests and supervisors use it to learn the port)."""
    import socket
    run = _make_serve_loop(max_sessions=max_sessions,
                           request_timeout=request_timeout,
                           max_request_bytes=max_request_bytes,
                           max_rss_mb=max_rss_mb)
    srv = socket.create_server((host, port))
    actual = srv.getsockname()[1]
    print(f"serving on {host}:{actual}", file=sys.stderr)
    if ready is not None:
        ready(actual)
    try:
        while True:
            conn, _addr = srv.accept()
            outcome = "eof"
            with conn:
                if idle_timeout:
                    # connections are served ONE at a time, so a client
                    # that connects and then stalls mid-line would hold
                    # the server forever; a read/write past the idle
                    # bound raises TimeoutError (an OSError) below and
                    # the connection is dropped — the next client is
                    # served by the same warm worker
                    conn.settimeout(idle_timeout)
                fin = conn.makefile("r", encoding="utf-8", errors="replace")
                fout = conn.makefile("w", encoding="utf-8",
                                     errors="replace")
                try:
                    outcome = run(fin, fout)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    continue          # client vanished/stalled; keep serving
            if outcome == "shutdown":
                return 0
    finally:
        srv.close()


def _make_serve_loop(*, max_sessions: int = 16,
                     request_timeout: Optional[float] = None,
                     max_request_bytes: int = 1 << 20,
                     max_rss_mb: float = 8192.0):
    """Build the JSONL worker loop (the serving shape for deployments:
    one warm process amortizes compile latency and session state across
    requests instead of paying them per CLI invocation).

    Request:  one JSON object per line:
      {"cmd": "render"|"detect"|"learn"|"bands",
       "files": [...], "out": "x.png"?, "rois": [[a,b],...]?,
       "config": {SpecConfig fields}?, "combine": bool?}
      {"cmd": "render_batch", "files": [...], "out_dir": ...,
       "clip_seconds": 10.0?, "config": {...}?} — N clips rendered through
      ONE batched device dispatch per batch (the overlapped export
      pipeline), not N session round-trips.
      {"cmd": "detect_batch", "files": [...], "config": {...}?} — every
      sweep of the files, same-(length, fs) groups each detected in ONE
      vmapped device dispatch (`detect --each --batched` as a warm
      request); response {"results": {name: {events} | {error}}}.
      {"cmd": "stream_bands", "files": [...], "channel": 0?,
       "chunk_seconds": 60?, "config": {...}?} — hour-scale band-power
      analytics through the bounded-memory device fold (stream --bands
      as a warm request; the PSD is never materialized).
      {"cmd": "ping"} -> liveness; {"cmd": "stats"} -> worker health
      (requests/errors/timeouts/cache-trims served, cached sessions,
      RSS); {"cmd": "shutdown"} -> exit 0.
    Response: one JSON object per line: {"ok": true, ...result} or
      {"ok": false, "error": "..."}; errors never kill the worker.

    Robustness guards (each surfaces as an error response, never a crash):
      * sessions are cached per file-set with LRU eviction at
        `max_sessions`, so memory stays flat across many distinct inputs;
      * `request_timeout` bounds each request's wall clock. The stuck
        request runs on a daemon thread (it cannot block interpreter
        exit), and on timeout the WHOLE session cache is replaced — the
        abandoned thread keeps only orphaned state, so it can never race
        the replacement worker on a shared session or the LRU dict;
      * lines over `max_request_bytes` are rejected before parsing;
      * `max_rss_mb` (0 = disabled) bounds process memory: when RSS
        crosses it, every compiled program and cached session is dropped
        (utils/memory.py — JAX caches one executable per program/shape
        forever, so a worker serving ever-new configs/ROI lengths grows
        without a backstop; the persistent compile cache makes the
        post-trim recompiles cheap).
    """
    import collections
    import json as _json
    import threading as _threading
    from spectral_tpu.api.session import AnalysisSession
    from spectral_tpu.config import SpecConfig, ViewSettings
    from spectral_tpu.utils.cache import enable_compilation_cache
    from spectral_tpu.utils.memory import maybe_trim_caches
    enable_compilation_cache()

    # The cache is passed INTO each request handler (not read from the
    # enclosing scope at call time) so that after a timeout the main loop
    # can swap in a fresh dict: the abandoned thread holds a reference to
    # the old, orphaned one and cannot corrupt the live cache.
    sessions: "collections.OrderedDict" = collections.OrderedDict()

    def get_session(files, cache):
        key = tuple(files)
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        # warm_detection=False: the worker is strictly sequential, so a
        # speculative background detection compile at plot time only
        # contends with the request being served; a detect/learn request
        # pays its compile inline (same total cost, no contention)
        s = AnalysisSession(warm_detection=False)
        for p in files:
            s.load(p)
        cache[key] = s
        while len(cache) > max_sessions:      # evict least-recently used
            cache.popitem(last=False)
        return s

    counters = {"requests": 0, "errors": 0, "timeouts": 0, "trims": 0}

    def handle(req, cache):
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "pong": True}
        if cmd == "stats":
            # operational introspection for supervisors/monitoring: the
            # worker's own view of its health, no side effects
            from spectral_tpu.utils.memory import rss_mb
            return {"ok": True, "requests": counters["requests"],
                    "errors": counters["errors"],
                    "timeouts": counters["timeouts"],
                    "cache_trims": counters["trims"],
                    "sessions_cached": len(cache),
                    "rss_mb": round(rss_mb(), 1)}
        if cmd == "render_batch":
            from spectral_tpu.io.wav import wav_info
            from spectral_tpu.parallel.pipeline import (export_spectrograms,
                                                        registry_clip_source,
                                                        registry_first_fs,
                                                        wav_clip_source)
            files = req["files"]
            cfg = SpecConfig(**req.get("config", {}))
            all_wav = all(f.lower().endswith(".wav") for f in files)
            if all_wav:
                fs = wav_info(files[0])[2]   # header-only: no full decode
                source = wav_clip_source(files)
            else:    # ABF/NIX/NPZ datasets, one clip per sweep
                fs = registry_first_fs(files[0])
                source = registry_clip_source(files, fs)
            clip_s = float(req.get("clip_seconds", 10.0))
            stats = export_spectrograms(
                source, fs, cfg, req["out_dir"],
                clip_samples=int(clip_s * fs),
                batch=min(len(files), int(req.get("batch", 64))),
                compress_level=int(req.get("compress_level", 1)))
            return {"ok": True, "written": stats.pngs_written,
                    "seconds_audio": stats.seconds_audio}
        if cmd == "stream_bands":
            # long-recording analytics over serve: the device-resident
            # fold (stream_band_powers) — bounded working memory, no PSD
            # materialization — instead of the session's monolithic plot.
            # Same overflow/underflow refusal contract as `stream --bands`
            from spectral_tpu.io.registry import SweepRegistry
            from spectral_tpu.parallel.streaming import stream_band_powers
            r = SweepRegistry()
            names: list = []
            for p in req["files"]:
                names += r.load_file(p)
            ch = int(req.get("channel", 0))
            if not 0 <= ch < len(names):
                raise ValueError(f"channel {ch} out of range "
                                 f"({len(names)} sweep(s))")
            sig, fs = r.get_signal(names[ch], processed=True)
            cfg = SpecConfig(**req.get("config", {}))
            hop = cfg.hop_
            chunk = max(-(-cfg.nperseg // hop) * hop,
                        int(float(req.get("chunk_seconds", 60.0)) * fs)
                        // hop * hop)
            sig = np.asarray(sig, np.float32)
            bp, total = stream_band_powers(sig, fs, cfg, chunk)
            if ((not np.isfinite(total)
                 or not all(np.isfinite(v) for v in bp.values()))
                    and np.isfinite(sig).all()):
                raise ValueError(
                    "spectral power overflows float32: rescale the "
                    "recording by a power of two (e.g. x * 2**-40)")
            if total == 0.0 and np.isfinite(sig).all():
                adet = float(np.abs(
                    sig - sig.mean(dtype=np.float64)).max())
                if 0.0 < adet < 1e-10:
                    raise ValueError(
                        "spectral power underflows float32: rescale the "
                        "recording by a power of two (e.g. x * 2**80)")
            return {"ok": True, "sweep": names[ch],
                    "bands": {k: float(v) for k, v in bp.items()},
                    "total_power": float(total)}
        if cmd == "detect_batch":
            # fleet detection: every sweep of the cached session's files,
            # same-(length, fs) groups vmapped into ONE device dispatch
            # each (the serve-side twin of `detect --each --batched`);
            # per-sweep failures isolate as {"error": ...} entries
            s = get_session(req["files"], cache)
            cfg = SpecConfig(**req.get("config", {}))
            results = _detect_each_batched(s, s.registry.names(), cfg)
            return {"ok": True, "results": {
                name: ({"error": str(v)} if isinstance(v, Exception)
                       else {"events": v})
                for name, v in results.items()}}
        if cmd in ("render", "detect", "learn", "bands"):
            s = get_session(req["files"], cache)
            cfg = SpecConfig(**req.get("config", {}))
            names = (s.registry.names() if req.get("combine")
                     else s.registry.names()[:1])
            s.plot_sweeps(names, cfg,
                          ViewSettings(combine=bool(req.get("combine")),
                                       mode_proc="Spectrogram",
                                       mode_raw="Spectrogram"))
            # the exporters swallow failures into "Error ..." status
            # strings (reference ExportManager semantics); ok must reflect
            # them — a client checking "ok" must not treat a failed export
            # as success (same rule as the CLI's _status)
            _ok = lambda m: not str(m).startswith("Error")  # noqa: E731
            if cmd == "render":
                msg = s.export_png(req["out"])
                resp = {"ok": _ok(msg), "message": msg}
            elif cmd == "detect":
                resp = {"ok": True, "events": s.unsupervised_detect()}
            elif cmd == "learn":
                rois = [tuple(r) for r in req["rois"]]
                resp = {"ok": True, "events": s.learn_and_detect(rois)}
            else:
                resp = {"ok": True, "bands": s.calculate_band_powers(),
                        "total_power": s.calculate_absolute_power()}
            if req.get("csv"):
                resp["csv"] = s.export_csv(req["csv"])
                if not _ok(resp["csv"]):
                    resp["ok"] = False
            return resp
        return {"ok": False, "error": f"unknown cmd: {cmd!r}"}

    def handle_with_timeout(req, cache):
        """Run handle() on a daemon thread bounded by request_timeout.
        Returns (resp, timed_out). A daemon thread — unlike a
        ThreadPoolExecutor worker — is not joined by the interpreter's
        atexit hook, so a permanently wedged request can't stop the
        process from exiting after shutdown/EOF."""
        box = {}

        def target():
            try:
                box["resp"] = handle(req, cache)
            except Exception as e:
                box["exc"] = e

        th = _threading.Thread(target=target, daemon=True,
                               name="serve-request")
        th.start()
        th.join(request_timeout)
        if th.is_alive():
            return None, True
        if "exc" in box:
            raise box["exc"]
        return box["resp"], False

    def run(stdin, stdout) -> str:
        """Drive one stream pair; returns 'shutdown' or 'eof' so a
        multi-connection server (_serve_tcp) knows whether to keep
        accepting. The warm state (sessions, compiled programs) lives in
        the enclosing scope and survives across calls."""
        nonlocal sessions
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            counters["requests"] += 1
            try:
                nbytes = len(line.encode("utf-8", "surrogatepass"))
                if nbytes > max_request_bytes:  # BYTES, as the name says:
                    # len(str) undercounts non-ASCII payloads by up to 4x
                    raise ValueError(
                        f"request exceeds max_request_bytes "
                        f"({nbytes} > {max_request_bytes})")
                req = _json.loads(line)
                if req.get("cmd") == "shutdown":
                    stdout.write(_json.dumps({"ok": True, "bye": True})
                                 + "\n")
                    stdout.flush()
                    return "shutdown"
                if not request_timeout:      # None or 0 = no timeout
                    resp = handle(req, sessions)
                else:
                    resp, timed_out = handle_with_timeout(req, sessions)
                    if timed_out:
                        # Abandon the stuck daemon thread WITH its state:
                        # it keeps the old cache (and whatever session it
                        # was mutating); the live loop starts fresh.
                        sessions = collections.OrderedDict()
                        counters["timeouts"] += 1
                        resp = {"ok": False,
                                "error": "TimeoutError: request exceeded "
                                         f"{request_timeout}s"}
            except Exception as e:  # a bad request must not kill the worker
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            if not resp.get("ok"):
                counters["errors"] += 1
            stdout.write(_json.dumps(resp) + "\n")
            stdout.flush()
            # memory backstop: drop compiled programs AND cached sessions
            # (their device-resident PSD caches are the other big holder)
            if maybe_trim_caches(max_rss_mb):
                sessions.clear()
                counters["trims"] += 1
        return "eof"

    return run


def build_parser() -> argparse.ArgumentParser:
    """The CLI argument parser (separate from main so tests and the docs
    audit can validate command lines without dispatching them)."""
    ap = argparse.ArgumentParser(
        prog="spectral-tpu",
        description="Accelerated spectrogram / burst-detection toolkit")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU instead of the accelerator")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="spectrogram PNG from a recording")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--cmap", default="jet")
    p.add_argument("--mels", type=int, default=0, help="mel bins (0 = linear)")
    p.add_argument("--decorated", action="store_true",
                   help="full figure with axes/colorbar/labels (matplotlib) "
                        "instead of the raw pixel image")
    p.add_argument("--transparent", action="store_true",
                   help="with --decorated: transparent background, legends "
                        "stripped (the reference's PNG export mode, "
                        "ExportManager.py:92-111)")
    p.add_argument("--dpi", type=int, default=150)
    _add_spec_args(p)

    p = sub.add_parser("detect", help="unsupervised burst detection")
    p.add_argument("files", nargs="+")
    p.add_argument("--csv", default=None, help="write burst table here")
    p.add_argument("--each", action="store_true",
                   help="detect every sweep independently (fresh model per "
                        "sweep; one combined table with sweep attribution)")
    p.add_argument("--batched", action="store_true",
                   help="with --each: fleet mode — same-length sweeps run "
                        "as ONE vmapped device dispatch per group "
                        "(models/batch.py) instead of a round trip per "
                        "sweep; borderline event edges may differ from the "
                        "sequential flow at float level")
    _add_spec_args(p)

    p = sub.add_parser("learn", help="learn-from-examples detection")
    p.add_argument("files", nargs="+")
    p.add_argument("--roi", action="append", required=True,
                   help="start:end seconds (repeatable)")
    p.add_argument("--csv", default=None)
    _add_spec_args(p)

    p = sub.add_parser("bands", help="EEG band powers")
    p.add_argument("files", nargs="+")
    _add_spec_args(p)

    p = sub.add_parser("export-batch", help="per-sweep waveform PNGs")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--proc", action="store_true")
    p.add_argument("--window-seconds", type=float, default=300.0,
                   help="fixed x-window like the reference's 0-300 s "
                        "(ExportManager.py:178); 0 sizes to each signal")

    p = sub.add_parser("grid", help="parameter-sweep grid: PSDs for every "
                                    "n_fft x window combo in ONE batched "
                                    "dispatch per shape group")
    p.add_argument("file")
    p.add_argument("-o", "--out", required=True, help="output .npz")
    p.add_argument("--n-ffts", default="256,1024,2048,4096",
                   help="comma-separated n_fft list (hop = n_fft/4)")
    p.add_argument("--windows", default="hann,hamming,tukey,blackman",
                   help="comma-separated window names")
    p.add_argument("--clip-seconds", type=float, default=0.0,
                   help="analyze only the first N seconds (0 = all)")
    p.add_argument("--channel", type=int, default=0)

    p = sub.add_parser("stream", help="chunked STFT for long recordings "
                                      "(bounded device memory)")
    p.add_argument("file")
    p.add_argument("-o", "--out", default=None,
                   help="output .npz (PSD + axes) or .png (dB image); "
                        "optional with --bands")
    p.add_argument("--chunk-seconds", type=float, default=60.0)
    p.add_argument("--scan", action="store_true",
                   help="device-resident lax.scan: the whole recording in "
                        "ONE dispatch")
    p.add_argument("--mesh", action="store_true",
                   help="with --scan on a multi-device runtime: shard the "
                        "recording's SAMPLE axis over all devices "
                        "(sequence parallelism; each device computes its "
                        "own frames after a one-hop ppermute halo "
                        "exchange). Ignored with a single device")
    p.add_argument("--bands", action="store_true",
                   help="fold EEG band powers on device instead of "
                        "materializing the PSD (long-form analytics)")
    p.add_argument("--detect", action="store_true",
                   help="hour-scale unsupervised burst detection in "
                        "bounded memory: features folded on device "
                        "(never materializing the PSD), HMM on the "
                        "parallel-prefix engine for long recordings")
    p.add_argument("--csv", default=None,
                   help="with --detect: write the burst table here")
    p.add_argument("--channel", type=int, default=0,
                   help="sweep/channel index for multi-channel files "
                        "(default 0, the reference's channel heuristic)")
    _add_spec_args(p, combine=False)

    p = sub.add_parser("export-specs",
                       help="high-throughput dataset export: recordings "
                            "(WAV clips, or ABF/NIX/NPZ one clip per "
                            "sweep) -> spectrogram PNGs through the "
                            "overlapped decode/device/encode pipeline")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--clip-seconds", type=float, default=10.0,
                   help="static clip length (shorter padded, longer cut)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--cmap", default="jet")
    p.add_argument("--mels", type=int, default=0)
    p.add_argument("--pixel-format", choices=("palette", "rgb", "rgba"),
                   default="palette")
    p.add_argument("--compress-level", type=int, default=1)
    p.add_argument("--on-error", choices=("raise", "skip"), default="raise",
                   help="'skip' isolates per-clip decode/encode failures "
                        "instead of failing the whole dataset")
    p.add_argument("--shard", action="store_true",
                   help="shard each batch over ALL local devices (one "
                        "'data' mesh axis; batch must divide evenly)")
    p.add_argument("--resume", action="store_true",
                   help="skip clips whose PNG already exists in the output "
                        "directory (writes are atomic, so after a killed "
                        "process presence proves completeness; survive "
                        "power loss too with --durable) — restartable "
                        "dataset jobs")
    p.add_argument("--durable", action="store_true",
                   help="fsync each PNG before its atomic rename "
                        "(~1.6 ms/file): resume-safe even across power "
                        "loss / kernel crash, not just a killed process")
    p.add_argument("--encode-workers", type=int, default=None,
                   help="parallel PNG encoders (default: one per host "
                        "CPU; scale explicitly when export is "
                        "encode-bound; see OPERATIONS.md)")
    p.add_argument("--encode-executor", choices=("thread", "process"),
                   default="thread",
                   help="'process' sidesteps the GIL for the encoder's "
                        "Python overhead (forkserver pool; wins when "
                        "encode binds and images are small)")
    p.add_argument("--stats-json", metavar="PATH", default=None,
                   help="also write the run's stats + per-stage breakdown "
                        "(device compute, D2H bytes/s, unpack, encode) as "
                        "one JSON object — the ops artifact for tuning "
                        "batch/workers/compression")
    _add_spec_args(p, combine=False)

    p = sub.add_parser("info", help="list sweeps in files")
    p.add_argument("files", nargs="+")

    p = sub.add_parser("serve", help="long-lived worker: read JSONL requests "
                                     "on stdin, answer on stdout (keeps "
                                     "compiled programs and sessions warm)")
    p.add_argument("--max-sessions", type=int, default=16,
                   help="LRU bound on cached per-file-set sessions")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-request wall-clock limit in seconds")
    p.add_argument("--max-request-bytes", type=int, default=1 << 20,
                   help="reject request lines larger than this")
    p.add_argument("--max-rss-mb", type=float, default=8192.0,
                   help="drop compiled-program caches and cached sessions "
                        "when process RSS crosses this (0 disables); keeps "
                        "a worker serving ever-new configs bounded")
    p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="listen on TCP instead of stdin/stdout (same JSONL "
                        "protocol; warm state persists across connections; "
                        "0 picks an ephemeral port). No auth — bind "
                        "loopback (the default) or front with a proxy")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for --tcp (default loopback)")
    p.add_argument("--idle-timeout", type=float, default=0.0,
                   help="--tcp only: drop a connection whose next "
                        "read/write stalls longer than this (seconds; "
                        "0 disables) — connections are served one at a "
                        "time, so a stalled client otherwise holds the "
                        "server")

    p = sub.add_parser("doctor", help="environment self-check: backend, "
                                      "native components, numerical sanity")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON object) for "
                        "fleet supervisors; exit code semantics unchanged")

    p = sub.add_parser("gui", help="launch the Qt GUI client (needs PyQt5)")

    p = sub.add_parser("bench", help="throughput benchmark (reuses bench.py)")
    p.add_argument("--batch", type=int, default=256)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    # Status lines echo user-supplied paths; under a C/POSIX locale an
    # ascii stdout would raise UnicodeEncodeError on the first non-ASCII
    # name. Degrade the rendering (backslash escapes), never the command.
    for _stream in (sys.stdout, sys.stderr):
        if hasattr(_stream, "reconfigure"):
            try:
                _stream.reconfigure(errors="backslashreplace")
            except (ValueError, OSError):
                pass
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(args)
    except FileNotFoundError as e:
        sys.exit(f"error: file not found: {getattr(e, 'filename', None) or e}")
    except ValueError as e:
        # domain errors (mixed sampling rates, bad --window, unsupported
        # file types, ...) exit cleanly instead of dumping a traceback
        sys.exit(f"error: {e}")
    except OSError as e:
        # filesystem errors on user-supplied paths (a directory named
        # like a recording, name too long, permission denied, ...) are
        # environment problems, not crashes
        sys.exit(f"error: {e}")


def _dispatch(args) -> int:
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    if args.cmd == "info":
        from spectral_tpu.io.registry import SweepRegistry
        r = SweepRegistry()
        for f in args.files:
            names = r.load_file(f)
            if not names:
                # a parseable file with nothing loadable (e.g. a NIX file
                # whose sweeps all lack a sampling rate, or an HDF5 file
                # with no 1-D datasets) must say so, not print nothing
                print(f"{f}: 0 sweeps")
            for n in names:
                e = r.data[n]
                nraw = len(e.raw) if e.raw is not None else 0
                nproc = len(e.processed) if e.processed is not None else 0
                # event-driven ABF sweeps carry an absolute recording time
                t0 = ("" if e.start_seconds is None
                      else f" t0={e.start_seconds:g}s")
                print(f"{n}: fs={e.fs:g} raw={nraw} processed={nproc}{t0}")
        return 0

    def _status(msg: str) -> int:
        """Print an exporter status string; the API swallows failures into
        'Error ...' strings, which must NOT exit 0 from a CLI."""
        print(msg)
        return 1 if msg.startswith("Error") else 0

    if args.cmd == "render":
        s, _ = _session_for(args.files, args)
        if args.decorated:
            from spectral_tpu.render.figure import render_session_figure
            render_session_figure(s, path=args.out, dpi=args.dpi,
                                  colormap=args.cmap,
                                  transparent=args.transparent)
            print(f"Successfully exported decorated figure to {args.out}")
            return 0
        if args.transparent:
            sys.exit("error: --transparent requires --decorated (the raw "
                     "pixel image has no background to make transparent)")
        return _status(s.export_png(args.out, colormap=args.cmap))

    if args.cmd == "detect":
        if args.batched and not args.each:
            sys.exit("error: --batched requires --each (it batches the "
                     "per-sweep fleet flow)")
        if args.each:
            return _detect_each(args)
        s, _ = _session_for(args.files, args)
        events = s.unsupervised_detect()
        for a, b in events:
            print(f"{a:.4f}\t{b:.4f}")
        if args.csv:
            return _status(s.export_csv(args.csv))
        return 0

    if args.cmd == "learn":
        # parse the cheap string flags BEFORE loading files and compiling
        # the spectrogram (a typo'd ROI used to error after the device
        # work)
        rois = []
        for spec in args.roi:
            try:
                a, b = spec.split(":")
                rois.append((float(a), float(b)))
            except ValueError:
                sys.exit(f"error: --roi expects start:end seconds, got {spec!r}")
        s, _ = _session_for(args.files, args)
        events = s.learn_and_detect(rois)
        for a, b in events:
            print(f"{a:.4f}\t{b:.4f}")
        if args.csv:
            return _status(s.export_csv(args.csv))
        return 0

    if args.cmd == "bands":
        s, _ = _session_for(args.files, args)
        bp = s.calculate_band_powers()
        print(json.dumps({k: round(v, 6) for k, v in bp.items()},
                         ensure_ascii=False, indent=2))
        return 0

    if args.cmd == "grid":
        from spectral_tpu.config import SpecConfig
        from spectral_tpu.core.stft import freq_axis, time_axis
        from spectral_tpu.io.registry import SweepRegistry
        from spectral_tpu.parallel.sweep_grid import sweep_grid
        import jax.numpy as jnp
        r = SweepRegistry()
        try:
            names = r.load_file(args.file)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {args.file}")
        if not 0 <= args.channel < len(names):
            sys.exit(f"error: --channel {args.channel} out of range "
                     f"(file has {len(names)} sweep(s))")
        sig, fs = r.get_signal(names[args.channel], processed=True)
        x = np.asarray(sig, np.float32)
        if args.clip_seconds > 0:
            x = x[:int(args.clip_seconds * fs)]
        try:
            n_ffts = [int(v) for v in args.n_ffts.split(",") if v]
            windows = [w.strip() for w in args.windows.split(",") if w]
            configs = [SpecConfig(nperseg=n, hop=max(1, n // 4), window=w,
                                  detrend="none")
                       for n in n_ffts for w in windows]
        except ValueError as e:
            sys.exit(f"error: bad grid spec: {e}")
        if not configs:
            sys.exit("error: empty grid (need at least one n_fft and one "
                     "window)")
        if any(n > len(x) for n in n_ffts):
            sys.exit(f"error: n_fft larger than the signal "
                     f"({len(x)} samples)")
        from spectral_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()   # persist the grid-group compiles
        psds = sweep_grid(jnp.asarray(x), fs, configs)
        payload = {}
        for cfg_i, psd in zip(configs, psds):
            w = cfg_i.window if isinstance(cfg_i.window, str) \
                else cfg_i.window[0]
            key = f"psd_{cfg_i.nperseg}_{w}"
            payload[key] = np.asarray(psd).T            # freq-major
            payload[f"f_{cfg_i.nperseg}"] = freq_axis(cfg_i, fs)
            payload[f"t_{cfg_i.nperseg}"] = time_axis(cfg_i, fs, len(x))
        np.savez(args.out, fs=fs, **payload)
        print(f"Wrote {len(configs)}-combo grid "
              f"({len(n_ffts)} n_fft x {len(windows)} windows) to "
              f"{args.out}")
        return 0

    if args.cmd == "stream":
        from spectral_tpu.io.registry import SweepRegistry
        from spectral_tpu.parallel.streaming import (scan_spectrogram,
                                                     stream_band_powers,
                                                     stream_spectrogram)
        from spectral_tpu.core.stft import freq_axis, time_axis
        r = SweepRegistry()
        try:
            names = r.load_file(args.file)
        except FileNotFoundError:
            sys.exit(f"error: file not found: {args.file}")
        if not 0 <= args.channel < len(names):
            sys.exit(f"error: --channel {args.channel} out of range "
                     f"(file has {len(names)} sweep(s))")
        try:
            # processed=True: processed-over-raw preference with raw
            # fallback, like every plotting command (a processed-only npz
            # used to crash here with a KeyError traceback)
            sig, fs = r.get_signal(names[args.channel], processed=True)
        except KeyError as e:
            sys.exit(f"error: {e}")
        cfg = _make_config(args)
        # persist the streaming programs' compiles (same rationale and
        # placement as _session_for: after cheap validation, before the
        # first device work)
        from spectral_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()
        hop = cfg.hop_
        # chunk must be a multiple of hop AND >= nperseg; the floor is
        # ceil(nperseg/hop)*hop — bare nperseg is NEVER a hop multiple in
        # scipy-compat mode (hop = nperseg - nperseg//8)
        chunk = max(-(-cfg.nperseg // hop) * hop,
                    int(args.chunk_seconds * fs) // hop * hop)
        def _overflow_exit(values_finite: bool, any_nonzero: bool = True):
            """Same contract as the session plot path
            (api/session._check_power_health): a FINITE recording whose
            f32 power overflows must refuse with the lossless rescale
            hint instead of emitting inf/NaN analytics or pixels, and a
            tiny-but-real recording whose power UNDERFLOWS f32 to total
            zero must refuse (rescale up) instead of writing all-zero
            analytics/pixels the reference's f64 would not produce;
            non-finite SAMPLES propagate like the reference's math."""
            if not values_finite and np.isfinite(sig).all():
                sys.exit("error: spectral power overflows float32 "
                         f"(waveform amplitude ~{np.abs(sig).max():.3g}): "
                         "rescale the recording by a power of two (e.g. "
                         "x * 2**-40) — relative band powers and the "
                         "normalized display are invariant to the change")
            if not any_nonzero and np.isfinite(sig).all():
                adet = float(np.abs(
                    sig - sig.mean(dtype=np.float64)).max())
                if 0.0 < adet < 1e-10:
                    sys.exit("error: spectral power underflows float32 "
                             f"(waveform amplitude ~{adet:.3g}): rescale "
                             "the recording by a power of two (e.g. "
                             "x * 2**80) — relative band powers and the "
                             "normalized display are invariant to the "
                             "change")

        if args.bands:
            bp, total = stream_band_powers(np.asarray(sig, np.float32), fs,
                                           cfg, chunk)
            _overflow_exit(np.isfinite(total)
                           and all(np.isfinite(v) for v in bp.values()),
                           any_nonzero=total != 0.0)
            print(json.dumps({k: round(v, 6) for k, v in bp.items()},
                             ensure_ascii=False, indent=2))
            print(f"Total absolute power: {total:.6g}")
            if args.out is None:
                return 0
        if args.detect:
            from spectral_tpu.parallel.streaming import stream_detect
            try:
                events = stream_detect(np.asarray(sig, np.float32), fs,
                                       cfg, chunk)
            except ValueError as e:
                sys.exit(f"error: {e}")
            for a, b in events:
                print(f"{a:.4f}\t{b:.4f}")
            if args.csv:
                # same exporter/columns as `detect --csv`; the stream flow
                # has no session, so hand it the minimal surface the
                # exporter reads (events + single-source attribution)
                from types import SimpleNamespace
                from spectral_tpu.api.export import export_events_csv
                shim = SimpleNamespace(
                    last_detected_events=events, segment_map=[],
                    currently_plotted_items=[os.path.basename(args.file)])
                status = export_events_csv(args.csv, shim)
                print(status)
                if status.startswith("Error"):
                    return 1
            if args.out is None:
                return 0
        if args.out is None:
            sys.exit("error: -o/--out is required unless --bands or "
                     "--detect is given")
        if args.scan and getattr(args, "mesh", False):
            # sequence parallelism: sample axis sharded over every device,
            # halo via ppermute (parallel/sharding.time_sharded_spectrogram;
            # scan_spectrogram pads/slices back to the monolithic grid and
            # falls back to the single-device scan when it cannot apply —
            # e.g. centered framing or a 1-device runtime)
            from spectral_tpu.parallel.mesh import make_mesh
            psd = scan_spectrogram(np.asarray(sig, np.float32), fs, cfg,
                                   chunk, mesh=make_mesh())
        else:
            streamer = scan_spectrogram if args.scan else stream_spectrogram
            psd = streamer(np.asarray(sig, np.float32), fs, cfg, chunk)
        # --fmin/--fmax are honored like in render, but the mask (and for
        # PNG output the normalize/colormap too) runs ON DEVICE so only
        # the rows being written cross the link — a 1 h @ 48 kHz full-band
        # PSD is ~1.4 GB, the 0-30 Hz EEG band ~1/8 of that, and the old
        # flow additionally re-uploaded the host-masked PSD to normalize
        import jax.numpy as jnp
        f_ax = freq_axis(cfg, fs)
        sxx_d = jnp.swapaxes(psd, -1, -2)              # freq-major, device
        if cfg.fmin is not None or cfg.fmax is not None:
            from spectral_tpu.core.stft import mask_band_rows
            f_ax, sxx_d = mask_band_rows(f_ax, sxx_d, cfg.fmin, cfg.fmax)
            if f_ax.size == 0:
                sys.exit("error: the requested --fmin/--fmax band contains "
                         "no frequency rows at this sampling rate")
        # one device-side reduction; the npz/PNG writers below would
        # otherwise persist inf PSDs / laundered dB pixels silently
        _overflow_exit(bool(jnp.all(jnp.isfinite(sxx_d))),
                       any_nonzero=bool(jnp.any(sxx_d != 0)))
        if args.out.endswith(".npz"):
            psd_np = np.ascontiguousarray(np.asarray(sxx_d).T)   # (T, Fb)
            np.savez(args.out, psd=psd_np, f=f_ax,
                     t=time_axis(cfg, fs, len(sig)), fs=fs)
            print(f"Wrote PSD {psd_np.shape} to {args.out}")
        else:
            from spectral_tpu.core.scale import normalize
            from spectral_tpu.ops.colormap import (apply_colormap_packed,
                                                   unpack_rgba)
            from spectral_tpu.render.png import encode_png
            # --log is honored like everywhere else (it used to be
            # silently forced on for the image output)
            img = normalize(sxx_d, log_scale=cfg.log_scale)
            packed = apply_colormap_packed(img, flip_rows=True)
            encode_png(unpack_rgba(np.asarray(packed)), path=args.out,
                       compress_level=4)
            scale = "dB" if cfg.log_scale else "linear"
            print(f"Wrote {scale} spectrogram image {img.shape} to {args.out}")
        return 0

    if args.cmd == "export-specs":
        from spectral_tpu.io.wav import wav_info
        from spectral_tpu.parallel.pipeline import (export_spectrograms,
                                                    registry_clip_source,
                                                    registry_first_fs,
                                                    wav_clip_source)
        cfg = _make_config(args)      # --mels handled for every mode there
        all_wav = all(f.lower().endswith(".wav") for f in args.files)
        if all_wav:
            # fs from the first file's HEADER (the pipeline is single-rate
            # by design; decoding the whole first clip for one field
            # doubled its IO — wav_clip_source decodes it again anyway)
            fs = wav_info(args.files[0])[2]
        else:
            # ABF/NIX/NPZ datasets (the reference's own formats) go
            # through the registry loaders, one sweep per clip
            try:
                fs = registry_first_fs(args.files[0])
            except (OSError, ValueError, KeyError) as e:
                sys.exit(f"error: {e}")
        mesh = None
        if args.shard:
            from spectral_tpu.parallel.mesh import make_mesh
            mesh = make_mesh()
        n_already = 0
        if args.resume and all_wav:
            n_already = sum(
                1 for f in args.files if os.path.exists(os.path.join(
                    args.out_dir,
                    os.path.splitext(os.path.basename(f))[0] + ".png")))
        source = (wav_clip_source(args.files, on_error=args.on_error,
                                  skip_existing_in=(args.out_dir
                                                    if args.resume
                                                    else None))
                  if all_wav else
                  registry_clip_source(args.files, fs,
                                       on_error=args.on_error))
        from spectral_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()   # persist the pipeline compiles
        stats = export_spectrograms(
            source,
            fs, cfg,
            args.out_dir, clip_samples=int(args.clip_seconds * fs),
            batch=args.batch, colormap=args.cmap,
            compress_level=args.compress_level,
            pixel_format=args.pixel_format, on_error=args.on_error,
            mesh=mesh, resume=args.resume, durable=args.durable,
            encode_workers=args.encode_workers,
            encode_executor=args.encode_executor)
        if args.stats_json:
            payload = {"clips": stats.clips, "batches": stats.batches,
                       "pngs_written": stats.pngs_written,
                       "failed": stats.failed,
                       "nonfinite": stats.nonfinite,
                       "skipped": stats.skipped,
                       "seconds_audio": round(stats.seconds_audio, 3),
                       "breakdown": stats.breakdown()}
            with open(args.stats_json, "w") as fh:
                json.dump(payload, fh, indent=1)
        suffix = f"; {stats.failed} failed" if stats.failed else ""
        if args.resume:
            # wav datasets know the skip count up front (decode-free file
            # stem check); registry datasets learn it from the pipeline's
            # staging-time recheck
            suffix += (f" (resume: {n_already if all_wav else stats.skipped}"
                       f" already existed)")
        print(f"Exported {stats.pngs_written} spectrogram PNG(s) "
              f"({stats.seconds_audio:.0f} s of audio) to "
              f"{args.out_dir}{suffix}")
        return 0

    if args.cmd == "export-batch":
        from spectral_tpu.api.export import export_batch_signals_png
        from spectral_tpu.io.registry import SweepRegistry
        r = SweepRegistry()
        names = []
        for f in args.files:
            names += r.load_file(f)
        print(export_batch_signals_png(args.out_dir, r, names,
                                       use_proc=args.proc, use_raw=not args.proc,
                                       window_seconds=args.window_seconds))
        return 0

    if args.cmd == "serve":
        # Pin the wire protocol to utf-8 regardless of locale: under a
        # C/POSIX locale sys.stdin decodes ascii, so a client sending a
        # non-ASCII path would raise UnicodeDecodeError inside the read
        # loop itself — killing the worker the protocol promises errors
        # never kill. errors="replace" turns malformed bytes into a JSON
        # parse failure -> per-request error response instead.
        guards = dict(max_sessions=args.max_sessions,
                      request_timeout=args.timeout,
                      max_request_bytes=args.max_request_bytes,
                      max_rss_mb=args.max_rss_mb)
        if args.tcp is not None:
            return _serve_tcp(args.host, args.tcp,
                              idle_timeout=args.idle_timeout or None,
                              **guards)
        for stream in (sys.stdin, sys.stdout):
            if hasattr(stream, "reconfigure"):
                try:
                    stream.reconfigure(encoding="utf-8", errors="replace")
                except (ValueError, OSError):
                    pass   # detached/unsupported stream: keep as-is
        return _serve(sys.stdin, sys.stdout, **guards)

    if args.cmd == "doctor":
        as_json = getattr(args, "json", False)
        report = {"ok": False}

        def say(line: str) -> None:
            if not as_json:
                print(line)

        def finish(code: int) -> int:
            if as_json:
                print(json.dumps(report))
            return code

        import jax
        import jax.numpy as jnp
        from spectral_tpu.config import SpecConfig
        from spectral_tpu.core.stft import power_spectrogram, freq_axis
        from spectral_tpu.native import png_native
        from spectral_tpu.utils.cache import enable_compilation_cache

        ok = True
        say(f"backend:        {jax.default_backend()} "
            f"({len(jax.devices())} device(s): "
            f"{', '.join(str(d) for d in jax.devices()[:4])})")
        report.update(backend=jax.default_backend(),
                      n_devices=len(jax.devices()))
        enable_compilation_cache()
        say("compile cache:  enabled")
        native_ok = png_native.available()
        report["native_encoder"] = bool(native_ok)
        say(f"native encoder: {'ok (C++ zlib)' if native_ok else 'absent (PIL/stdlib fallback)'}")
        try:
            import PyQt5  # noqa: F401
            report["gui_client"] = True
            say("gui client:     PyQt5 available")
        except ImportError:
            report["gui_client"] = False
            say("gui client:     PyQt5 absent (headless CLI only)")

        # numerical sanity: a pure tone must peak at its own bin
        fs_t, f0 = 16000.0, 1000.0
        t = np.arange(16000) / fs_t
        x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        cfg = SpecConfig.north_star(1024, 256)
        psd = np.asarray(power_spectrogram(jnp.asarray(x), fs_t, cfg))
        f = freq_axis(cfg, fs_t)
        peak = float(f[int(psd.mean(axis=0).argmax())])
        sane = abs(peak - f0) <= fs_t / 1024
        ok &= sane
        report["sanity_tone_peak_hz"] = round(peak, 1)
        report["sanity"] = bool(sane)
        say(f"sanity:         1 kHz tone peaks at {peak:.1f} Hz "
            f"({'ok' if sane else 'FAIL'})")

        report["ok"] = bool(ok)
        say("doctor: " + ("all good" if ok else "PROBLEMS FOUND"))
        return finish(0 if ok else 1)

    if args.cmd == "gui":
        from spectral_tpu.gui.app import main as gui_main
        return gui_main()

    if args.cmd == "bench":
        # one timing protocol lives in bench.py (amortized dispatches,
        # checksum-forced completion); reuse it
        import importlib.util
        import pathlib
        root = pathlib.Path(__file__).resolve().parent.parent
        spec = importlib.util.spec_from_file_location("spectral_tpu_bench",
                                                      root / "bench.py")
        if spec is None or not (root / "bench.py").exists():
            sys.exit("bench.py not found next to the package (repo checkout "
                     "required for the bench subcommand)")
        # the explicit flag beats any ambient BENCH_BATCH env var
        os.environ["BENCH_BATCH"] = str(args.batch)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main()

    return 1


if __name__ == "__main__":
    sys.exit(main())
