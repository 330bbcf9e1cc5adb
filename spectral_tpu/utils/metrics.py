"""Observability: structured logging, throughput counters, profiler hooks.

The reference's only observability is print("[DEBUG] ...") statements and a
status label (SURVEY.md §5). Here: a std-logging based structured logger, a
throughput meter in the benchmark's units (frames/s, audio-hours/min), timer
contexts, and jax.profiler wrappers for device traces.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

logger = logging.getLogger("spectral_tpu")


def configure_logging(level: int = logging.INFO, json_lines: bool = False
                      ) -> None:
    """Install a handler for the framework's logger (idempotent)."""
    if logger.handlers:
        logger.setLevel(level)
        return
    h = logging.StreamHandler()
    if json_lines:
        class _Json(logging.Formatter):
            def format(self, rec):
                payload = {"t": round(rec.created, 3), "lvl": rec.levelname,
                           "msg": rec.getMessage()}
                if rec.args and isinstance(rec.args, dict):
                    payload.update(rec.args)
                return json.dumps(payload)
        h.setFormatter(_Json())
    else:
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(h)
    logger.setLevel(level)


@dataclass
class ThroughputMeter:
    """Accumulates processed audio and reports the benchmark units."""
    samples: int = 0
    frames: int = 0
    seconds_audio: float = 0.0
    _t0: float = field(default_factory=time.time)

    def add(self, n_samples: int, fs: float, n_frames: int = 0) -> None:
        self.samples += int(n_samples)
        self.frames += int(n_frames)
        self.seconds_audio += n_samples / fs

    def report(self) -> Dict[str, float]:
        wall = max(time.time() - self._t0, 1e-9)
        return {
            "wall_s": round(wall, 3),
            "audio_hours": round(self.seconds_audio / 3600.0, 4),
            "audio_hours_per_min": round(
                (self.seconds_audio / 3600.0) / (wall / 60.0), 2),
            "frames_per_s": round(self.frames / wall, 1),
        }


@contextlib.contextmanager
def timed(name: str, log: bool = True) -> Iterator[Dict[str, float]]:
    """Timer context; yields a dict that receives {'seconds': ...}."""
    out: Dict[str, float] = {}
    t0 = time.time()
    try:
        yield out
    finally:
        out["seconds"] = time.time() - t0
        if log:
            logger.info("%s took %.3fs", name, out["seconds"])


@contextlib.contextmanager
def trace_annotation(name: str):
    """jax.profiler.TraceAnnotation wrapper (no-op when unavailable)."""
    try:
        import jax.profiler
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield


def start_profiler_trace(log_dir: str) -> bool:
    try:
        import jax.profiler
        jax.profiler.start_trace(log_dir)
        return True
    except Exception:
        return False


def stop_profiler_trace() -> None:
    try:
        import jax.profiler
        jax.profiler.stop_trace()
    except Exception:
        pass
