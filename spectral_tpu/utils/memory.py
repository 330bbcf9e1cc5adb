"""Bounded-memory guard for long-lived processes.

JAX caches one compiled executable per (program, shape) for the life of
the process — by design, and exactly right for steady-state serving.
But a long interactive session that keeps exploring new configs, or a
learn workflow whose user-drawn ROIs arrive in ever-new lengths (each
distinct ROI length compiles a fresh 2-state EM,
models/detector._find_burst_in_roi), grows the executable cache without
bound. A 400-step randomized soak across 144 config/shape combos grew
RSS 445 -> 915 MB while the same soak pinned to one config stayed at
+0.0% (tools/soak.py) — cache growth, not an object leak.

``maybe_trim_caches`` is the backstop: when RSS crosses a threshold it
drops every compiled program (``jax.clear_caches()``) plus this
package's jitted-program wrappers. The next dispatch of each program
recompiles — slow once (the persistent compilation cache,
utils/cache.py, makes recompiles cheap) — and memory is bounded.
Wired into the serve worker per request (cli.py) and the session after
each plot (api/session.py); threshold from SPECTRAL_TPU_MAX_RSS_MB
(0/unset = disabled for the session path; serve defaults to 8192).
"""

from __future__ import annotations

import os
from typing import Optional

_ENV = "SPECTRAL_TPU_MAX_RSS_MB"


def rss_mb() -> float:
    """Resident set size of this process in MB (Linux)."""
    try:
        with open(f"/proc/{os.getpid()}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:  # pragma: no cover - non-Linux
        pass
    return 0.0


def env_threshold_mb() -> float:
    """The SPECTRAL_TPU_MAX_RSS_MB threshold; 0 = disabled."""
    try:
        return float(os.environ.get(_ENV, "0") or 0)
    except ValueError:
        return 0.0


def trim_caches() -> None:
    """Drop every compiled program: jax's global caches plus this
    package's lru-cached jit wrappers (which would otherwise keep their
    executables alive)."""
    from spectral_tpu.api.session import _plot_program
    _plot_program.cache_clear()
    import jax
    jax.clear_caches()


_post_trim_rss = 0.0


def maybe_trim_caches(max_rss_mb: Optional[float] = None) -> bool:
    """Trim when RSS exceeds the threshold. Returns True if trimmed.

    max_rss_mb None -> SPECTRAL_TPU_MAX_RSS_MB (0/unset disables).

    Hysteresis: the allocator may not return freed pages to the OS, so
    RSS can sit above the threshold right after a trim. Re-trimming then
    would recompile every program per call for zero benefit — after a
    trim, the next one fires only once RSS exceeds BOTH the threshold
    and 110% of the post-trim level (i.e. the caches demonstrably grew
    again).
    """
    global _post_trim_rss
    limit = env_threshold_mb() if max_rss_mb is None else max_rss_mb
    if not limit or limit <= 0:
        return False
    now = rss_mb()
    if now <= limit or now <= _post_trim_rss * 1.1:
        return False
    trim_caches()
    _post_trim_rss = rss_mb()
    return True
