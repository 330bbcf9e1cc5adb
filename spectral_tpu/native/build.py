"""Build the native components with the system C++ toolchain.

Every process that uses a native component compiles it from the source in
this directory into a private temporary directory on first use (under a
second for the PNG encoder): no prebuilt library in the tree is ever
loaded, so a library left over from an older source or another machine
cannot be picked up. ``python -m spectral_tpu.native.build`` checks that the
toolchain builds every target.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))

TARGETS = {
    "libspectpu_png.so": (["png_encoder.cpp"], ["-lz"]),
}


def build(name: str, out_dir: str, verbose: bool = False) -> Optional[str]:
    """Compile one target from its sources into ``out_dir``. Returns the
    library's path, or None when the toolchain is missing or refuses the
    source."""
    srcs, libs = TARGETS[name]
    out = os.path.join(out_dir, name)
    cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", out]
           + [os.path.join(_DIR, s) for s in srcs] + libs)
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        if verbose:
            sys.stderr.write(res.stderr)
        return None
    return out


def build_all(verbose: bool = False) -> bool:
    with tempfile.TemporaryDirectory(prefix="spectral_native_") as d:
        return all(build(name, d, verbose) is not None for name in TARGETS)


if __name__ == "__main__":
    ok = build_all(verbose=True)
    print("native build:", "ok" if ok else "FAILED")
    sys.exit(0 if ok else 1)
