"""ctypes bindings for the native DEM loader, with build-on-first-use.

The shared library is compiled from hgt_native.cpp on first import (cached
next to the source; rebuilt when the source is newer). If no compiler is
available the package works anyway -- mosaic loading falls back to the numpy
path. Set HORIZONATOR_NO_NATIVE=1 to force the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

_HERE = Path(__file__).parent
_SRC = _HERE / "hgt_native.cpp"
_LIB = _HERE / "libhgt_native.so"

_lib = None
_tried = False


def _build() -> bool:
    # compile to a per-process temp name and publish atomically: two
    # processes building concurrently (pytest -n, bench + viewer) must
    # never dlopen a half-written .so, and a crashed build must not
    # poison the cache
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        print(f"horizonator_jax: native build failed:\n{r.stderr}",
              file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, _LIB)
    return True


def get_lib():
    """The loaded native library, or None when unavailable/disabled."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("HORIZONATOR_NO_NATIVE"):
        return None
    try:
        if (not _LIB.exists()
                or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
            if not _build():
                return None
        lib = ctypes.CDLL(str(_LIB))
        lib.hgt_blit_window.restype = ctypes.c_int
        lib.hgt_blit_window.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_long, ctypes.c_long]
        lib.hgt_decode.restype = ctypes.c_int
        lib.hgt_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_void_p]
        _lib = lib
    except OSError as e:
        print(f"horizonator_jax: native lib load failed: {e}", file=sys.stderr)
        _lib = None
    return _lib


def blit_window(path, edge, grid, dst_i0, dst_j0) -> int:
    """Blit one tile into the mosaic window (see hgt_native.cpp). grid must
    be a C-contiguous int16 (n, n) ndarray. Returns the native status code;
    raises if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    import numpy as np
    assert grid.dtype == np.int16 and grid.flags.c_contiguous
    n = grid.shape[0]
    return lib.hgt_blit_window(
        str(path).encode(), edge,
        grid.ctypes.data_as(ctypes.c_void_p), n,
        int(dst_i0), int(dst_j0))
