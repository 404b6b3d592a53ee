"""The native host cell search (host_ops.cpp, a bucket-grid exact 1-NN),
compiled with g++ and loaded with ctypes: the port's copy of mops_tpu.native.

The library is built at first use into ``mops_tpu_torch/_build/``, cached by
the hash of the source, the flags and the host (``-march=native`` code runs
only where it was compiled), never next to the source: with ``-fopenmp``,
else without it.  ``load`` returns None when there is no compiler or
neither build succeeds; ``cellsearch.CellSearch`` then takes scipy's
cKDTree, which gives the same exact answers.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.timer import TimerManager

SOURCE = Path(__file__).resolve().parent / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
# with OpenMP (a parallel query), then without it (mops_tpu/native's order)
FLAG_SETS = (_FLAGS + ["-fopenmp"], _FLAGS)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path(flags) -> Path:
    key = hashlib.sha1(SOURCE.read_bytes() + " ".join(flags).encode()
                       + platform.node().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmops_host_{key}.so"


def build() -> Optional[Path]:
    """The library's path, compiled if no cached build exists; None without
    a compiler or when no flag set compiles.  The recorder counts a build
    as ``kernels.compiled``, a cached library as ``kernels.cached``."""
    for flags in FLAG_SETS:
        if _library_path(flags).exists():
            TimerManager.instance().add("kernels.cached")
            return _library_path(flags)
    cxx = shutil.which(CXX)
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flags in FLAG_SETS:
        path = _library_path(flags)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *flags, str(SOURCE), "-o", str(tmp)],
                              capture_output=True)
        if proc.returncode == 0:
            os.replace(tmp, path)
            TimerManager.instance().add("kernels.compiled")
            return path
        tmp.unlink(missing_ok=True)
    return None


def load() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first use), or None without one."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            if path is None:
                return None
            lib = ctypes.CDLL(str(path))
            lib.mops_grid_build.restype = ctypes.c_void_p
            lib.mops_grid_build.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int]
            lib.mops_grid_free.restype = None
            lib.mops_grid_free.argtypes = [ctypes.c_void_p]
            lib.mops_grid_query.restype = None
            lib.mops_grid_query.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
            lib.mops_grid_candidates.restype = ctypes.c_int32
            lib.mops_grid_candidates.argtypes = [
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeCellSearch:
    """Exact 1-NN over cell centers via the native bucket grid
    (mops_tpu.native.NativeCellSearch's interface)."""

    def __init__(self, cell_xyz: np.ndarray, n_lat: int = 0, n_lon: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError("the native host search did not build "
                               f"({CXX} missing or failing)")
        self._lib = lib
        xyz = np.ascontiguousarray(cell_xyz, dtype=np.float64).reshape(-1, 3)
        n = xyz.shape[0]
        if n_lat <= 0:
            # aim for O(10) cells per bucket
            n_lat = max(4, int(np.sqrt(n / 20)))
            n_lon = 2 * n_lat
        self.n_lat, self.n_lon = int(n_lat), int(n_lon)
        self._handle = lib.mops_grid_build(_ptr(xyz, ctypes.c_double), n,
                                           self.n_lat, self.n_lon)

    def query(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) XYZ -> (N,) nearest cell ids (int32)."""
        pts = np.ascontiguousarray(points, dtype=np.float64).reshape(-1, 3)
        out = np.empty(pts.shape[0], dtype=np.int32)
        self._lib.mops_grid_query(self._handle, _ptr(pts, ctypes.c_double),
                                  pts.shape[0], _ptr(out, ctypes.c_int32))
        return out

    def candidate_table(self, depth: int = 0) -> np.ndarray:
        """(n_lat * n_lon, depth) candidate cells of each bucket (itself and
        its 8 neighbours, -1 padded) for a search on the device; depth is
        raised to the fullest bucket's count."""
        need = self._lib.mops_grid_candidates(self._handle, 0, None)
        depth = max(int(depth), int(need))
        table = np.empty((self.n_lat * self.n_lon, depth), dtype=np.int32)
        self._lib.mops_grid_candidates(self._handle, depth,
                                       _ptr(table, ctypes.c_int32))
        return table

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.mops_grid_free(handle)
            self._handle = None
