"""Fused streamline and pathline steps: the CUDA kernels
(csrc/stage_kernel.cu), their build and ctypes binding, and their plain
PyTorch versions.

Ports of the TPU kernels mops_tpu/pallas/stage_kernel.py::_kernel as reached
through ``fused_streamline_step`` (K1) and ``fused_pathline_step`` (K2), and
mops_tpu/pallas/window_kernel.py::_wkernel as reached through
``fused_window_streamline_step`` (K3) and ``fused_window_pathline_step``
(K4): the same steps with each stage reading only a W-layer window of the
columns.  Each wrapper launches its kernel for CUDA tensors and runs the
plain version for CPU tensors; a CUDA tensor never falls back to the plain
version.

All four kernels are compiled with nvcc for sm_90a into
``mops_tpu_torch/_build/`` at first use (one shared library with a plain C
entry point per kernel and dtype, loaded with ctypes; see nvcc_build).
Importing this module builds nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional

import torch

from .nvcc_build import build_library
from ..utils.timer import TimerManager
from ..step import (cell_rise, first_rise, pathline_step, start_layer,
                    streamline_step, window_cols, window_pathline_step,
                    window_streamline_step)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "stage_kernel.cu"
# The source's entries are compiled as this many translation units at once
# (STAGE_PART in the source), then linked into one library.
BUILD_PARTS = 8
# Compile-time ceilings of the kernels (K_MAX, L_MAX, A_MAX, W_MAX in the
# source).
K_MAX = 20
L_MAX = 128
A_MAX = 2
W_MAX = 32
# The full-column kernels (K1, K2, and the window kernels' repairs) have two
# instances a dtype and form: one for columns of at most COLUMN_LT layers
# (fewer registers a lane) and the generic one up to L_MAX.
COLUMN_LT = 64

_lib = None
BUILD_LOG = ""


def pack_vertex_table(vertex_xyz, vertex_ztop, vertex_velocity,
                      vertex_vert_velocity, vertex_attrs=None) -> torch.Tensor:
    """Fuse the per-vertex tables into one contiguous (nV, F) row table with
    layout [xyz(3) | ztop(L) | vel(L*3, layer-major) | wvel(L+1)
    | attrs(L*A, layer-major: A*l + ai)], F = 3 + 4L + (L+1) + L*A: one row
    per vertex serves the whole fused step.  ``vertex_attrs`` is the
    optional (nV, L, A) stack of advect.stacked_vertex_attrs."""
    n_vert, L = vertex_ztop.shape
    parts = [vertex_xyz, vertex_ztop, vertex_velocity.reshape(n_vert, 3 * L),
             vertex_vert_velocity]
    if vertex_attrs is not None:
        parts.append(vertex_attrs.reshape(n_vert, -1))
    return torch.cat(parts, dim=1).contiguous()


def table_width(n_layers: int, n_attrs: int = 0) -> int:
    """F of pack_vertex_table for L layers and A attributes."""
    return 3 + 4 * n_layers + n_layers + 1 + n_layers * n_attrs


def column_instance(n_layers: int) -> str:
    """The instance of K1/K2 that a column of ``n_layers`` layers launches:
    "64" for L <= COLUMN_LT, else "generic" (launch_column in the source
    picks by the same rule)."""
    return "64" if n_layers <= COLUMN_LT else "generic"


def build() -> Path:
    """Compile the kernel library (cached by source and flags) and return its
    path: one nvcc process per part of the source, all started together,
    then one link.  BUILD_LOG holds the build's log with ptxas's
    register/spill report."""
    global BUILD_LOG
    path, BUILD_LOG = build_library(SOURCE, "stage_kernel", BUILD_PARTS)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        for tag, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, f"streamline_step_{tag}")
            fn.argtypes = [P, P, P, P, P, I, I, I, I, real, I, P, P, P, P, P,
                           P, P, P]
            fn.restype = I
            fn = getattr(lib, f"pathline_step_{tag}")
            fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, real, real, real,
                           real, I, P, P, P, P, P, P, P, P, P]
            fn.restype = I
            fn = getattr(lib, f"window_streamline_step_{tag}")
            fn.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, real, I, P, P,
                           P, P, P, P, P, P, P, P]
            fn.restype = I
            fn = getattr(lib, f"window_pathline_step_{tag}")
            fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, real,
                           real, real, real, I, P, P, P, P, P, P, P, P, P, P,
                           P]
            fn.restype = I
        for name in ("stage_kernel_k_max", "stage_kernel_l_max",
                     "stage_kernel_a_max", "stage_kernel_w_max"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = I
        for name in ("streamline_step_layout", "pathline_step_layout"):
            getattr(lib, name).argtypes = [I, I, I, ctypes.POINTER(I),
                                           ctypes.POINTER(I)]
            getattr(lib, name).restype = None
        if (lib.stage_kernel_k_max(), lib.stage_kernel_l_max(),
                lib.stage_kernel_a_max(), lib.stage_kernel_w_max()) \
                != (K_MAX, L_MAX, A_MAX, W_MAX):
            raise RuntimeError("kernel ceilings disagree with the wrapper")
        _lib = lib
    return _lib


def _check(name, pos, depth_neg, nv, vids, tables, F):
    """Device, dtype, shape and contiguity checks shared by both wrappers;
    returns (N, K)."""
    n, K = vids.shape
    real = pos.dtype
    if real not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: unsupported dtype {real}")
    if tuple(pos.shape) != (n, 3) or tuple(depth_neg.shape) != (n,) \
            or tuple(nv.shape) != (n,) \
            or any(t.ndim != 2 or t.shape[1] != F for t in tables):
        raise ValueError(
            f"{name}: shapes pos (N,3), depth_neg (N,), nv (N,), vids (N,K), "
            f"tables (nV,{F}) expected; got {tuple(pos.shape)}, "
            f"{tuple(depth_neg.shape)}, {tuple(nv.shape)}, {tuple(vids.shape)}, "
            f"{[tuple(t.shape) for t in tables]}")
    if depth_neg.dtype != real or any(t.dtype != real for t in tables):
        raise TypeError(f"{name}: pos, depth_neg and the tables must share "
                        "one float dtype")
    if nv.dtype != torch.int32 or vids.dtype != torch.int32:
        raise TypeError(f"{name}: nv and vids must be int32")
    tensors = (pos, depth_neg, nv, vids, *tables)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return n, K


def _kernel_device(name, pos, K, n_layers):
    """Raise unless ``pos`` is a CUDA tensor within the kernels' ceilings."""
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {pos.device}")
    if K > K_MAX or n_layers > L_MAX or n_layers < 2:
        raise ValueError(f"{name}: K={K}, L={n_layers} outside the kernel's "
                         f"ceilings K <= {K_MAX}, 2 <= L <= {L_MAX}")


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, cudaGetLastError() = {err}")


# The recorder's counter of each step kernel's launches is this prefix and
# the kernel's key in COUNT_KEYS; a launch of the double instance counts
# under F64_LAUNCHES and the same key as well.
LAUNCHES = "kernels.launches."
F64_LAUNCHES = "kernels.f64_launches."


# The tally of held_counts on this thread, or None: launches count at once.
_held = threading.local()


def _launched(key: str, real: torch.dtype) -> None:
    names = [LAUNCHES + key]
    if real == torch.float64:
        names.append(F64_LAUNCHES + key)
    tally = getattr(_held, "tally", None)
    mgr = TimerManager.instance()
    for name in names:
        if tally is None:
            mgr.add(name)
        else:
            tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def held_counts():
    """Launches made inside on this thread are not counted but tallied in
    the dict yielded (counter name: launches): a CUDA graph's capture
    launches nothing, and its replays count with count_launches."""
    tally = {}
    _held.tally = tally
    try:
        yield tally
    finally:
        _held.tally = None


def count_launches(tally: dict, times: int) -> None:
    """Count each of held_counts' ``tally`` ``times`` over."""
    mgr = TimerManager.instance()
    for name, n in tally.items():
        mgr.add(name, n * times)


def _count(attr: str):
    """A wrapper's ``launches`` or ``repair_launches``: its key's counter
    in the recorder; set only to 0, which resets it."""
    def get(self):
        key = self._keys[attr]
        if key is None:
            raise AttributeError(attr)
        return TimerManager.instance().counter(LAUNCHES + key)

    def put(self, value):
        if value != 0:
            raise ValueError(f"{attr} can only be reset to 0")
        TimerManager.instance().reset_counter(LAUNCHES + self._keys[attr])
    return property(get, put)


class _Counted:
    """A step wrapper whose ``launches`` (and ``repair_launches``, for a
    window kernel and its masked repair) read the recorder's counters."""

    launches = _count("launches")
    repair_launches = _count("repair_launches")

    def __init__(self, fn, key: str, repair: Optional[str] = None):
        functools.update_wrapper(self, fn)
        self._keys = {"launches": key, "repair_launches": repair}

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)


def _counted(key: str, repair: Optional[str] = None):
    return lambda fn: _Counted(fn, key, repair)


@_counted("k1")
def fused_streamline_step(pos, depth_neg, nv, vids, table, n_layers: int,
                          dt: float, euler: bool = False):
    """One fused streamline step (RK4, or Euler) for every particle.

    Args:
      pos (N, 3), depth_neg (N,) negative-down depth, nv (N,) int32 vertex
      counts and vids (N, K) int32 vertex ids (clipped to >= 0) of each
      particle's frozen cell, table (nV, F) from pack_vertex_table,
      n_layers L, dt signed seconds.
    Returns (new_pos (N, 3), hvel (N, 3), wvel (N,), ok (N,) bool).

    CUDA tensors launch the kernel (and count the launch, read by
    ``fused_streamline_step.launches``); CPU tensors run
    ``fused_streamline_step_plain``.
    """
    name = "fused_streamline_step"
    F = table_width(n_layers)
    n, K = _check(name, pos, depth_neg, nv, vids, (table,), F)
    if pos.device.type == "cpu":
        return fused_streamline_step_plain(pos, depth_neg, nv, vids, table,
                                           n_layers, dt, euler)
    _kernel_device(name, pos, K, n_layers)
    new_pos = torch.empty_like(pos)
    hvel = torch.empty_like(pos)
    wvel = torch.empty_like(depth_neg)
    ok = torch.empty(n, dtype=torch.bool, device=pos.device)
    lib = _library()
    fn = lib.streamline_step_f32 if pos.dtype == torch.float32 \
        else lib.streamline_step_f64
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos.data_ptr(), depth_neg.data_ptr(), nv.data_ptr(),
                 vids.data_ptr(), table.data_ptr(), n, K, F, n_layers, float(dt),
                 int(bool(euler)), new_pos.data_ptr(), hvel.data_ptr(),
                 wvel.data_ptr(), ok.data_ptr(), None, None, None, stream)
    _raise_on(name, err)
    _launched("k1", pos.dtype)
    return new_pos, hvel, wvel, ok



def fused_streamline_step_plain(pos, depth_neg, nv, vids, table,
                                n_layers: int, dt: float, euler: bool = False,
                                exact_clamp: bool = True):
    """The same step as torch ops (the kernel's signature, plus the clamp
    form): gather the (N, K, F) rows, split them into the column tables and
    run step.streamline_step.  The kernel is the ``exact_clamp`` form.
    Invalid vertex ids are not the kernel's business (the caller masks
    them)."""
    vpos, (ztop, vel, wvel, _) = _split_rows(table, vids, n_layers, 0)
    return streamline_step(ztop, vel, wvel, pos, depth_neg, nv, vpos, dt,
                           euler, exact_clamp)


@_counted("k2")
def fused_pathline_step(pos, depth_neg, nv, vids, table_f, table_b,
                        n_layers: int, dt: float, alphas, euler: bool = False,
                        n_attrs: int = 0):
    """One fused pathline step (RK4, or Euler) for every particle, against
    the front and back snapshots blended by the stage alphas.

    Args as fused_streamline_step, with one packed table per snapshot
    (pack_vertex_table with the first ``n_attrs`` <= 2 attributes stacked in
    both) and ``alphas`` = (a1, a2, a4), the time weights of stage 1,
    stages 2-3 and stage 4 (floats holding run-dtype values).
    Returns (new_pos (N, 3), hvel (N, 3), wvel (N,), ok (N,) bool,
    attr (N, 3) with slots >= n_attrs zero, or None when n_attrs == 0).

    CUDA tensors launch the kernel (and count the launch, read by
    ``fused_pathline_step.launches``); CPU tensors run
    ``fused_pathline_step_plain``.
    """
    name = "fused_pathline_step"
    if not 0 <= n_attrs <= A_MAX:
        raise ValueError(f"{name}: n_attrs={n_attrs} outside 0..{A_MAX}")
    F = table_width(n_layers, n_attrs)
    n, K = _check(name, pos, depth_neg, nv, vids, (table_f, table_b), F)
    if pos.device.type == "cpu":
        return fused_pathline_step_plain(pos, depth_neg, nv, vids, table_f,
                                         table_b, n_layers, dt, alphas, euler,
                                         n_attrs)
    _kernel_device(name, pos, K, n_layers)
    new_pos = torch.empty_like(pos)
    hvel = torch.empty_like(pos)
    wvel = torch.empty_like(depth_neg)
    ok = torch.empty(n, dtype=torch.bool, device=pos.device)
    attr = torch.empty_like(pos) if n_attrs else None
    lib = _library()
    fn = lib.pathline_step_f32 if pos.dtype == torch.float32 \
        else lib.pathline_step_f64
    a1, a2, a4 = (float(a) for a in alphas)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos.data_ptr(), depth_neg.data_ptr(), nv.data_ptr(),
                 vids.data_ptr(), table_f.data_ptr(), table_b.data_ptr(), n, K,
                 F, n_layers, n_attrs, float(dt), a1, a2, a4,
                 int(bool(euler)), new_pos.data_ptr(), hvel.data_ptr(),
                 wvel.data_ptr(), ok.data_ptr(),
                 None if attr is None else attr.data_ptr(), None, None, None,
                 stream)
    _raise_on(name, err)
    _launched("k2", pos.dtype)
    return new_pos, hvel, wvel, ok, attr



def layout(entry: str, n_vertices: int, n_layers: int,
           dtype) -> tuple[int, int]:
    """Shared memory a particle (bytes) and particles a block of K1
    (``entry`` = "streamline") or K2 ("pathline"), as its launch sizes them
    for cells of ``n_vertices`` (K) vertices, ``n_layers`` layers and
    ``dtype``.  Builds the library at first use."""
    slot, particles = ctypes.c_int(), ctypes.c_int()
    getattr(_library(), f"{entry}_step_layout")(
        n_vertices, n_layers, torch.empty((), dtype=dtype).element_size(),
        ctypes.byref(slot), ctypes.byref(particles))
    return slot.value, particles.value


def _split_rows(table, vids, n_layers, n_attrs):
    """Gather the (N, K, F) rows of a packed table and split them into
    (vpos, (ztop, vel, wvel, attrs or None))."""
    L = n_layers
    n, K = vids.shape
    cols = table[vids.long()]                           # (N, K, F)
    o_w = 3 + 4 * L
    o_a = o_w + L + 1
    attrs = cols[..., o_a:].reshape(n, K, L, n_attrs) if n_attrs else None
    return cols[..., :3], (cols[..., 3:3 + L],
                           cols[..., 3 + L:o_w].reshape(n, K, L, 3),
                           cols[..., o_w:o_a], attrs)


def fused_pathline_step_plain(pos, depth_neg, nv, vids, table_f, table_b,
                              n_layers: int, dt: float, alphas,
                              euler: bool = False, n_attrs: int = 0,
                              exact_clamp: bool = True):
    """The same step as torch ops (the kernel's signature, plus the clamp
    form): gather the (N, K, F) rows of both tables and run
    step.pathline_step.  Vertex positions come from the front table.  The
    alphas are cast to the run dtype."""
    vpos, cols_f = _split_rows(table_f, vids, n_layers, n_attrs)
    _, cols_b = _split_rows(table_b, vids, n_layers, n_attrs)
    a = tuple(torch.as_tensor(x, dtype=pos.dtype, device=pos.device)
              for x in alphas)
    new_pos, hvel, wvel, ok, attr = pathline_step(
        cols_f, cols_b, pos, depth_neg, nv, vpos, dt, a, euler, n_attrs,
        exact_clamp)
    return new_pos, hvel, wvel, ok, attr if n_attrs else None


# ---------------------------------------------------------------------------
# the layer-window steps (K3, K4)
# ---------------------------------------------------------------------------

def table_rise(table: torch.Tensor, n_layers: int) -> torch.Tensor:
    """step.first_rise of a packed table's ztop columns: (nV,) int32, the
    window kernels' clamp-miss input, computed once per table."""
    return first_rise(table[:, 3:3 + n_layers]).contiguous()


def _check_window(name, s, n, n_layers, n_window, device, tables, rises):
    """Checks of the window starts and width, and of each table's first
    rises (table_rise), shared by K3 and K4."""
    if tuple(s.shape) != (n,) or s.dtype != torch.int32 \
            or not s.is_contiguous() or s.device != device:
        raise ValueError(f"{name}: s must be a contiguous (N,) int32 tensor "
                         f"on {device}")
    for t, r in zip(tables, rises):
        if tuple(r.shape) != (t.shape[0],) or r.dtype != torch.int32 \
                or not r.is_contiguous() or r.device != device:
            raise ValueError(f"{name}: each table's rise must be a "
                             f"contiguous (nV,) int32 tensor on {device}")
    if not 2 <= n_window <= min(n_layers, W_MAX):
        raise ValueError(f"{name}: window W={n_window} outside 2 <= W <= "
                         f"min(L={n_layers}, {W_MAX})")


def _window_outputs(pos, depth_neg, n_attrs=0):
    """(new_pos, hvel, wvel, ok, layer, miss, clamp, attr or None), and the
    (list, count) buffers of the miss lanes that the window kernel appends
    and its repair steps."""
    n = pos.shape[0]
    dev = pos.device
    flag = lambda: torch.empty(n, dtype=torch.bool, device=dev)
    ints = lambda k: torch.empty(k, dtype=torch.int32, device=dev)
    return (torch.empty_like(pos), torch.empty_like(pos),
            torch.empty_like(depth_neg), flag(), ints(n), flag(), flag(),
            torch.empty_like(pos) if n_attrs else None), (ints(n), ints(1))


@_counted("k3", "k3 repair")
def fused_window_streamline_step(pos, depth_neg, nv, vids, s, table, rise,
                                 n_layers: int, n_window: int, dt: float,
                                 euler: bool = False):
    """One streamline step (RK4, or Euler) whose stages read only the
    layers s..s+W-1 of each vertex column.

    Args as fused_streamline_step, plus s (N,) int32 window starts in
    [0, L - W] (step.window_starts), the table's first rises ``rise``
    (table_rise) and the window width W = ``n_window``.
    Returns (new_pos (N, 3), hvel (N, 3), wvel (N,), ok (N,) bool,
    layer (N,) int32, miss (N,) bool, clamp (N,) bool).  A lane is a miss
    when some stage may not resolve as on the full column (step.py, "the
    layer-window step"): its depth lay within EPS_LAYER of an inner window
    edge (an edge miss), or the window's clamp or its surface and bottom
    tests may depart from the full column's (a clamp miss; ``clamp`` flags
    the lanes that only this test flagged).  A miss lane's step is
    recomputed on the full column (K1's arithmetic), and a lane that does
    not miss computes what the full column computes, so every lane's
    outputs are the full step's.  layer is the layer at the start position
    (the next window's centre).

    CUDA tensors launch the window kernel (counted in
    ``fused_window_streamline_step.launches``), which appends the miss lanes
    to a list, then K1 over that list on the same stream, which recomputes
    them (counted in ``.repair_launches``, not in K1's launches); CPU
    tensors run ``fused_window_streamline_step_plain``.
    """
    name = "fused_window_streamline_step"
    F = table_width(n_layers)
    n, K = _check(name, pos, depth_neg, nv, vids, (table,), F)
    _check_window(name, s, n, n_layers, n_window, pos.device, (table,),
                  (rise,))
    if pos.device.type == "cpu":
        return fused_window_streamline_step_plain(
            pos, depth_neg, nv, vids, s, table, rise, n_layers, n_window, dt,
            euler)
    _kernel_device(name, pos, K, n_layers)
    out, (lst, cnt) = _window_outputs(pos, depth_neg)
    lib = _library()
    f32 = pos.dtype == torch.float32
    fn = lib.window_streamline_step_f32 if f32 \
        else lib.window_streamline_step_f64
    repair = lib.streamline_step_f32 if f32 else lib.streamline_step_f64
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos.data_ptr(), depth_neg.data_ptr(), nv.data_ptr(),
                 vids.data_ptr(), s.data_ptr(), table.data_ptr(),
                 rise.data_ptr(), n, K, F, n_layers, n_window, float(dt),
                 int(bool(euler)), *(t.data_ptr() for t in out[:7]),
                 lst.data_ptr(), cnt.data_ptr(), stream)
        _raise_on(name, err)
        _launched("k3", pos.dtype)
        # the miss lanes' full-column step (K1 over their list)
        err = repair(pos.data_ptr(), depth_neg.data_ptr(), nv.data_ptr(),
                     vids.data_ptr(), table.data_ptr(), n, K, F, n_layers,
                     float(dt), int(bool(euler)),
                     *(t.data_ptr() for t in out[:4]), lst.data_ptr(),
                     cnt.data_ptr(), out[4].data_ptr(), stream)
        _raise_on(f"{name} (repair)", err)
        _launched("k3 repair", pos.dtype)
    return out[:7]



def _window_inputs(table, vids, s, n_layers, n_window, n_attrs):
    """(vpos, full columns, window columns, (surface, bottom) ztop)."""
    vpos, cols = _split_rows(table, vids, n_layers, n_attrs)
    cols_w = tuple(window_cols(c, s, n_window) for c in cols)
    return vpos, cols, cols_w, (cols[0][..., 0], cols[0][..., -1])


def fused_window_streamline_step_plain(pos, depth_neg, nv, vids, s, table,
                                       rise, n_layers: int, n_window: int,
                                       dt: float, euler: bool = False):
    """The same step as torch ops: step.window_streamline_step, then the
    miss lanes again through fused_streamline_step_plain with their start
    layer from the full column."""
    vpos, cols, cols_w, ends = _window_inputs(table, vids, s, n_layers,
                                              n_window, 0)
    new_pos, hvel, wvel, ok, layer, miss, clamp = window_streamline_step(
        cols_w, ends, s, n_layers, pos, depth_neg, nv, vpos, dt, euler,
        cell_rise(rise, vids, nv))
    idx = torch.nonzero(miss)[:, 0]
    if idx.numel():
        full = fused_streamline_step_plain(pos[idx], depth_neg[idx], nv[idx],
                                           vids[idx], table, n_layers, dt,
                                           euler)
        for dst, src in zip((new_pos, hvel, wvel, ok), full):
            dst[idx] = src
        layer[idx] = start_layer(cols[0][idx], pos[idx], depth_neg[idx],
                                 nv[idx], vpos[idx], False)
    return (new_pos, hvel, wvel, ok,
            torch.clamp(layer, 1, n_layers - 1).to(torch.int32), miss, clamp)


@_counted("k4", "k4 repair")
def fused_window_pathline_step(pos, depth_neg, nv, vids, s, table_f, table_b,
                               rise_f, rise_b, n_layers: int, n_window: int,
                               dt: float, alphas, euler: bool = False,
                               n_attrs: int = 0):
    """One pathline step (RK4, or Euler) whose stages read only the layers
    s..s+W-1 of both snapshots' columns (one start for both).

    Args as fused_pathline_step, plus s and W as in
    fused_window_streamline_step and each table's first rises (table_rise;
    each snapshot's window is tested with its own).  Returns (new_pos,
    hvel, wvel, ok, layer, miss, clamp, attr (N, 3) or None), miss and
    clamp as fused_window_streamline_step's, the OR over both snapshots;
    miss lanes are recomputed on the full columns (K2's arithmetic), and
    layer is the front snapshot's at the start position.

    CUDA tensors launch the window kernel (counted in
    ``fused_window_pathline_step.launches``), then K2 over its list of miss
    lanes (counted in ``.repair_launches``); CPU tensors run
    ``fused_window_pathline_step_plain``.
    """
    name = "fused_window_pathline_step"
    if not 0 <= n_attrs <= A_MAX:
        raise ValueError(f"{name}: n_attrs={n_attrs} outside 0..{A_MAX}")
    F = table_width(n_layers, n_attrs)
    n, K = _check(name, pos, depth_neg, nv, vids, (table_f, table_b), F)
    _check_window(name, s, n, n_layers, n_window, pos.device,
                  (table_f, table_b), (rise_f, rise_b))
    if pos.device.type == "cpu":
        return fused_window_pathline_step_plain(
            pos, depth_neg, nv, vids, s, table_f, table_b, rise_f, rise_b,
            n_layers, n_window, dt, alphas, euler, n_attrs)
    _kernel_device(name, pos, K, n_layers)
    out, (lst, cnt) = _window_outputs(pos, depth_neg, n_attrs)
    attr = None if out[7] is None else out[7].data_ptr()
    lib = _library()
    f32 = pos.dtype == torch.float32
    fn = lib.window_pathline_step_f32 if f32 \
        else lib.window_pathline_step_f64
    repair = lib.pathline_step_f32 if f32 else lib.pathline_step_f64
    a1, a2, a4 = (float(a) for a in alphas)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos.data_ptr(), depth_neg.data_ptr(), nv.data_ptr(),
                 vids.data_ptr(), s.data_ptr(), table_f.data_ptr(),
                 table_b.data_ptr(), rise_f.data_ptr(), rise_b.data_ptr(), n,
                 K, F, n_layers, n_window, n_attrs, float(dt), a1, a2, a4,
                 int(bool(euler)), *(t.data_ptr() for t in out[:7]),
                 lst.data_ptr(), cnt.data_ptr(), attr, stream)
        _raise_on(name, err)
        _launched("k4", pos.dtype)
        # the miss lanes' full-column step (K2 over their list)
        err = repair(pos.data_ptr(), depth_neg.data_ptr(), nv.data_ptr(),
                     vids.data_ptr(), table_f.data_ptr(), table_b.data_ptr(),
                     n, K, F, n_layers, n_attrs, float(dt), a1, a2, a4,
                     int(bool(euler)), *(t.data_ptr() for t in out[:4]),
                     attr, lst.data_ptr(), cnt.data_ptr(), out[4].data_ptr(),
                     stream)
        _raise_on(f"{name} (repair)", err)
        _launched("k4 repair", pos.dtype)
    return out



def fused_window_pathline_step_plain(pos, depth_neg, nv, vids, s, table_f,
                                     table_b, rise_f, rise_b, n_layers: int,
                                     n_window: int, dt: float, alphas,
                                     euler: bool = False, n_attrs: int = 0):
    """The same step as torch ops: step.window_pathline_step, then the miss
    lanes again through fused_pathline_step_plain with their start layer
    from the front snapshot's full column."""
    vpos, cols_f, cols_fw, ends = _window_inputs(table_f, vids, s, n_layers,
                                                 n_window, n_attrs)
    _, _, cols_bw, _ = _window_inputs(table_b, vids, s, n_layers, n_window,
                                      n_attrs)
    a = tuple(torch.as_tensor(x, dtype=pos.dtype, device=pos.device)
              for x in alphas)
    new_pos, hvel, wvel, ok, attr, layer, miss, clamp = window_pathline_step(
        cols_fw, cols_bw, ends, s, n_layers, pos, depth_neg, nv, vpos, dt, a,
        euler, (cell_rise(rise_f, vids, nv), cell_rise(rise_b, vids, nv)),
        n_attrs)
    idx = torch.nonzero(miss)[:, 0]
    if idx.numel():
        full = fused_pathline_step_plain(
            pos[idx], depth_neg[idx], nv[idx], vids[idx], table_f, table_b,
            n_layers, dt, alphas, euler, n_attrs)
        for dst, src in zip((new_pos, hvel, wvel, ok), full):
            dst[idx] = src
        if n_attrs:
            attr[idx] = full[4]
        layer[idx] = start_layer(cols_f[0][idx], pos[idx], depth_neg[idx],
                                 nv[idx], vpos[idx], True)
    return (new_pos, hvel, wvel, ok,
            torch.clamp(layer, 1, n_layers - 1).to(torch.int32), miss, clamp,
            attr if n_attrs else None)


# The step kernels' launch counters, as launch_counts reads them through
# the wrappers' attributes (a stand-in put in a wrapper's place counts its
# own): K1-K4 and the window paths' masked K1/K2 repairs.
COUNT_KEYS = ("k1", "k2", "k3", "k3 repair", "k4", "k4 repair")


def _counters():
    w3, w4 = fused_window_streamline_step, fused_window_pathline_step
    return ((fused_streamline_step, "launches"),
            (fused_pathline_step, "launches"), (w3, "launches"),
            (w3, "repair_launches"), (w4, "launches"),
            (w4, "repair_launches"))


def launch_counts() -> dict:
    """The step kernels' launch counts (the recorder's counters
    kernels.launches.<key>), keyed as COUNT_KEYS.  The K1/K2 instance a count launched is
    column_instance(L) of its run."""
    return {key: getattr(fn, attr)
            for key, (fn, attr) in zip(COUNT_KEYS, _counters())}


def reset_counts():
    """Every step kernel's launch count, and its double instance's, to 0."""
    for fn, attr in _counters():
        setattr(fn, attr, 0)
    for key in COUNT_KEYS:
        TimerManager.instance().reset_counter(F64_LAUNCHES + key)
